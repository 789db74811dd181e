"""Engine program: diffusion backend, collision dispatch and segment runners.

Carried over from ``qpsim_tpu.solver.program_build``.
The JAX package compiles each segment into one program; here a segment is
a Python loop over steps that launches the kernels eagerly (PyTorch has
no retrace cost, so nothing is cached across runs).  Each step's Pauli
statistics stay on the device as one small tensor; a segment returns them
stacked, for the runner to move to the host once.

Dispatch (mirrors ``program_build.py:67-231`` and
``diffusion_backends.py:604-618`` of the JAX package):

* gap maps — a non-uniform ``precomputed`` payload folds a per-pixel
  D(E, x) into the diffusion operator and gives every pixel a gap id into
  the sorted unique gaps (``np.unique`` order, 0 on masked-out cells); a
  uniform one (or none) keeps ``gap`` in the collisions and the Pauli ρ.
* collisions — ``collision_backend='auto'`` runs the CUDA kernel wrappers,
  which launch their kernels for CUDA tensors and run the plain versions
  for CPU tensors (:func:`collision_kernel_for`): with per-gap tables for
  G ≤ 8 unique gaps (gap ids when G > 1) K3 up to 64 bins and K5 beyond,
  from the per-pixel Δ² for G > 8 (no per-gap stacks) K4 and K6, at any
  number of bins (the JAX package runs its XLA gather integrator beyond
  256 bins, per-gap stacks for G > 8 included, which it refuses past 4
  GB).  ``'kernel'`` does the same but raises on the CPU; ``'plain'`` runs
  the plain per-gap gather version everywhere, which refuses stacks above
  4 GB.  The JAX package's names are aliases: ``'pallas'`` is ``'kernel'``,
  ``'xla'`` is ``'plain'``.  K3/K4 read the pair-walk tables of ``build_kernel_tables``,
  K5/K6 the column tables of ``build_column_tables``, both built here once.
* diffusion — see :func:`~qpsim_tpu_torch.solver.diffusion_backends.choose_backend`.
* generation — constant and pulse: the dt·g plane is fused into the
  collision substep that opens each step, as the TPU kernels'
  ``gen_input`` does, unless a photon drive is on (the photon substep
  sits between the injection and the collision half, so the plane is
  added on its own first, as in the JAX program); custom traced: q +
  dt·g(t) evaluated on the device, its flags stacked with the Pauli
  statistics; custom host: the runner adds the host-evaluated dt·g and
  runs one segment of one step per step.
* photon drive (Fischer 2024) — each step, after the generation injection
  and before the leading collision half (at every seam of the merged
  composition), each tone's exponential substep in order, inside its own
  window; per-pixel coefficients from the Δ² plane and the Pauli ρ state
  under a gap map.  The substep is the JAX package's XLA glue in plain
  torch (``ops.photon_drive``); a step outside a tone's window is the
  identity on a non-negative state, computed as its ``max(q, 0)``.
* mesh — the mesh branch (``program_build.py:492-690`` of the JAX
  package, :func:`_mesh_step_ops`): one rows-sharded step of
  ``parallel.sharded`` per segment dt, which builds its own collision
  tables and local solves; the runner's state is a list of shards.
* the segment loop (:func:`_segment_runners`) is written once, over the
  step operations of one segment dt (:class:`_StepOps`) that the single
  device and the mesh each build from their own pieces.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from ..models.params import photon_drive_specs
from ..ops.collisions import (
    build_analytic_plan,
    build_collision_plan_arrays,
    collision_step_analytic_plain,
    collision_step_plain,
)
from ..ops.collisions_blocked_cuda import KERNEL_STEPS, collision_kernel_for
from ..ops.collisions_cuda import MAX_GAP_IDS
from ..ops.diffusion import build_directional_stencils, fold_diffusion
from ..ops.dos import (
    diffusion_coefficient_of_energy,
    dynes_density_of_states,
    dynes_density_of_states_per_pixel,
)
from ..ops.generation import build_generation_program, numpy_dtype
from ..ops.kernels import recombination_kernel_base, scattering_kernel_base
from ..ops.phonon_map import PhononFrequencyMap, build_phonon_frequency_map
from ..ops.photon_drive import (
    build_photon_drive_plan,
    build_photon_drive_plan_analytic,
    make_photon_substep,
    make_photon_substep_per_pixel,
)
from ..utils.profiling import span
from .diffusion_backends import choose_backend
from .pauli import make_pauli_stats_fn

__all__ = ["EngineProgram", "build_engine_program", "collision_kernel_for"]


@dataclass
class EngineProgram:
    pmap: PhononFrequencyMap
    #: (seg_dt, length) -> run(q, ph, t_start) -> (q, ph, stats, gen_flags):
    #: stats a (length, 4) float64 device tensor of Pauli statistics, or
    #: (length, 6) with the traced generation's device flags (non-finite,
    #: negative) in its last two columns; gen_flags a (length, 2) bool array
    #: of the uniform modes' host flags
    segment_runner: Callable
    pauli_stats: Callable[[torch.Tensor], torch.Tensor]
    #: the generation is evaluated on the host every step
    host_gen: bool
    #: a whole state → the runner's state (this process's shards on a mesh)
    shard: Callable
    #: the runner's state → the whole state (every shard, gathered)
    gather: Callable


def build_engine_program(
    *,
    mask,
    edges,
    edge_conditions,
    dx,
    device: torch.device,
    dtype: torch.dtype,
    gap,
    E_bins,
    dE,
    num_energy_bins,
    diffusion_coefficient,
    enable_diffusion,
    diffusion_backend,
    precomputed,
    nonuniform_gap,
    enable_recombination,
    enable_scattering,
    dynes_gamma,
    tau_s_eff,
    tau_r_eff,
    T_c,
    freeze_phonon_dynamics,
    collision_backend,
    pixel_chunk,
    external_generation,
    pauli_density_floor,
    strang_mode,
    photon_drive=None,
    mesh=None,
    mesh_y_solve="wang",
) -> EngineProgram:
    ny, nx = mask.shape
    n_spatial = int(mask.sum())
    collisions_on = bool(enable_recombination or enable_scattering)
    if collision_backend not in ("auto", "kernel", "plain", "pallas", "xla"):
        raise ValueError(
            f"Unknown collision backend: {collision_backend!r} (use 'auto', 'kernel' or 'plain'; "
            "'pallas' and 'xla' are the JAX package's names for 'kernel' and 'plain')"
        )
    requested = collision_backend in ("kernel", "pallas")
    use_kernel = collisions_on and collision_backend not in ("plain", "xla")
    if use_kernel and requested and device.type != "cuda":
        raise ValueError(f"collision_backend={collision_backend!r} needs a CUDA device")

    # --- gap map ---------------------------------------------------------------
    if nonuniform_gap:
        gap_values = np.asarray(
            precomputed.get("gap_values", np.full(n_spatial, gap)), dtype=np.float64
        )
    else:
        gap_values = np.full(n_spatial, gap, dtype=np.float64)
    unique_gaps = np.unique(gap_values)
    gap_lookup = np.searchsorted(unique_gaps, gap_values)
    gap_id = np.zeros((ny, nx), dtype=np.int32)
    gap_id[mask] = gap_lookup.astype(np.int32)
    # continuous gap maps (more gaps than the gap-id tables take): exact
    # per-pixel constants from Δ² (K4, K6), no per-gap stacks
    analytic = use_kernel and int(unique_gaps.size) > MAX_GAP_IDS
    if analytic or mesh is not None:
        # the dense Δ plane of the per-pixel kernels and of a mesh's gap map
        gap_plane = np.full((ny, nx), gap, dtype=np.float64)
        gap_plane[mask] = gap_values
    kernel = (collision_kernel_for(num_energy_bins, int(unique_gaps.size))
              if use_kernel and mesh is None else None)

    # --- diffusion backend -------------------------------------------------
    with span("qpsim.build.diffusion"):
        backend = None
        if enable_diffusion:
            if precomputed is not None:
                D_array = np.asarray(precomputed["D_array"], dtype=np.float64)  # (NE, P)
            x_st, y_st = build_directional_stencils(mask, edges, edge_conditions, dx)
            if nonuniform_gap:
                D_dense = np.zeros((num_energy_bins, ny, nx), dtype=np.float64)
                D_dense[:, mask] = D_array
                op = fold_diffusion(x_st, y_st, mask, dx, D_dense)
            elif precomputed is not None:
                op = fold_diffusion(x_st, y_st, mask, dx, D_array[:, 0])
            else:
                op = fold_diffusion(
                    x_st, y_st, mask, dx, diffusion_coefficient_of_energy(diffusion_coefficient, E_bins, gap)
                )
            # a step composed with collisions keeps multi-bin operators on K2;
            # a mesh builds its own local solves inside the sharded step
            if mesh is None:
                backend = choose_backend(op, device, dtype, diffusion_backend, coupled=collisions_on)

    # --- collision data ------------------------------------------------------
    with span("qpsim.build.collisions"):
        pmap = build_phonon_frequency_map(E_bins)
        plan = atab = rho_by_gap = mesh_collisions = None
        if not collisions_on or (mesh is not None and unique_gaps.size > MAX_GAP_IDS):
            # only the Pauli ρ plane, vectorised over pixels (a mesh's sharded
            # step builds its own collision tables)
            rho_per_pixel = dynes_density_of_states_per_pixel(E_bins, gap_values, dynes_gamma)
        elif mesh is not None:
            rho_by_gap = np.stack(
                [dynes_density_of_states(E_bins, float(g), dynes_gamma) for g in unique_gaps]
            )
        elif analytic:
            plan, atab = build_analytic_plan(
                E_bins=E_bins, dE=dE, gap_plane=gap_plane, pmap=pmap,
                tau_s=tau_s_eff if enable_scattering else None,
                tau_r=tau_r_eff if enable_recombination else None,
                T_c=T_c, dynes_gamma=dynes_gamma, update_phonons=not freeze_phonon_dynamics,
                device=device, dtype=dtype, pixel_chunk=pixel_chunk,
            )
            rho_per_pixel = dynes_density_of_states_per_pixel(E_bins, gap_values, dynes_gamma)
        else:
            # one (NE, NE) table per unique gap and channel: for continuous gap
            # maps G ≈ Npix, so refuse with guidance instead of thrashing
            n_channels = 1 + int(enable_recombination) + int(enable_scattering)
            stack_bytes = int(unique_gaps.size) * num_energy_bins * num_energy_bins * 8 * n_channels
            if stack_bytes > 4 << 30:
                raise ValueError(
                    f"{unique_gaps.size} unique gap values x {num_energy_bins} "
                    f"bins needs ~{stack_bytes / 2**30:.0f} GB of per-gap kernel "
                    "tables on the plain collision path. Continuous gap maps "
                    "should use the analytic collision kernel instead: pass "
                    "collision_backend='auto' or 'kernel'."
                )
            rho_by_gap = np.stack(
                [dynes_density_of_states(E_bins, float(g), dynes_gamma) for g in unique_gaps]
            )
            per_gap = lambda fn, tau: np.stack([fn(E_bins, float(g), tau, T_c) for g in unique_gaps])
            plan = build_collision_plan_arrays(
                dE=dE,
                rho=rho_by_gap,
                K_r0=per_gap(recombination_kernel_base, tau_r_eff) if enable_recombination else None,
                K_s0=per_gap(scattering_kernel_base, tau_s_eff) if enable_scattering else None,
                pmap=pmap,
                enable_recombination=enable_recombination,
                enable_scattering=enable_scattering,
                update_phonons=not freeze_phonon_dynamics,
                device=device,
                dtype=dtype,
                pixel_chunk=pixel_chunk,
                gap_id=gap_id,
            )
        if mesh is not None and collisions_on:
            # what the sharded step builds its tables from: the kernels of the
            # one gap, or the dense gap plane
            mesh_collisions = dict(
                E_bins=E_bins, dE=dE, pmap=pmap, enable_recombination=enable_recombination,
                enable_scattering=enable_scattering, update_phonons=not freeze_phonon_dynamics,
                pixel_chunk=pixel_chunk,
            )
            if unique_gaps.size == 1:
                g0 = float(unique_gaps[0])
                mesh_collisions.update(
                    rho=rho_by_gap[0],
                    K_r0=recombination_kernel_base(E_bins, g0, tau_r_eff, T_c) if enable_recombination else None,
                    K_s0=scattering_kernel_base(E_bins, g0, tau_s_eff, T_c) if enable_scattering else None,
                )
            else:
                mesh_collisions.update(gap_plane=gap_plane, tau_s=tau_s_eff, tau_r=tau_r_eff, T_c=T_c,
                                       dynes_gamma=dynes_gamma)
        step = tables = None
        if kernel is not None:
            step, build_tables = KERNEL_STEPS[kernel]
            tables = build_tables(plan, atab)

    # the Pauli ρ state, formed on the device: ρ columns broadcast over the
    # mask plane (one gap), gathered by gap id (gap-id tables), or the
    # per-pixel DOS scattered into the mask (continuous maps, no collisions)
    mask_plane = torch.as_tensor(mask, dtype=dtype, device=device)
    if rho_by_gap is not None:
        rho_dev = torch.as_tensor(rho_by_gap.T, dtype=dtype, device=device)  # (NE, G)
        if unique_gaps.size == 1:
            rho_state = rho_dev[:, :1, None] * mask_plane
        else:
            gid_dev = torch.as_tensor(gap_id, device=device).long()
            rho_state = rho_dev[:, gid_dev] * mask_plane
    else:
        rho_state = torch.zeros((num_energy_bins, ny, nx), dtype=dtype, device=device)
        rho_state[:, torch.as_tensor(mask, device=device)] = torch.as_tensor(
            rho_per_pixel, dtype=dtype, device=device
        )
    pauli_stats = make_pauli_stats_fn(rho_state, pauli_density_floor)

    # --- generation and strang mode ---------------------------------------------
    gen = build_generation_program(external_generation, E_bins, mask, device, dtype)
    if strang_mode == "auto":
        # merged wherever it applies; the runner degenerates to the exact
        # composition without collisions, without diffusion, or at length 1
        strang_mode = "exact" if gen.host_mode else "merged"
    if strang_mode == "merged" and gen.host_mode:
        raise ValueError(
            "strang_mode='merged' cannot be combined with a host-evaluated "
            "custom generation expression: the fused segment has no per-step "
            "host boundary to evaluate it at.  Use strang_mode='exact' (or a "
            "traceable expression)."
        )

    # --- photon drive (Fischer 2024 pair-breaking photons) ---------------------
    # One exponential substep per tone, applied in order after the
    # generation injection and before the leading collision half; each tone
    # alone is an exact thermal fixed point, so the composition keeps
    # detailed balance.
    photon_specs = photon_drive_specs(photon_drive)
    photon_plans = []  # [(plan, window_start, window_end)]
    uniform_drive = int(unique_gaps.size) == 1
    for spec in photon_specs:
        common = dict(
            E_bins=E_bins, dE=dE, omega=spec.photon_energy, coupling=spec.coupling,
            occupancy=spec.occupancy, include_scattering=spec.include_scattering,
            include_pair_breaking=spec.include_pair_breaking,
        )
        if uniform_drive:
            rho0 = (rho_by_gap[0] if rho_by_gap is not None
                    else dynes_density_of_states(E_bins, float(unique_gaps[0]), dynes_gamma))
            ph_plan = build_photon_drive_plan(gap=gap, rho=rho0, **common)
        else:
            # gap maps: the coherence factors are affine in Δ², so the Δ²
            # plane and the Pauli ρ state replace the coefficient rows; the
            # ω > 2Δ(x) pair-breaking threshold is applied per pixel
            ph_plan = build_photon_drive_plan_analytic(**common)
        if ph_plan.k_offset == 0 and ph_plan.s_index < 0:
            # both channels snapped off-grid: the substep would be the identity
            raise ValueError(
                f"photon drive at omega={spec.photon_energy:g} µeV is "
                "inert: the scattering offset round(omega/dE) is 0 or "
                "beyond the grid, and the pair-breaking channel is "
                "closed (omega <= 2*gap) or its anti-diagonal misses "
                f"the grid (needs 2*E0 <= omega <= 2*E_max; grid "
                f"[{E_bins[0]:g}, {E_bins[-1]:g}] µeV, dE={dE:g}). "
                "Adjust omega or the energy grid, or disable the drive."
            )
        w0 = spec.window_start
        w1 = None if w0 is None else w0 + float(spec.window_duration)
        photon_plans.append((ph_plan, w0, w1))
    photon_on = bool(photon_plans)
    photon_aux: tuple = ()
    if photon_on and not uniform_drive:
        delta2 = np.zeros((ny, nx), dtype=np.float64)
        delta2[mask] = gap_values**2
        photon_aux = (torch.as_tensor(delta2, dtype=dtype, device=device), rho_state)

    def make_photon_apply(seg_dt: float):
        """``apply(q, t) -> q``: every tone's substep at host time ``t`` (state dtype)."""
        make = make_photon_substep if uniform_drive else make_photon_substep_per_pixel
        subs = [(make(plan_, seg_dt, dtype, device), w0, w1) for plan_, w0, w1 in photon_plans]

        def apply(q: torch.Tensor, t, weight=mask_plane, aux=photon_aux) -> torch.Tensor:
            """``weight``/``aux``: the mask and per-pixel planes of q's rows (a shard's)."""
            f = type(t)
            for sub, w0, w1 in subs:
                if w0 is not None and not (t >= f(w0) and t < f(w1)):
                    # outside the window the gated substep is max(q, 0)
                    q = torch.clamp(q, min=0.0)
                else:
                    q = sub(q, 1.0, weight, *aux)
            return q

        return apply

    # the uniform modes' dt·g plane rides the collision call that opens a
    # step, unless the photon substep has to sit between the two
    fuse_gen = gen.scalar_amp and collisions_on and not photon_on
    # the merged composition needs both halves of the Strang step
    merges = strang_mode == "merged" and collisions_on and enable_diffusion

    def make_col(dt_col: float):
        if not collisions_on:
            return None
        if step is not None:
            consts = (plan, atab, tables) if analytic else (plan, tables)
            return lambda q, ph, grow=None: step(*consts, q, ph, dt_col, grow)
        if analytic:  # beyond the kernels' bins, on the CPU
            return lambda q, ph, grow=None: collision_step_analytic_plain(
                plan, atab, q, ph, dt_col, grow
            )
        return lambda q, ph, grow=None: collision_step_plain(plan, q, ph, dt_col, grow)

    def step_ops(seg_dt: float) -> _StepOps:
        col_half, col_full = make_col(0.5 * seg_dt), make_col(seg_dt)
        diffuse = backend.make_step(seg_dt) if backend is not None else None

        def exact(q, ph, grow=None):
            """C(dt/2) D(dt) C(dt/2), or the parts that are on."""
            if collisions_on and diffuse is not None:
                q, ph = col_half(q, ph, grow)
                q = diffuse(q)
                return col_half(q, ph)
            if collisions_on:
                return col_full(q, ph, grow)
            return (q if diffuse is None else diffuse(q)), ph

        return _StepOps(
            col_half=col_half, col_full=col_full, diffuse=diffuse, exact=exact,
            plane=gen.plane, add_plane=lambda q, plane: q + plane[None], add_traced=gen.add,
            photon=make_photon_apply(seg_dt) if photon_on else None, stats=pauli_stats,
        )

    shard = gather = lambda x: x
    if mesh is not None:
        from ..parallel.sharded import build_sharded_step

        sharded_step = lambda seg_dt: build_sharded_step(
            mesh, op, seg_dt, dx=dx, collisions=mesh_collisions, dtype=dtype,
            gen_input=fuse_gen, pieces=merges, y_solve=mesh_y_solve,
        )
        step_ops, shard, gather = _mesh_step_ops(
            mesh, sharded_step, gen=gen, make_photon=make_photon_apply if photon_on else None,
            mask_plane=mask_plane, photon_aux=photon_aux, rho_state=rho_state,
            pauli_density_floor=pauli_density_floor,
        )
    return EngineProgram(
        pmap=pmap,
        segment_runner=_segment_runners(step_ops, gen, fuse_gen, merges, dtype, device),
        pauli_stats=pauli_stats,
        host_gen=gen.host_mode,
        shard=shard,
        gather=gather,
    )


@dataclass
class _StepOps:
    """One segment dt's step operations on the runner's state: the whole state, or a mesh's
    list of shards.  ``grow`` is the dt·g plane a collision call fuses (its shards on a mesh)."""

    col_half: Callable  # (q, ph, grow=None) -> (q, ph): C(dt/2)
    col_full: Callable  # (q, ph, grow=None) -> (q, ph): C(dt)
    diffuse: Callable | None  # q -> q: D(dt)
    exact: Callable  # (q, ph, grow=None) -> (q, ph): the Strang step after its injections
    plane: Callable  # (seg_dt, t) -> (dt·g plane, nonfinite, negative): the uniform modes
    add_plane: Callable  # (q, plane) -> q + plane
    add_traced: Callable  # (q, seg_dt, t_dev) -> (q + dt·g(t), nonfinite, negative) on the device
    photon: Callable | None  # (q, t) -> q: every tone's substep at host time t
    stats: Callable  # q -> (4,) Pauli statistics


def _segment_runners(step_ops: Callable[[float], _StepOps], gen, fuse_gen: bool, merges: bool,
                     dtype, device) -> Callable:
    """``segment_runner(seg_dt, length)`` (see :class:`EngineProgram`): the segment loop over
    ``step_ops(seg_dt)``, built once per ``(seg_dt, length)``.

    Each step first injects its generation (the uniform modes' dt·g plane, fused into the
    collision call that follows where ``fuse_gen``, else added; a traced expression's
    q + dt·g(t) with its device flags) and then its photon substeps.  Exact: the Strang step
    after them.  Merged (``merges``, segments longer than one step): C(dt/2) [D C(dt)]^(L-1) D C(dt/2), the trailing half-step of each
    Strang step fused with the next step's leading half; step k's injections ride its seam,
    just before the fused C(dt) the exact composition would split around, and its flags fold
    into slot k - 1 (step 0's and step 1's into slot 0).
    """
    np_t = numpy_dtype(dtype)
    ops_by_dt: dict[float, _StepOps] = {}
    runners: dict[tuple[float, int], Callable] = {}
    scalar_amp, traced = gen.scalar_amp, gen.traced_fn is not None

    def segment_runner(seg_dt: float, length: int):
        key = (seg_dt, length)
        if key in runners:
            return runners[key]
        if seg_dt not in ops_by_dt:
            ops_by_dt[seg_dt] = step_ops(seg_dt)
        ops = ops_by_dt[seg_dt]
        # locals, not attributes: the loop reads them every step
        col_half, col_full, diffuse, exact = ops.col_half, ops.col_full, ops.diffuse, ops.exact
        plane_of, add_plane, add_traced, photon, stats_of = (
            ops.plane, ops.add_plane, ops.add_traced, ops.photon, ops.stats)
        merged = merges and length > 1

        def run(q, ph, t_start: float):
            # in-segment times in the state dtype: t_k = t0 + k·dt, on the
            # host (windows, uniform amplitudes) and, for a traced
            # expression, the same arithmetic on the device
            t0 = np_t(t_start)
            times = [t0 + np_t(k) * np_t(seg_dt) for k in range(length)]
            t_dev = (
                torch.arange(length, dtype=dtype, device=device) * seg_dt
                + torch.full((), float(t0), dtype=dtype, device=device)
                if traced else None
            )
            flags = np.zeros((length, 2), dtype=bool)
            dev_flags: list = [None] * length
            stats: list[torch.Tensor] = []
            for k in range(length):
                seam = merged and k > 0
                if seam:
                    q = diffuse(q)
                slot = k - 1 if seam else k
                grow = None
                if scalar_amp:
                    plane, nf, ng = plane_of(seg_dt, times[k])
                    flags[slot] |= (nf, ng)
                    if fuse_gen:
                        grow = plane
                    else:
                        q = add_plane(q, plane)
                elif traced:
                    q, nf, ng = add_traced(q, seg_dt, t_dev[k])
                    row = torch.stack([nf, ng])
                    dev_flags[slot] = row if dev_flags[slot] is None else dev_flags[slot] | row
                if photon is not None:
                    q = photon(q, times[k])
                if not merged:
                    q, ph = exact(q, ph, grow)
                    stats.append(stats_of(q))
                elif seam:
                    q, ph = col_full(q, ph, grow)
                    stats.append(stats_of(q))
                else:
                    q, ph = col_half(q, ph, grow)
            if merged:
                q = diffuse(q)
                q, ph = col_half(q, ph)
                stats.append(stats_of(q))
            stats_t = torch.stack(stats)
            if traced:
                zero = torch.zeros(2, dtype=torch.bool, device=device)
                rows = torch.stack([zero if f is None else f for f in dev_flags])
                stats_t = torch.cat([stats_t, rows.to(stats_t.dtype)], dim=1)
            return q, ph, stats_t, flags

        runners[key] = run
        return run

    return segment_runner


def _combine_pauli(rows: torch.Tensor) -> torch.Tensor:
    """One (4,) Pauli statistics row from (K, 4) per-shard rows with global
    flat indices: the largest occupation at its first index, as the
    single-device ``argmax`` finds it, and the first forbidden cell."""
    inf = torch.full_like(rows[:, 1], float("inf"))
    mx = rows[:, 0].max()
    first = torch.where(rows[:, 0] == mx, rows[:, 1], inf).min()
    fany = rows[:, 2].max()
    fidx = torch.where(rows[:, 2] > 0, rows[:, 3], inf).min()
    return torch.stack([mx, first, fany, torch.where(fany > 0, fidx, torch.zeros_like(fidx))])


def _mesh_step_ops(mesh, sharded_step, *, gen, make_photon, mask_plane, photon_aux, rho_state,
                   pauli_density_floor) -> tuple[Callable, Callable, Callable]:
    """The step operations over a mesh: ``(step_ops, shard, gather)``.

    ``sharded_step(seg_dt)`` is one rows-sharded step of :mod:`..parallel.sharded`, whose
    collision kernels are the ``'auto'`` backend's (the JAX package's mesh branch takes no
    ``collision_backend`` either); its pieces make up the merged composition.  The
    generation plane and the photon substep (``make_photon(seg_dt)``, the single device's)
    act on each shard's rows; the Pauli statistics are taken per shard and reduced over
    the shards (largest occupation, first index).  The runner's state is this process's
    list of shards.
    """
    from ..parallel.mesh import SPACE_AXIS, StateSharding

    _, ny, nx = rho_state.shape
    rows = StateSharding(mesh)
    ex = mesh.exchange
    m = ny // mesh.shape[SPACE_AXIS]
    # per-shard Pauli statistics with their flat indices made global
    pauli_shards = [make_pauli_stats_fn(r, pauli_density_floor) for r in rows.shard(rho_state)]

    def pauli_mesh(q: list) -> torch.Tensor:
        local = []
        for fn, qi, (_, s) in zip(pauli_shards, q, mesh.cells):
            st = fn(qi)
            glob = lambda idx: (torch.div(idx, m * nx, rounding_mode="floor") * (ny * nx)
                                + s * m * nx + torch.remainder(idx, m * nx))
            local.append(torch.stack([st[0], glob(st[1]), st[2], glob(st[3])]))
        return _combine_pauli(ex.all_gather(local)[0]).to(rho_state.device)

    plane_shards: dict[int, list] = {}

    def shard_plane(seg_dt: float, t):
        # the generation program keeps one plane per dt·amp, so each is split once
        plane, nf, ng = gen.plane(seg_dt, t)
        if id(plane) not in plane_shards:
            plane_shards[id(plane)] = rows.shard(plane)
        return plane_shards[id(plane)], nf, ng

    def add_traced(q: list, seg_dt: float, t_dev: torch.Tensor):
        g = gen.traced_fn(t_dev)
        return ([qi + seg_dt * gi for qi, gi in zip(q, rows.shard(g))], *gen.flags(g))

    mask_sh = rows.shard(mask_plane)
    aux_sh = list(zip(*(rows.shard(a) for a in photon_aux))) if photon_aux else [()] * len(mask_sh)

    def step_ops(seg_dt: float) -> _StepOps:
        sh = sharded_step(seg_dt)
        raw, src = sh.aux
        on_shards = None
        if make_photon is not None:
            apply = make_photon(seg_dt)
            on_shards = lambda q, t: [apply(qi, t, w, a) for qi, w, a in zip(q, mask_sh, aux_sh)]
        return _StepOps(
            col_half=lambda q, ph, grow=None: (sh.apply_col_half(q, ph, raw) if grow is None
                                               else sh.apply_col_half_gen(q, ph, grow, raw)),
            col_full=lambda q, ph, grow=None: (sh.apply_col_full(q, ph, raw) if grow is None
                                               else sh.apply_col_full_gen(q, ph, grow, raw)),
            diffuse=lambda q: sh.apply_diffuse(q, raw, src),
            exact=lambda q, ph, grow=None: (sh.apply(q, ph, raw, src) if grow is None
                                            else sh.apply(q, ph, grow, raw, src))[:2],
            plane=shard_plane, add_plane=lambda q, plane: [qi + p[None] for qi, p in zip(q, plane)],
            add_traced=add_traced, photon=on_shards, stats=pauli_mesh,
        )

    return step_ops, rows.shard, rows.gather
