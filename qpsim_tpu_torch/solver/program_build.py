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
  calls :attr:`EngineProgram.single_step` once per step.
* photon drive (Fischer 2024) — each step, after the generation injection
  and before the leading collision half (at every seam of the merged
  composition), each tone's exponential substep in order, inside its own
  window; per-pixel coefficients from the Δ² plane and the Pauli ρ state
  under a gap map.  The substep is the JAX package's XLA glue in plain
  torch (``ops.photon_drive``); a step outside a tone's window is the
  identity on a non-negative state, computed as its ``max(q, 0)``.
* mesh — the mesh branch (``program_build.py:492-690`` of the JAX
  package, :func:`_mesh_program`): one rows-sharded step of
  ``parallel.sharded`` per segment dt, which builds its own collision
  tables and local solves; the runner's state is a list of shards.
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
    #: seg_dt -> one(q, ph, t) -> (q, ph, stats): one step after a host-mode
    #: generation add (photon substep, then the Strang step), ``t`` the host time
    single_step: Callable
    #: the generation is evaluated on the host every step
    host_gen: bool
    #: a whole state → the runner's state (this process's shards on a mesh)
    shard: Callable = lambda x: x
    #: the runner's state → the whole state (every shard, gathered)
    gather: Callable = lambda x: x


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
        plan = atab = rho_by_gap = None
        if not collisions_on or (mesh is not None and unique_gaps.size > MAX_GAP_IDS):
            # only the Pauli ρ plane, vectorised over pixels (a mesh's sharded
            # step builds its own collision tables)
            rho_per_pixel = dynes_density_of_states_per_pixel(E_bins, gap_values, dynes_gamma)
        elif mesh is not None:
            rho_by_gap = np.stack(
                [dynes_density_of_states(E_bins, float(g), dynes_gamma) for g in unique_gaps]
            )
        elif analytic:
            gap_plane = np.full((ny, nx), gap, dtype=np.float64)
            gap_plane[mask] = gap_values
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
    np_t = numpy_dtype(dtype)

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

    def strang_step(q, ph, col_half, col_full, diff_step, grow=None):
        """One step after its injections: C(dt/2) D(dt) C(dt/2), or the parts that are on."""
        if collisions_on and diff_step is not None:
            q, ph = col_half(q, ph, grow)
            q = diff_step(q)
            q, ph = col_half(q, ph)
        elif collisions_on:
            q, ph = col_full(q, ph, grow)
        elif diff_step is not None:
            q = diff_step(q)
        return q, ph

    seg_cache: dict[tuple[float, int], Callable] = {}

    if mesh is not None:
        return _mesh_program(
            mesh=mesh, mesh_y_solve=mesh_y_solve, op=op if enable_diffusion else None, dx=dx,
            dtype=dtype, device=device, pmap=pmap, E_bins=E_bins, dE=dE, gap=gap, mask=mask,
            unique_gaps=unique_gaps, gap_values=gap_values, rho_by_gap=rho_by_gap,
            rho_state=rho_state, pauli_stats=pauli_stats, pauli_density_floor=pauli_density_floor,
            enable_recombination=enable_recombination, enable_scattering=enable_scattering,
            dynes_gamma=dynes_gamma, tau_s_eff=tau_s_eff, tau_r_eff=tau_r_eff, T_c=T_c,
            freeze_phonon_dynamics=freeze_phonon_dynamics, pixel_chunk=pixel_chunk, gen=gen, strang_mode=strang_mode, np_t=np_t,
            photon_on=photon_on, make_photon_apply=make_photon_apply, mask_plane=mask_plane,
            photon_aux=photon_aux,
        )

    def segment_runner(seg_dt: float, length: int):
        key = (seg_dt, length)
        if key in seg_cache:
            return seg_cache[key]
        col_half = make_col(0.5 * seg_dt)
        col_full = make_col(seg_dt)
        diff_step = backend.make_step(seg_dt) if backend is not None else None
        photon_apply = make_photon_apply(seg_dt) if photon_on else None
        merged = strang_mode == "merged" and collisions_on and diff_step is not None and length > 1
        traced = gen.traced_fn is not None

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

            def inject(q, k, slot):
                """Step k's generation and photon substeps; its flags go to ``slot``.
                Returns q and the plane the collision call fuses (or None)."""
                grow = None
                if gen.scalar_amp:
                    plane, nf, ng = gen.plane(seg_dt, times[k])
                    flags[slot] |= (nf, ng)
                    if fuse_gen:
                        grow = plane
                    else:
                        q = q + plane[None]
                elif traced:
                    q, nf, ng = gen.add(q, seg_dt, t_dev[k])
                    row = torch.stack([nf, ng])
                    dev_flags[slot] = row if dev_flags[slot] is None else dev_flags[slot] | row
                if photon_apply is not None:
                    q = photon_apply(q, times[k])
                return q, grow

            stats: list[torch.Tensor] = []
            if merged:
                # C(dt/2) [D C(dt)]^(L-1) D C(dt/2): the trailing half-step of
                # each Strang step is fused with the next step's leading half.
                # Step k's injections (generation, photons) ride its seam, just
                # before the fused C(dt) the exact composition would split
                # around; step 1's flags fold into slot 0.
                q, grow = inject(q, 0, 0)
                q, ph = col_half(q, ph, grow)
                for k in range(length - 1):
                    q = diff_step(q)
                    q, grow = inject(q, k + 1, k)
                    q, ph = col_full(q, ph, grow)
                    stats.append(pauli_stats(q))
                q = diff_step(q)
                q, ph = col_half(q, ph)
                stats.append(pauli_stats(q))
            else:
                for k in range(length):
                    q, grow = inject(q, k, k)
                    q, ph = strang_step(q, ph, col_half, col_full, diff_step, grow)
                    stats.append(pauli_stats(q))
            stats_t = torch.stack(stats)
            if traced:
                zero = torch.zeros(2, dtype=torch.bool, device=device)
                rows = torch.stack([zero if f is None else f for f in dev_flags])
                stats_t = torch.cat([stats_t, rows.to(stats_t.dtype)], dim=1)
            return q, ph, stats_t, flags

        seg_cache[key] = run
        return run

    single_cache: dict[float, Callable] = {}

    def single_step(seg_dt: float):
        """One step after the runner's host-mode generation add: the photon
        substep at host time ``t``, then the Strang step."""
        if seg_dt not in single_cache:
            col_half = make_col(0.5 * seg_dt)
            col_full = make_col(seg_dt)
            diff_step = backend.make_step(seg_dt) if backend is not None else None
            photon_apply = make_photon_apply(seg_dt) if photon_on else None

            def one(q, ph, t: float):
                if photon_apply is not None:
                    q = photon_apply(q, np_t(t))
                q, ph = strang_step(q, ph, col_half, col_full, diff_step)
                return q, ph, pauli_stats(q)

            single_cache[seg_dt] = one
        return single_cache[seg_dt]

    return EngineProgram(
        pmap=pmap,
        segment_runner=segment_runner,
        pauli_stats=pauli_stats,
        single_step=single_step,
        host_gen=gen.host_mode,
    )


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


def _mesh_program(*, mesh, mesh_y_solve, op, dx, dtype, device, pmap, E_bins, dE, gap, mask,
                  unique_gaps, gap_values, rho_by_gap, rho_state, pauli_stats, pauli_density_floor,
                  enable_recombination, enable_scattering, dynes_gamma, tau_s_eff, tau_r_eff, T_c,
                  freeze_phonon_dynamics, pixel_chunk, gen, strang_mode, np_t,
                  photon_on, make_photon_apply, mask_plane, photon_aux) -> EngineProgram:
    """The engine program over a mesh: the hot loop on :mod:`..parallel.sharded` steps.

    The same C(dt/2) D(dt) C(dt/2) composition (and, merged, the sharded
    step's pieces), with one ``ShardedStep`` per segment ``dt``, whose
    collision kernels are the ``'auto'`` backend's (the JAX package's mesh
    branch takes no ``collision_backend`` either).  The
    generation plane and the photon substep act on each shard's rows; the
    Pauli statistics are taken per shard and reduced over the shards
    (largest occupation, first index), and the mass over the grid, as
    ``psum`` does.  The runner's state is this process's list of shards.
    """
    from ..parallel.mesh import SPACE_AXIS, StateSharding
    from ..parallel.sharded import build_sharded_step

    ny, nx = mask.shape
    collisions_on = bool(enable_recombination or enable_scattering)
    mesh_collisions = None
    if collisions_on and int(unique_gaps.size) == 1:
        g0 = float(unique_gaps[0])
        mesh_collisions = dict(
            E_bins=E_bins, dE=dE, rho=rho_by_gap[0], pmap=pmap,
            K_r0=recombination_kernel_base(E_bins, g0, tau_r_eff, T_c) if enable_recombination else None,
            K_s0=scattering_kernel_base(E_bins, g0, tau_s_eff, T_c) if enable_scattering else None,
            enable_recombination=enable_recombination, enable_scattering=enable_scattering,
            update_phonons=not freeze_phonon_dynamics, pixel_chunk=pixel_chunk,
        )
    elif collisions_on:
        gap_plane = np.full((ny, nx), gap, dtype=np.float64)
        gap_plane[mask] = gap_values
        mesh_collisions = dict(
            E_bins=E_bins, dE=dE, pmap=pmap, gap_plane=gap_plane, tau_s=tau_s_eff, tau_r=tau_r_eff,
            T_c=T_c, dynes_gamma=dynes_gamma, enable_recombination=enable_recombination,
            enable_scattering=enable_scattering, update_phonons=not freeze_phonon_dynamics,
            pixel_chunk=pixel_chunk,
        )

    # the uniform modes' dt·g plane rides the sharded step (fused into the
    # collision kernel, or pre-added there), unless a photon drive is on
    fuse_gen = gen.scalar_amp and not photon_on
    merged_mesh = strang_mode == "merged" and collisions_on
    sharded_cache: dict = {}

    def get_sharded(seg_dt: float):
        if seg_dt not in sharded_cache:
            sharded_cache[seg_dt] = build_sharded_step(
                mesh, op, seg_dt, dx=dx, collisions=mesh_collisions, dtype=dtype,
                gen_input=fuse_gen, pieces=merged_mesh, y_solve=mesh_y_solve,
            )
        return sharded_cache[seg_dt]

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
        return _combine_pauli(ex.all_gather(local)[0]).to(device)

    plane_shards: dict[int, list] = {}

    def shard_plane(plane: torch.Tensor) -> list:
        # the generation program keeps one plane per dt·amp, so each is split once
        if id(plane) not in plane_shards:
            plane_shards[id(plane)] = rows.shard(plane)
        return plane_shards[id(plane)]

    mask_sh = rows.shard(mask_plane)
    aux_sh = list(zip(*(rows.shard(a) for a in photon_aux))) if photon_aux else [()] * len(mask_sh)
    seg_cache: dict = {}

    def segment_runner(seg_dt: float, length: int):
        key = (seg_dt, length)
        if key in seg_cache:
            return seg_cache[key]
        sh = get_sharded(seg_dt)
        raw, src = sh.aux
        merged = merged_mesh and length > 1 and sh.apply_diffuse is not None
        photon_apply = make_photon_apply(seg_dt) if photon_on else None
        traced = gen.traced_fn is not None

        def run(q, ph, t_start: float):
            t0 = np_t(t_start)
            times = [t0 + np_t(k) * np_t(seg_dt) for k in range(length)]
            t_dev = (
                torch.arange(length, dtype=dtype, device=device) * seg_dt
                + torch.full((), float(t0), dtype=dtype, device=device)
                if traced else None
            )
            flags = np.zeros((length, 2), dtype=bool)
            dev_flags: list = [None] * length

            def inject(q, k, slot):
                """Step k's generation and photon substeps on every shard; the
                shards' dt·g planes the sharded step fuses (or None)."""
                grow = None
                if gen.scalar_amp:
                    plane, nf, ng = gen.plane(seg_dt, times[k])
                    flags[slot] |= (nf, ng)
                    if fuse_gen:
                        grow = shard_plane(plane)
                    else:
                        q = [qi + p[None] for qi, p in zip(q, shard_plane(plane))]
                elif traced:
                    g = gen.traced_fn(t_dev[k])
                    row = torch.stack(gen.flags(g))
                    dev_flags[slot] = row if dev_flags[slot] is None else dev_flags[slot] | row
                    q = [qi + seg_dt * gi for qi, gi in zip(q, rows.shard(g))]
                if photon_apply is not None:
                    q = [photon_apply(qi, times[k], w, a) for qi, w, a in zip(q, mask_sh, aux_sh)]
                return q, grow

            stats: list[torch.Tensor] = []
            if merged:
                # C(dt/2) [D C(dt)]^(L-1) D C(dt/2), injections at the seams
                # as in the single-device runner
                q, grow = inject(q, 0, 0)
                q, ph = (sh.apply_col_half(q, ph, raw) if grow is None
                         else sh.apply_col_half_gen(q, ph, grow, raw))
                for k in range(length - 1):
                    q = sh.apply_diffuse(q, raw, src)
                    q, grow = inject(q, k + 1, k)
                    q, ph = (sh.apply_col_full(q, ph, raw) if grow is None
                             else sh.apply_col_full_gen(q, ph, grow, raw))
                    stats.append(pauli_mesh(q))
                q = sh.apply_diffuse(q, raw, src)
                q, ph = sh.apply_col_half(q, ph, raw)
                stats.append(pauli_mesh(q))
            else:
                for k in range(length):
                    q, grow = inject(q, k, k)
                    q, ph, _ = (sh.apply(q, ph, grow, raw, src) if fuse_gen
                                else sh.apply(q, ph, raw, src))
                    stats.append(pauli_mesh(q))
            stats_t = torch.stack(stats)
            if traced:
                zero = torch.zeros(2, dtype=torch.bool, device=device)
                flag_rows = torch.stack([zero if f is None else f for f in dev_flags])
                stats_t = torch.cat([stats_t, flag_rows.to(stats_t.dtype)], dim=1)
            return q, ph, stats_t, flags

        seg_cache[key] = run
        return run

    single_cache: dict = {}

    def single_step(seg_dt: float):
        """One step after the runner's host-mode generation add."""
        if seg_dt not in single_cache:
            sh = get_sharded(seg_dt)
            photon_apply = make_photon_apply(seg_dt) if photon_on else None

            def one(q, ph, t: float):
                if photon_apply is not None:
                    q = [photon_apply(qi, np_t(t), w, a) for qi, w, a in zip(q, mask_sh, aux_sh)]
                q, ph, _ = sh.apply(q, ph, *sh.aux)
                return q, ph, pauli_mesh(q)

            single_cache[seg_dt] = one
        return single_cache[seg_dt]

    return EngineProgram(
        pmap=pmap, segment_runner=segment_runner, pauli_stats=pauli_stats, single_step=single_step,
        host_gen=gen.host_mode, shard=rows.shard, gather=rows.gather,
    )
