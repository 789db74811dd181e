"""Engine program: diffusion backend, collision dispatch and segment runners.

Carried over from ``qpsim_tpu.solver.program_build`` (single-device part).
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
  G ≤ 8 unique gaps (gap ids when G > 1) K3 up to 64 bins and K5 up to
  256, from the per-pixel Δ² for G > 8 (no per-gap stacks) K4 and K6;
  beyond 256 bins the plain versions on the CPU, an error on CUDA.
  ``'kernel'`` does the same but raises on the CPU; ``'plain'`` runs the
  plain per-gap gather version everywhere, which refuses stacks above 4
  GB.  The JAX package's names are aliases: ``'pallas'`` is ``'kernel'``
  (beyond 256 bins with the JAX package's ``ValueError``), ``'xla'`` is
  ``'plain'``.  K3/K4 read the pair-walk tables of ``build_kernel_tables``,
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
from ..ops.collisions_blocked_cuda import (
    MAX_BLOCKED_BINS,
    build_column_tables,
    collision_step_blocked,
    collision_step_blocked_analytic,
)
from ..ops.collisions_cuda import (
    MAX_GAP_IDS,
    MAX_KERNEL_BINS,
    build_kernel_tables,
    collision_step,
    collision_step_analytic,
)
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
from .diffusion_backends import choose_backend
from .pauli import make_pauli_stats_fn

__all__ = ["EngineProgram", "build_engine_program", "collision_kernel_for"]


def collision_kernel_for(ne: int, n_gaps: int) -> str | None:
    """The collision kernel for NE bins and G unique gaps, as ``qpsim_tpu`` dispatches.

    "K3" (uniform gap) or "K3_gid" (G ≤ 8 gap ids) up to 64 bins, "K5" /
    "K5_gid" from 65 to 256; continuous maps (G > 8) "K4" up to 64 bins,
    "K6" to 256.  None above 256 bins, where only the plain versions run
    (the JAX package runs its XLA integrator there).
    """
    if ne > MAX_BLOCKED_BINS:
        return None
    if n_gaps > MAX_GAP_IDS:
        return "K4" if ne <= MAX_KERNEL_BINS else "K6"
    kernel = "K3" if ne <= MAX_KERNEL_BINS else "K5"
    return kernel if n_gaps == 1 else f"{kernel}_gid"


#: each code's (wrapper, table builder): K3/K4 read the pair-walk tables of
#: ``build_kernel_tables(plan, analytic)``, K5/K6 the column tables of
#: ``build_column_tables(plan, analytic)``; the table wrappers take the
#: gap-id form from ``plan.gap_id``, the analytic ones (K4, K6) also take
#: the Δ² tables
_KERNEL_STEPS: dict[str, tuple[Callable, Callable]] = {
    "K3": (collision_step, build_kernel_tables),
    "K3_gid": (collision_step, build_kernel_tables),
    "K4": (collision_step_analytic, build_kernel_tables),
    "K5": (collision_step_blocked, build_column_tables),
    "K5_gid": (collision_step_blocked, build_column_tables),
    "K6": (collision_step_blocked_analytic, build_column_tables),
}


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
    kernel = collision_kernel_for(num_energy_bins, int(unique_gaps.size)) if use_kernel else None
    if use_kernel and kernel is None and collision_backend == "pallas":
        raise ValueError(
            "collision_backend='pallas' requested but the configuration is outside the kernel's "
            f"envelope (2-{MAX_BLOCKED_BINS} bins)"
        )
    if use_kernel and kernel is None and device.type == "cuda":
        raise NotImplementedError(
            f"{num_energy_bins} energy bins: the collision kernels hold at most "
            f"{MAX_BLOCKED_BINS}; the integrator beyond them is not ported to the "
            "card (ROADMAP.md, queue 1 item 14: NE > 256 on CUDA)."
        )

    # --- diffusion backend -------------------------------------------------
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
        # a step composed with collisions keeps multi-bin operators on K2
        backend = choose_backend(op, device, dtype, diffusion_backend, coupled=collisions_on)

    # --- collision data ------------------------------------------------------
    pmap = build_phonon_frequency_map(E_bins)
    plan = atab = rho_by_gap = None
    if not collisions_on:  # only the Pauli ρ plane, vectorised over pixels
        rho_per_pixel = dynes_density_of_states_per_pixel(E_bins, gap_values, dynes_gamma)
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
        step, build_tables = _KERNEL_STEPS[kernel]
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

        def apply(q: torch.Tensor, t) -> torch.Tensor:
            f = type(t)
            for sub, w0, w1 in subs:
                if w0 is not None and not (t >= f(w0) and t < f(w1)):
                    # outside the window the gated substep is max(q, 0)
                    q = torch.clamp(q, min=0.0)
                else:
                    q = sub(q, 1.0, mask_plane, *photon_aux)
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
