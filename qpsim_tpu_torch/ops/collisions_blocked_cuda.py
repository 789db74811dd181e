"""The collision substep beyond 64 energy bins: K5 and K6 on the column walk of ``csrc/offset_walk.cu``.

Port of ``qpsim_tpu.ops.pallas_collisions_blocked``:

* :func:`collision_step_blocked` — ``build_pallas_collision_step_blocked``
  (K5), for a uniform gap and for piecewise gap maps of at most
  :data:`~qpsim_tpu_torch.ops.collisions_cuda.MAX_GAP_IDS` unique gaps
  (per-pixel gap ids, launch counter ``collision_step_blocked_gid``);
* :func:`collision_step_blocked_analytic` —
  ``build_pallas_collision_step_blocked_analytic`` (K6), for continuous
  gap maps.

They compute the same function as K3 and K4
(:mod:`qpsim_tpu_torch.ops.collisions_cuda`), for up to
:data:`MAX_BLOCKED_BINS` bins, so their plain versions are K3's and K4's
(:func:`~qpsim_tpu_torch.ops.collisions.collision_step_plain`,
:func:`~qpsim_tpu_torch.ops.collisions.collision_step_analytic_plain`).
On the card they walk the TPU kernel's energy offsets and anti-diagonals
in K9's column form (one column per (offset, ω row) and (anti-diagonal, ω
row) group, :func:`~qpsim_tpu_torch.ops.collisions_rows_cuda.columns`), so
split ω diagonals stay exact, with the dt·g plane fused; the tables come
from :func:`build_column_tables`, once per program, and the launch from
:mod:`qpsim_tpu_torch.ops.column_walk`.  For tensors on the CPU
a wrapper runs its plain version; for CUDA tensors it launches the kernel
or raises — it never falls back.  Launches are counted in
:data:`~qpsim_tpu_torch.ops.collisions_cuda.LAUNCHES`.
"""

from __future__ import annotations

import torch

from .collisions import (
    AnalyticTables,
    CollisionPlan,
    collision_step_analytic_plain,
    collision_step_plain,
)
from .collisions_cuda import MAX_GAP_IDS, launch_columns
from .collisions_rows_cuda import columns
from .column_walk import ColumnTables, column_tables

__all__ = [
    "MAX_BLOCKED_BINS",
    "build_column_tables",
    "collision_step_blocked",
    "collision_step_blocked_analytic",
]

#: energy bins the blocked kernels take: the JAX package's envelope
#: (``_MAX_LOOP_BINS``).  Shared memory holds more — q and partner of a
#: 32-pixel tile take 64 KB (float32) / 128 KB (float64) of the block's
#: 227 KB at 256 bins — but nothing beyond 256 is checked against the
#: reference.
MAX_BLOCKED_BINS = 256


def _host(t: torch.Tensor | None):
    return None if t is None else t.detach().to("cpu", torch.float64).numpy()


def build_column_tables(plan: CollisionPlan, analytic: AnalyticTables | None = None) -> ColumnTables:
    """K5's (``analytic`` None) or K6's column tables for ``plan``, on the
    plan's device and dtype, built in float64 on the host.

    K5 re-indexes dE·K^s₀ and 2dE·K^r₀ per gap and reads an int32 copy of
    the plan's gap ids; K6 re-indexes the (a, b) parts of ``analytic``'s Δ²-affine constants.
    """
    ne = plan.num_energy_bins
    dev, dtype = plan.emit_mask.device, plan.emit_mask.dtype
    scat_on, rec_on = plan.enable_scattering, plan.enable_recombination
    group = lambda ks, kr: columns(ks if scat_on else None, kr if rec_on else None,
                                   plan.idx_diff_np, plan.idx_sum_np, ne)
    shared = dict(num_energy_bins=ne, num_omega=plan.num_omega, device=dev, dtype=dtype)
    if analytic is None:
        if plan.rho is None:
            raise ValueError("an analytic plan runs the analytic collision kernel")
        if plan.num_gaps > MAX_GAP_IDS:
            raise ValueError(
                f"{plan.num_gaps} unique gaps: the gap-id kernel takes at most {MAX_GAP_IDS} "
                "(continuous gap maps run the analytic kernel)"
            )
        ks = _host(plan.K_s0) * plan.dE if scat_on else None
        kr = _host(plan.K_r0) * (2.0 * plan.dE) if rec_on else None
        scat_k, scat_row, scat, rec_s, rec_row, rec = group(ks, kr)
        return column_tables(scat_k=scat_k, scat_row=scat_row, scat=scat, rec_s=rec_s,
                             rec_row=rec_row, rec=rec, rho=_host(plan.rho), gap_id=plan.gap_id,
                             **shared)
    a = analytic
    stack = lambda t: None if t is None else _host(t)[None]
    scat_k, scat_row, scat, rec_s, rec_row, rec = group(stack(a.dEa_s), stack(a.dEa2_r))
    slopes = group(stack(a.dEb_s), stack(a.dEb2_r))  # the same columns
    scat_b, rec_b = slopes[2], slopes[5]
    return column_tables(scat_k=scat_k, scat_row=scat_row, scat=scat, rec_s=rec_s, rec_row=rec_row,
                         rec=rec, scat_b=scat_b, rec_b=rec_b, analytic=a, **shared)


def collision_step_blocked(
    plan: CollisionPlan,
    tables: ColumnTables,
    n_qp: torch.Tensor,
    n_ph: torch.Tensor,
    dt: float,
    gen: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One collision substep through K5 (plain version on the CPU).

    Same contract as :func:`~qpsim_tpu_torch.ops.collisions_cuda.collision_step`,
    with ``tables`` from :func:`build_column_tables`; a plan with per-pixel
    gap ids launches the gap-id form (``collision_step_blocked_gid``).
    """
    if n_qp.device.type == "cpu":
        return collision_step_plain(plan, n_qp, n_ph, dt, gen)
    name = "collision_step_blocked" if plan.gap_id is None else "collision_step_blocked_gid"
    return launch_columns(name, plan, tables, n_qp, n_ph, dt, gen, max_bins=MAX_BLOCKED_BINS)


def collision_step_blocked_analytic(
    plan: CollisionPlan,
    analytic: AnalyticTables,
    tables: ColumnTables,
    n_qp: torch.Tensor,
    n_ph: torch.Tensor,
    dt: float,
    gen: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One analytic-gap collision substep through K6 (plain version on the CPU).

    Same contract as
    :func:`~qpsim_tpu_torch.ops.collisions_cuda.collision_step_analytic`,
    with ``tables`` from :func:`build_column_tables` (plan, analytic).
    """
    if n_qp.device.type == "cpu":
        return collision_step_analytic_plain(plan, analytic, n_qp, n_ph, dt, gen)
    return launch_columns("collision_step_blocked_analytic", plan, tables, n_qp, n_ph, dt, gen, analytic,
                          MAX_BLOCKED_BINS)
