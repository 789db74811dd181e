"""The collision substep beyond 64 energy bins: K5 and K6 on the column walk of ``csrc/offset_walk.cu``.

Port of ``qpsim_tpu.ops.pallas_collisions_blocked``:

* :func:`collision_step_blocked` — ``build_pallas_collision_step_blocked``
  (K5), for a uniform gap and for per-pixel gap ids (launch counter
  ``collision_step_blocked_gid``): piecewise gap maps of at most
  :data:`~qpsim_tpu_torch.ops.collisions_cuda.MAX_GAP_IDS` unique gaps in
  the engine, any number of per-gap tables through :func:`plan_launcher`;
* :func:`collision_step_blocked_analytic` —
  ``build_pallas_collision_step_blocked_analytic`` (K6), for continuous
  gap maps;
* :func:`collision_kernel_for` and :data:`KERNEL_STEPS` — the dispatch
  among K3, K4, K5 and K6 that the engine's program, the JAX-form builders
  of :mod:`~qpsim_tpu_torch.ops.collisions_cuda` and :func:`plan_launcher`
  share;
* :func:`plan_launcher` — the launch behind
  :func:`qpsim_tpu_torch.ops.collisions.make_collision_step` on the card.

They compute the same function as K3 and K4
(:mod:`qpsim_tpu_torch.ops.collisions_cuda`), at any number of bins
beyond 64 (the JAX package's TPU kernels stop at 256 and run its XLA
integrator beyond), so their plain versions are K3's and K4's
(:func:`~qpsim_tpu_torch.ops.collisions.collision_step_plain`,
:func:`~qpsim_tpu_torch.ops.collisions.collision_step_analytic_plain`).
On the card they walk the TPU kernel's energy offsets and anti-diagonals
in K9's column form (one column per (offset, ω row) and (anti-diagonal, ω
row) group, :func:`~qpsim_tpu_torch.ops.collisions_rows_cuda.columns`), so
split ω diagonals stay exact, with the dt·g plane fused; the tables come
from :func:`build_column_tables`, once per program, and the launch from
:mod:`qpsim_tpu_torch.ops.column_walk` — the tile staged in shared memory
up to 908 bins in float32 and 454 in float64, in device memory beyond
(:func:`~qpsim_tpu_torch.ops.column_walk.column_form`).  For tensors on the CPU
a wrapper runs its plain version; for CUDA tensors it launches the kernel
or raises — it never falls back.  Launches are counted in
:data:`~qpsim_tpu_torch.ops.collisions_cuda.LAUNCHES`.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Callable

import torch

from .collisions import (
    AnalyticTables,
    CollisionPlan,
    collision_step_analytic_plain,
    collision_step_plain,
)
from ..utils.cuda_build import refuse_grad
from .collisions_cuda import (
    MAX_GAP_IDS,
    MAX_KERNEL_BINS,
    build_kernel_tables,
    collision_step,
    collision_step_analytic,
    launch_columns,
)
from .collisions_rows_cuda import columns
from .column_walk import ColumnTables, column_tables

__all__ = [
    "KERNEL_STEPS",
    "build_column_tables",
    "collision_kernel_for",
    "collision_step_blocked",
    "collision_step_blocked_analytic",
    "kernel_forms",
    "plan_launcher",
]

def _host(t: torch.Tensor | None):
    return None if t is None else t.detach().to("cpu", torch.float64).numpy()


def build_column_tables(plan: CollisionPlan, analytic: AnalyticTables | None = None) -> ColumnTables:
    """K5's (``analytic`` None) or K6's column tables for ``plan``, on the
    plan's device and dtype, built in float64 on the host.

    K5 re-indexes dE·K^s₀ and 2dE·K^r₀ per gap and reads an int32 copy of
    the plan's gap ids, any number of gaps (the engine's dispatch sends it
    at most :data:`MAX_GAP_IDS`; :func:`plan_launcher` more); K6 re-indexes
    the (a, b) parts of ``analytic``'s Δ²-affine constants.
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
    refuse_grad("the blocked collision kernel (K5)", "ops.collisions.collision_step_plain", n_qp, n_ph, gen)
    if n_qp.device.type == "cpu":
        return collision_step_plain(plan, n_qp, n_ph, dt, gen)
    name = "collision_step_blocked" if plan.gap_id is None else "collision_step_blocked_gid"
    return launch_columns(name, plan, tables, n_qp, n_ph, dt, gen, max_bins=None)


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
    refuse_grad("the blocked analytic collision kernel (K6)", "ops.collisions.collision_step_analytic_plain",
                n_qp, n_ph, gen, analytic.g2)
    if n_qp.device.type == "cpu":
        return collision_step_analytic_plain(plan, analytic, n_qp, n_ph, dt, gen)
    return launch_columns("collision_step_blocked_analytic", plan, tables, n_qp, n_ph, dt, gen, analytic,
                          max_bins=None)


def collision_kernel_for(ne: int, n_gaps: int) -> str:
    """The collision kernel for NE bins and G unique gaps.

    "K3" (uniform gap) or "K3_gid" (G ≤ 8 gap ids) up to 64 bins, "K5" /
    "K5_gid" beyond; continuous maps (G > 8) "K4" up to 64 bins, "K6"
    beyond.  ``qpsim_tpu`` dispatches so up to 256 bins and runs its XLA
    integrator beyond, with per-gap stacks also for G > 8 (refused past 4
    GB); the port keeps K5/K6 there.
    """
    if n_gaps > MAX_GAP_IDS:
        return "K4" if ne <= MAX_KERNEL_BINS else "K6"
    kernel = "K3" if ne <= MAX_KERNEL_BINS else "K5"
    return kernel if n_gaps == 1 else f"{kernel}_gid"


#: each code's (wrapper, table builder): K3/K4 read the pair-walk tables of
#: ``build_kernel_tables(plan, analytic)``, K5/K6 the column tables of
#: ``build_column_tables(plan, analytic)``; the table wrappers take the
#: gap-id form from ``plan.gap_id``, the analytic ones (K4, K6) also take
#: the Δ² tables
KERNEL_STEPS: dict[str, tuple[Callable, Callable]] = {
    "K3": (collision_step, build_kernel_tables),
    "K3_gid": (collision_step, build_kernel_tables),
    "K4": (collision_step_analytic, build_kernel_tables),
    "K5": (collision_step_blocked, build_column_tables),
    "K5_gid": (collision_step_blocked, build_column_tables),
    "K6": (collision_step_blocked_analytic, build_column_tables),
}


def kernel_forms(ne: int, n_gaps: int, analytic: bool) -> tuple[Callable, Callable]:
    """(wrapper, table builder) of the kernel :func:`collision_kernel_for`
    names: K3/K4 up to 64 bins, K5/K6 beyond."""
    return KERNEL_STEPS[collision_kernel_for(ne, MAX_GAP_IDS + 1 if analytic else n_gaps)]


def plan_launcher(plan: CollisionPlan):
    """``launch(p, n_qp, n_ph, dt)`` of a per-gap-table plan on the card, ``p``
    the plan or a copy of it with other gap ids.

    The kernel of :func:`kernel_forms`: K3 (uniform gap or at most
    :data:`MAX_GAP_IDS` gaps by id) to 64 bins, K5 beyond.  More per-gap
    tables than that — they are not affine in Δ² (a τ per ensemble member,
    say), so K4/K6 cannot take them — run K5 with gap ids
    (``collision_step_blocked_gid``), whose column walk reads any number of
    int32 ids.  Tables are built here once.
    """
    wrapper, tables_of = kernel_forms(plan.num_energy_bins, min(plan.num_gaps, MAX_GAP_IDS), analytic=False)
    if plan.num_gaps > MAX_GAP_IDS:
        wrapper, tables_of = collision_step_blocked, build_column_tables
    tables = tables_of(plan)

    def launch(p, n_qp, n_ph, dt):
        t = tables
        if isinstance(t, ColumnTables) and p.gap_id is not plan.gap_id:
            t = replace(t, gid=p.gap_id.to(torch.int32).contiguous())
        return wrapper(p, t, n_qp, n_ph, dt)

    launch.tables = tables
    return launch
