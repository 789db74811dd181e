"""The collision substep beyond 64 energy bins: wrappers of ``csrc/collisions_blocked.cu``.

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
:func:`~qpsim_tpu_torch.ops.collisions.collision_step_analytic_plain`),
and they take the same tables
(:func:`~qpsim_tpu_torch.ops.collisions_cuda.build_kernel_tables`).  For tensors
on the CPU a wrapper runs that plain version; for CUDA tensors it launches
its kernel or raises — it never falls back.  Launches are counted in
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
from .collisions_cuda import CollisionKernelTables, analytic_step, table_step

__all__ = [
    "MAX_BLOCKED_BINS",
    "collision_step_blocked",
    "collision_step_blocked_analytic",
]

#: energy bins the blocked kernels take: the JAX package's envelope
#: (``_MAX_LOOP_BINS``).  Shared memory holds more — q and partner of a
#: 32-pixel tile take 64 KB (float32) / 128 KB (float64) of the block's
#: 227 KB at 256 bins — but nothing beyond 256 is checked against the
#: reference.
MAX_BLOCKED_BINS = 256


def collision_step_blocked(
    plan: CollisionPlan,
    tables: CollisionKernelTables,
    n_qp: torch.Tensor,
    n_ph: torch.Tensor,
    dt: float,
    gen: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One collision substep through K5 (plain version on the CPU).

    Same contract as :func:`~qpsim_tpu_torch.ops.collisions_cuda.collision_step`;
    a plan with per-pixel gap ids launches the gap-id form.
    """
    if n_qp.device.type == "cpu":
        return collision_step_plain(plan, n_qp, n_ph, dt, gen)
    return table_step("collision_blocked", "collision_step_blocked", MAX_BLOCKED_BINS,
                      plan, tables, n_qp, n_ph, dt, gen)


def collision_step_blocked_analytic(
    plan: CollisionPlan,
    analytic: AnalyticTables,
    tables: CollisionKernelTables,
    n_qp: torch.Tensor,
    n_ph: torch.Tensor,
    dt: float,
    gen: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One analytic-gap collision substep through K6 (plain version on the CPU).

    Same contract as
    :func:`~qpsim_tpu_torch.ops.collisions_cuda.collision_step_analytic`.
    """
    if n_qp.device.type == "cpu":
        return collision_step_analytic_plain(plan, analytic, n_qp, n_ph, dt, gen)
    return analytic_step("collision_blocked", "collision_step_blocked", MAX_BLOCKED_BINS,
                         plan, analytic, tables, n_qp, n_ph, dt, gen)
