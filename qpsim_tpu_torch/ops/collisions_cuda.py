"""The collision substep on the card: wrappers of the CUDA kernels ``csrc/collisions.cu``.

Port of ``qpsim_tpu.ops.pallas_collisions``:

* :func:`collision_step` — ``build_pallas_collision_step`` (kernel
  ``_make_kernel``, K3), for a uniform gap and for piecewise gap maps of at
  most :data:`MAX_GAP_IDS` unique gaps (per-pixel gap ids);
* :func:`collision_step_analytic` — ``build_pallas_collision_step_analytic``
  (kernel ``_make_analytic_kernel``, K4), for continuous gap maps.

Each takes the arguments of its plain version
(:func:`qpsim_tpu_torch.ops.collisions.collision_step_plain`,
:func:`~qpsim_tpu_torch.ops.collisions.collision_step_analytic_plain`) plus
the kernel's tables.  For tensors on the CPU it runs that plain version;
for CUDA tensors it launches the kernel or raises — it never falls back.

The kernels read the physics from small device tables built once per plan
(:func:`build_kernel_tables`): ρ, dE·K^s₀, 2dE·K^r₀ per gap (K3 only), the
per-pair ω maps ``idx_diff``/``idx_sum``, sign(Eᵢ − Eⱼ), and for every ω
row the list of pairs that land on it (``row_ptr``/``row_code``, CSR), so
the phonon rates are gathered per row instead of scattered into a
per-pixel array.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..utils.cuda_build import load_kernels
from .collisions import (
    AnalyticTables,
    CollisionPlan,
    collision_step_analytic_plain,
    collision_step_plain,
)

__all__ = [
    "LAUNCHES",
    "MAX_GAP_IDS",
    "MAX_KERNEL_BINS",
    "CollisionKernelTables",
    "build_kernel_tables",
    "collision_step",
    "collision_step_analytic",
    "collision_step_analytic_plain",
    "collision_step_plain",
    "check_inputs",
    "count_launch",
]

#: launches of each collision kernel since import (or since the caller reset
#: it), and how many of them took a generation plane: ``collision_step`` is
#: K3 on a uniform gap, ``collision_step_gid`` K3 with per-pixel gap ids,
#: ``collision_step_analytic`` K4; ``collision_step_blocked[_gid]`` is K5
#: and ``collision_step_blocked_analytic`` K6 (``ops.collisions_blocked_cuda``);
#: ``collision_step_loop[_gid]`` is K8 and ``collision_step_rows`` K9, the
#: offset walks (``ops.collisions_loop_cuda``, ``ops.collisions_rows_cuda``),
#: which take no generation plane
LAUNCHES = {
    f"{name}{form}{gen}": 0
    for name in ("collision_step", "collision_step_blocked")
    for form in ("", "_gid", "_analytic")
    for gen in ("", "_with_gen")
} | {"collision_step_loop": 0, "collision_step_loop_gid": 0, "collision_step_rows": 0}

#: energy bins the kernels' per-thread arrays hold (kMaxBins in the source)
MAX_KERNEL_BINS = 64

#: unique gaps K3's gap-id tables take (the JAX package's table-blend bound);
#: more distinct gaps go to K4
MAX_GAP_IDS = 8

#: CSR code of a pair on its ω row: pair·4 + kind
EMISSION, ABSORPTION, RECOMBINATION = 0, 1, 2


@dataclass
class CollisionKernelTables:
    rho: torch.Tensor | None  # (G*NE,) state dtype; None on an analytic plan
    ks: torch.Tensor | None  # (G*NE*NE,) dE·K^s₀, None when scattering is off (or analytic)
    kr: torch.Tensor | None  # (G*NE*NE,) 2dE·K^r₀, None when recombination is off (or analytic)
    idx_diff: torch.Tensor  # (NE*NE,) int32
    idx_sum: torch.Tensor  # (NE*NE,) int32
    sign: torch.Tensor  # (NE*NE,) int8
    row_ptr: torch.Tensor  # (NW+1,) int32
    row_code: torch.Tensor  # (n_entries,) int32


def pair_rows(plan: CollisionPlan) -> tuple[np.ndarray, np.ndarray]:
    """(row_ptr, row_code): for each ω row the pairs whose rates land on it.

    Scattering pairs (i ≠ j) land on ``idx_diff[i, j]`` as emission
    (Eᵢ > Eⱼ) or absorption; recombination pairs on ``idx_sum[i, j]``.
    These are exactly the nonzero rows of the plain version's one-hot
    ``scatter_diff``/``scatter_sum`` products.
    """
    ne, nw = plan.num_energy_bins, plan.num_omega
    pair = np.arange(ne * ne, dtype=np.int64).reshape(ne, ne)
    rows, codes = [np.zeros(0, np.int64)], [np.zeros(0, np.int64)]
    if plan.enable_scattering:
        for kind, sel in ((EMISSION, plan.diff_sign_np > 0), (ABSORPTION, plan.diff_sign_np < 0)):
            rows.append(plan.idx_diff_np[sel].astype(np.int64))
            codes.append(pair[sel] * 4 + kind)
    if plan.enable_recombination:
        rows.append(plan.idx_sum_np.reshape(-1).astype(np.int64))
        codes.append(pair.reshape(-1) * 4 + RECOMBINATION)
    row = np.concatenate(rows)
    code = np.concatenate(codes)
    order = np.argsort(row, kind="stable")
    row_ptr = np.zeros(nw + 1, dtype=np.int32)
    row_ptr[1:] = np.cumsum(np.bincount(row, minlength=nw))
    return row_ptr, code[order].astype(np.int32)


def build_kernel_tables(plan: CollisionPlan) -> CollisionKernelTables:
    """The kernels' device tables for ``plan`` (on the plan's device and dtype).

    On an analytic plan (no per-gap tables) only the pair tables are built;
    :func:`collision_step_analytic` takes its constants from
    :class:`~qpsim_tpu_torch.ops.collisions.AnalyticTables`.
    """
    dev = plan.emit_mask.device
    ints = lambda a, t=torch.int32: torch.as_tensor(np.ascontiguousarray(a).reshape(-1), dtype=t, device=dev)
    flat = lambda t: t.reshape(-1).contiguous()
    row_ptr, row_code = pair_rows(plan)
    gather = plan.rho is not None
    if gather and plan.num_gaps > MAX_GAP_IDS:
        raise ValueError(
            f"{plan.num_gaps} unique gaps: the gap-id kernel takes at most {MAX_GAP_IDS} "
            "(continuous gap maps run the analytic kernel)"
        )
    dtype = plan.emit_mask.dtype
    return CollisionKernelTables(
        rho=flat(plan.rho) if gather else None,
        ks=flat((plan.K_s0.double() * plan.dE).to(dtype))
        if gather and plan.enable_scattering else None,
        kr=flat((plan.K_r0.double() * (2.0 * plan.dE)).to(dtype))
        if gather and plan.enable_recombination else None,
        idx_diff=ints(plan.idx_diff_np),
        idx_sum=ints(plan.idx_sum_np),
        sign=ints(plan.diff_sign_np, torch.int8),
        row_ptr=ints(row_ptr),
        row_code=ints(row_code),
    )


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def check_inputs(plan, n_qp, n_ph, gen, named_tables, max_bins: int) -> None:
    """Refuse a collision kernel's inputs that do not match ``plan``: shapes,
    dtype, device, contiguity of the states, ``gen`` and ``named_tables``
    ((name, tensor) pairs, None skipped), and more than ``max_bins`` bins."""
    if not plan.active:
        raise ValueError("collision kernel called with no collision channel enabled")
    if n_qp.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"collision kernel takes float32 or float64, got {n_qp.dtype}")
    ne, nw = plan.num_energy_bins, plan.num_omega
    if ne > max_bins:
        raise ValueError(f"collision kernel holds at most {max_bins} bins, got {ne}")
    if n_qp.ndim != 3 or n_qp.shape[0] != ne:
        raise ValueError(f"n_qp must be ({ne}, Ny, Nx), got {tuple(n_qp.shape)}")
    if tuple(n_ph.shape) != (nw, *n_qp.shape[1:]):
        raise ValueError(f"n_ph must be ({nw}, Ny, Nx), got {tuple(n_ph.shape)}")
    if gen is not None and tuple(gen.shape) != tuple(n_qp.shape[1:]):
        raise ValueError(f"gen must be (Ny, Nx), got {tuple(gen.shape)}")
    for name, t in (("n_qp", n_qp), ("n_ph", n_ph), ("gen", gen), *named_tables):
        if t is None:
            continue
        if t.device != n_qp.device:
            raise ValueError(f"{name} is on {t.device}, the state on {n_qp.device}")
        if t.dtype != n_qp.dtype:
            raise TypeError(f"{name} is {t.dtype}, the state {n_qp.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _outputs(plan, n_qp, n_ph):
    q_out = torch.empty_like(n_qp)
    ph_out = torch.empty_like(n_ph) if plan.update_phonons else n_ph
    return q_out, ph_out


def _pair_ptrs(tables: CollisionKernelTables) -> list:
    return [_ptr(t) for t in (tables.idx_diff, tables.idx_sum, tables.sign, tables.row_ptr, tables.row_code)]


def count_launch(name: str, gen) -> None:
    """Count one launch of ``name`` in :data:`LAUNCHES` (and of ``name_with_gen`` with a gen plane)."""
    LAUNCHES[name] += 1
    LAUNCHES[f"{name}_with_gen"] += gen is not None


def _suffix(n_qp: torch.Tensor) -> str:
    return "f32" if n_qp.dtype == torch.float32 else "f64"


def _table_step(plan: CollisionPlan, tables: CollisionKernelTables, n_qp, n_ph, dt: float, gen):
    """Launch K3 (``qp_collision_step[_gid]_<f32|f64>``) on CUDA tensors."""
    if n_qp.device.type != "cuda":
        raise ValueError(f"collision kernel runs on CUDA tensors, got {n_qp.device}")
    if tables.rho is None:
        raise ValueError("an analytic plan runs the analytic collision kernel")
    check_inputs(plan, n_qp, n_ph, gen,
                  (("rho", tables.rho), ("ks", tables.ks), ("kr", tables.kr)), MAX_KERNEL_BINS)
    n_pix = n_qp.shape[1] * n_qp.shape[2]
    gid = plan.gap_id
    if gid is not None and (gid.device != n_qp.device or gid.numel() != n_pix
                            or gid.dtype != torch.uint8 or not gid.is_contiguous()):
        raise ValueError(f"gap ids must be {n_pix} contiguous uint8 entries on {n_qp.device}")
    lib = load_kernels()
    q_out, ph_out = _outputs(plan, n_qp, n_ph)
    head = [_ptr(n_qp), _ptr(n_ph), _ptr(gen), _ptr(q_out),
            _ptr(ph_out) if plan.update_phonons else None]
    tail = [_ptr(tables.rho), _ptr(tables.ks), _ptr(tables.kr), *_pair_ptrs(tables),
            plan.num_energy_bins, plan.num_omega, n_pix, float(dt),
            int(plan.update_phonons), torch.cuda.current_stream(n_qp.device).cuda_stream]
    name = "collision_step" if gid is None else "collision_step_gid"
    if gid is None:
        err = getattr(lib, f"qp_collision_step_{_suffix(n_qp)}")(*head, *tail)
    else:
        err = getattr(lib, f"qp_collision_step_gid_{_suffix(n_qp)}")(*head, _ptr(gid), *tail)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {err}")
    count_launch(name, gen)
    return q_out, ph_out


def _analytic_step(plan: CollisionPlan, analytic: AnalyticTables, tables: CollisionKernelTables,
                   n_qp, n_ph, dt: float, gen):
    """Launch K4 (``qp_collision_step_analytic_<f32|f64>``) on CUDA tensors."""
    if n_qp.device.type != "cuda":
        raise ValueError(f"collision kernel runs on CUDA tensors, got {n_qp.device}")
    a = analytic
    check_inputs(plan, n_qp, n_ph, gen, (
        ("g2", a.g2), ("E", a.E), ("inv_E", a.inv_E), ("e2", a.e2), ("zi", a.zi),
        ("dEa_s", a.dEa_s), ("dEb_s", a.dEb_s), ("dEa2_r", a.dEa2_r), ("dEb2_r", a.dEb2_r)),
        MAX_KERNEL_BINS)
    n_pix = n_qp.shape[1] * n_qp.shape[2]
    if a.g2.numel() != n_pix:
        raise ValueError(f"the Δ² plane holds {a.g2.numel()} pixels, the state {n_pix}")
    lib = load_kernels()
    fn = getattr(lib, f"qp_collision_step_analytic_{_suffix(n_qp)}")
    q_out, ph_out = _outputs(plan, n_qp, n_ph)
    scat, rec = plan.enable_scattering, plan.enable_recombination
    err = fn(
        _ptr(n_qp), _ptr(n_ph), _ptr(gen), _ptr(q_out),
        _ptr(ph_out) if plan.update_phonons else None,
        _ptr(a.g2), _ptr(a.E), _ptr(a.inv_E), _ptr(a.e2), _ptr(a.zi),
        _ptr(a.dEa_s) if scat else None, _ptr(a.dEb_s) if scat else None,
        _ptr(a.dEa2_r) if rec else None, _ptr(a.dEb2_r) if rec else None,
        *_pair_ptrs(tables),
        plan.num_energy_bins, plan.num_omega, n_pix, float(dt), float(a.gamma),
        int(plan.update_phonons), torch.cuda.current_stream(n_qp.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"collision_step_analytic kernel launch failed with CUDA error {err}")
    count_launch("collision_step_analytic", gen)
    return q_out, ph_out


def collision_step(
    plan: CollisionPlan,
    tables: CollisionKernelTables,
    n_qp: torch.Tensor,
    n_ph: torch.Tensor,
    dt: float,
    gen: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One collision substep through K3 (plain version on the CPU).

    Same contract as :func:`collision_step_plain`: (NE, Ny, Nx) and
    (NW, Ny, Nx) states in, new states out (inputs untouched), ``gen`` an
    optional (Ny, Nx) plane of dt·g added to every bin first.  A plan with
    per-pixel gap ids launches the gap-id form (``collision_step_gid``),
    which reads the plan's uint8 ``gap_id`` plane.
    """
    if n_qp.device.type == "cpu":
        return collision_step_plain(plan, n_qp, n_ph, dt, gen)
    return _table_step(plan, tables, n_qp, n_ph, dt, gen)


def collision_step_analytic(
    plan: CollisionPlan,
    analytic: AnalyticTables,
    tables: CollisionKernelTables,
    n_qp: torch.Tensor,
    n_ph: torch.Tensor,
    dt: float,
    gen: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One analytic-gap collision substep through K4 (plain version on the CPU).

    Same contract as :func:`collision_step_analytic_plain`; ``tables`` are
    the plan's pair tables (:func:`build_kernel_tables`).
    """
    if n_qp.device.type == "cpu":
        return collision_step_analytic_plain(plan, analytic, n_qp, n_ph, dt, gen)
    return _analytic_step(plan, analytic, tables, n_qp, n_ph, dt, gen)
