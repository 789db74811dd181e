"""The collision substep on the card: wrapper of the CUDA kernel ``csrc/collisions.cu``.

Port of ``qpsim_tpu.ops.pallas_collisions.build_pallas_collision_step``
(kernel ``_make_kernel``) for a uniform gap.  :func:`collision_step` takes
the same arguments as the plain version
(:func:`qpsim_tpu_torch.ops.collisions.collision_step_plain`) plus the
kernel's tables.  For tensors on the CPU it runs that plain version; for
CUDA tensors it launches the kernel or raises — it never falls back.

The kernel reads the physics from small device tables built once per plan
(:func:`build_kernel_tables`): ρ, dE·K^s₀, 2dE·K^r₀, the per-pair ω maps
``idx_diff``/``idx_sum``, sign(Eᵢ − Eⱼ), and for every ω row the list of
pairs that land on it (``row_ptr``/``row_code``, CSR), so the phonon rates
are gathered per row instead of scattered into a per-pixel array.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..utils.cuda_build import load_kernels
from .collisions import CollisionPlan, collision_step_plain

__all__ = [
    "LAUNCHES",
    "MAX_KERNEL_BINS",
    "CollisionKernelTables",
    "build_kernel_tables",
    "collision_step",
    "collision_step_plain",
]

#: launches of the collision kernel since import (or since the caller reset
#: it), and how many of them took a generation plane
LAUNCHES = {"collision_step": 0, "collision_step_with_gen": 0}

#: energy bins the kernel's per-thread arrays hold (kMaxBins in the source)
MAX_KERNEL_BINS = 64

#: CSR code of a pair on its ω row: pair·4 + kind
EMISSION, ABSORPTION, RECOMBINATION = 0, 1, 2


@dataclass
class CollisionKernelTables:
    rho: torch.Tensor  # (NE,) state dtype
    ks: torch.Tensor | None  # (NE*NE,) dE·K^s₀, None when scattering is off
    kr: torch.Tensor | None  # (NE*NE,) 2dE·K^r₀, None when recombination is off
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
    """The kernel's device tables for ``plan`` (on the plan's device and dtype)."""
    dev, dtype = plan.rho.device, plan.rho.dtype
    ints = lambda a, t=torch.int32: torch.as_tensor(np.ascontiguousarray(a).reshape(-1), dtype=t, device=dev)
    row_ptr, row_code = pair_rows(plan)
    return CollisionKernelTables(
        rho=plan.rho.contiguous(),
        ks=(plan.K_s0.double() * plan.dE).to(dtype).reshape(-1).contiguous()
        if plan.enable_scattering else None,
        kr=(plan.K_r0.double() * (2.0 * plan.dE)).to(dtype).reshape(-1).contiguous()
        if plan.enable_recombination else None,
        idx_diff=ints(plan.idx_diff_np),
        idx_sum=ints(plan.idx_sum_np),
        sign=ints(plan.diff_sign_np, torch.int8),
        row_ptr=ints(row_ptr),
        row_code=ints(row_code),
    )


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _check_inputs(plan, tables, n_qp, n_ph, gen) -> None:
    if not plan.active:
        raise ValueError("collision kernel called with no collision channel enabled")
    if n_qp.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"collision kernel takes float32 or float64, got {n_qp.dtype}")
    ne, nw = plan.num_energy_bins, plan.num_omega
    if ne > MAX_KERNEL_BINS:
        raise ValueError(f"collision kernel holds at most {MAX_KERNEL_BINS} bins, got {ne}")
    if n_qp.ndim != 3 or n_qp.shape[0] != ne:
        raise ValueError(f"n_qp must be ({ne}, Ny, Nx), got {tuple(n_qp.shape)}")
    if tuple(n_ph.shape) != (nw, *n_qp.shape[1:]):
        raise ValueError(f"n_ph must be ({nw}, Ny, Nx), got {tuple(n_ph.shape)}")
    if gen is not None and tuple(gen.shape) != tuple(n_qp.shape[1:]):
        raise ValueError(f"gen must be (Ny, Nx), got {tuple(gen.shape)}")
    for name, t in (("n_qp", n_qp), ("n_ph", n_ph), ("gen", gen), ("rho", tables.rho),
                    ("ks", tables.ks), ("kr", tables.kr)):
        if t is None:
            continue
        if t.device != n_qp.device:
            raise ValueError(f"{name} is on {t.device}, the state on {n_qp.device}")
        if t.dtype != n_qp.dtype:
            raise TypeError(f"{name} is {t.dtype}, the state {n_qp.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def collision_step(
    plan: CollisionPlan,
    tables: CollisionKernelTables,
    n_qp: torch.Tensor,
    n_ph: torch.Tensor,
    dt: float,
    gen: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One collision substep through the CUDA kernel (plain version on the CPU).

    Same contract as :func:`collision_step_plain`: (NE, Ny, Nx) and
    (NW, Ny, Nx) states in, new states out (inputs untouched), ``gen`` an
    optional (Ny, Nx) plane of dt·g added to every bin first.
    """
    if n_qp.device.type == "cpu":
        return collision_step_plain(plan, n_qp, n_ph, dt, gen)
    if n_qp.device.type != "cuda":
        raise ValueError(f"collision kernel runs on CUDA tensors, got {n_qp.device}")
    _check_inputs(plan, tables, n_qp, n_ph, gen)
    lib = load_kernels()
    fn = lib.qp_collision_step_f32 if n_qp.dtype == torch.float32 else lib.qp_collision_step_f64
    q_out = torch.empty_like(n_qp)
    ph_out = torch.empty_like(n_ph) if plan.update_phonons else n_ph
    n_pix = n_qp.shape[1] * n_qp.shape[2]
    err = fn(
        _ptr(n_qp), _ptr(n_ph), _ptr(gen), _ptr(q_out),
        _ptr(ph_out) if plan.update_phonons else None,
        _ptr(tables.rho), _ptr(tables.ks), _ptr(tables.kr),
        _ptr(tables.idx_diff), _ptr(tables.idx_sum), _ptr(tables.sign),
        _ptr(tables.row_ptr), _ptr(tables.row_code),
        plan.num_energy_bins, plan.num_omega, n_pix, float(dt),
        int(plan.update_phonons), torch.cuda.current_stream(n_qp.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"collision kernel launch failed with CUDA error {err}")
    LAUNCHES["collision_step"] += 1
    LAUNCHES["collision_step_with_gen"] += gen is not None
    return q_out, ph_out
