"""The ADI diffusion step on the card: wrappers of the CUDA kernels ``csrc/adi.cu``.

Port of ``qpsim_tpu.ops.pallas_adi.build_pallas_adi_fused_step`` (kernels
``_make_fused_x_kernel`` and ``_make_fused_y_kernel``): one Peaceman–
Rachford step in two passes, each forming the explicit-direction rhs, the
Crank–Nicolson coefficients from the geometry planes × the per-bin scale,
and the implicit-direction tridiagonal solve.

:func:`adi_x_half` and :func:`adi_y_half` launch one kernel each for CUDA
tensors and run their plain PyTorch versions (:func:`adi_x_half_plain`,
:func:`adi_y_half_plain`) for CPU tensors; they never fall back.
:func:`adi_step` is the whole step, and :func:`adi_step_plain` its plain
version, which calls the Thomas solve directly; ``ADIDiffusion`` runs it
with the dispatching ``tridiag_solve`` instead.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..utils.cuda_build import load_kernels
from .diffusion import SplitOperator
from .tridiag import tridiag_solve_along, tridiag_solve_thomas

__all__ = [
    "LAUNCHES",
    "AdiPlanes",
    "adi_x_half",
    "adi_y_half",
    "adi_step",
    "adi_x_half_plain",
    "adi_y_half_plain",
    "adi_step_plain",
]

#: launches of each half-step kernel since import (or since the caller reset it)
LAUNCHES = {"adi_x_half": 0, "adi_y_half": 0}


@dataclass
class AdiPlanes:
    """A ``SplitOperator`` on the device: planes (NBp, Ny, Nx), NBp ∈ {1, NB}.

    ``scale`` (NB,) is the per-bin D(E) factor (``bin_scale``), applied
    lazily; ones when the planes already carry D.
    """

    ax_lo: torch.Tensor
    ax_hi: torch.Tensor
    ax_diag: torch.Tensor
    ay_lo: torch.Tensor
    ay_hi: torch.Tensor
    ay_diag: torch.Tensor
    src: torch.Tensor  # sx + sy
    scale: torch.Tensor

    @classmethod
    def from_operator(cls, op: SplitOperator, device, dtype: torch.dtype) -> "AdiPlanes":
        as_dev = lambda a: torch.as_tensor(
            np.ascontiguousarray(a, dtype=np.float64), dtype=dtype, device=device
        )
        scale = (
            np.ones(op.num_bins) if op.bin_scale is None else np.asarray(op.bin_scale).reshape(-1)
        )
        return cls(
            ax_lo=as_dev(op.ax_lo), ax_hi=as_dev(op.ax_hi), ax_diag=as_dev(op.ax_diag),
            ay_lo=as_dev(op.ay_lo), ay_hi=as_dev(op.ay_hi), ay_diag=as_dev(op.ay_diag),
            src=as_dev(op.source_total()), scale=as_dev(scale),
        )

    @property
    def num_bins(self) -> int:
        return int(self.scale.shape[0])


def _apply_dir(u, a_lo, a_hi, diag, dim: int):
    """L_d u along one direction: a_lo·u_prev + a_hi·u_next + diag·u.

    roll wraps around, but a_lo is zero on the first slice and a_hi on the
    last, so the wrapped values are multiplied by zero.
    """
    return a_lo * torch.roll(u, 1, dims=dim) + a_hi * torch.roll(u, -1, dims=dim) + diag * u


def _alpha_s(planes: AdiPlanes, alpha: float) -> torch.Tensor:
    return (alpha * planes.scale).reshape(-1, 1, 1)


def adi_x_half_plain(
    u: torch.Tensor, planes: AdiPlanes, alpha: float, solve=tridiag_solve_thomas
) -> torch.Tensor:
    """x-implicit half: (I − αs·Lx) u* = u + αs·(Ly u + src).

    ``solve`` is the Thomas solve (what the kernel computes) unless a
    caller hands in another; returns a contiguous tensor, like the kernel
    (which takes only those).
    """
    a_s = _alpha_s(planes, alpha)
    rhs = u + a_s * (_apply_dir(u, planes.ay_lo, planes.ay_hi, planes.ay_diag, -2) + planes.src)
    return solve(
        -a_s * planes.ax_lo, 1.0 - a_s * planes.ax_diag, -a_s * planes.ax_hi, rhs
    ).contiguous()


def adi_y_half_plain(
    v: torch.Tensor, planes: AdiPlanes, alpha: float, solve=tridiag_solve_thomas
) -> torch.Tensor:
    """y-implicit half: (I − αs·Ly) u⁺ = u* + αs·(Lx u* + src)."""
    a_s = _alpha_s(planes, alpha)
    rhs = v + a_s * (_apply_dir(v, planes.ax_lo, planes.ax_hi, planes.ax_diag, -1) + planes.src)
    return tridiag_solve_along(
        -2, -a_s * planes.ay_lo, 1.0 - a_s * planes.ay_diag, -a_s * planes.ay_hi, rhs, solve=solve
    ).contiguous()


def adi_step_plain(
    u: torch.Tensor, planes: AdiPlanes, alpha: float, solve=tridiag_solve_thomas
) -> torch.Tensor:
    """One Peaceman–Rachford ADI step with α = dt/2 (plain PyTorch)."""
    return adi_y_half_plain(adi_x_half_plain(u, planes, alpha, solve), planes, alpha, solve)


def _launch(half: str, u: torch.Tensor, planes: AdiPlanes, alpha: float) -> torch.Tensor:
    if u.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"ADI kernel takes float32 or float64, got {u.dtype}")
    if u.ndim != 3 or u.shape[0] != planes.num_bins:
        raise ValueError(f"state must be ({planes.num_bins}, Ny, Nx), got {tuple(u.shape)}")
    if not u.is_contiguous():
        raise ValueError("state must be contiguous")
    nb, ny, nx = u.shape
    nbp = planes.ax_lo.shape[0]
    x_planes = (planes.ay_lo, planes.ay_hi, planes.ay_diag, planes.src,
                planes.ax_lo, planes.ax_hi, planes.ax_diag)
    y_planes = (planes.ax_lo, planes.ax_hi, planes.ax_diag, planes.src,
                planes.ay_lo, planes.ay_hi, planes.ay_diag)
    for t in (*x_planes, planes.scale):
        if t.device != u.device or t.dtype != u.dtype or not t.is_contiguous():
            raise ValueError("ADI planes must be contiguous, on the state's device and dtype")
    for t in x_planes:
        if tuple(t.shape) != (nbp, ny, nx) or nbp not in (1, nb):
            raise ValueError(f"ADI planes must be (1 or {nb}, {ny}, {nx}), got {tuple(t.shape)}")
    lib = load_kernels()
    suffix = "f32" if u.dtype == torch.float32 else "f64"
    fn = getattr(lib, f"qp_adi_{half}_{suffix}")
    out = torch.empty_like(u)
    w_scratch = torch.empty_like(u)  # c′ of the Thomas sweep; d′ lives in ``out``
    err = fn(
        u.data_ptr(), out.data_ptr(), w_scratch.data_ptr(),
        *(t.data_ptr() for t in (x_planes if half == "x" else y_planes)),
        planes.scale.data_ptr(), nb, nbp, ny, nx, float(alpha),
        torch.cuda.current_stream(u.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"ADI {half}-half kernel launch failed with CUDA error {err}")
    LAUNCHES[f"adi_{half}_half"] += 1
    return out


def adi_x_half(u: torch.Tensor, planes: AdiPlanes, alpha: float) -> torch.Tensor:
    """x half through the CUDA kernel (plain version on the CPU)."""
    if u.device.type == "cpu":
        return adi_x_half_plain(u, planes, alpha)
    if u.device.type != "cuda":
        raise ValueError(f"ADI kernel runs on CUDA tensors, got {u.device}")
    return _launch("x", u, planes, alpha)


def adi_y_half(v: torch.Tensor, planes: AdiPlanes, alpha: float) -> torch.Tensor:
    """y half through the CUDA kernel (plain version on the CPU)."""
    if v.device.type == "cpu":
        return adi_y_half_plain(v, planes, alpha)
    if v.device.type != "cuda":
        raise ValueError(f"ADI kernel runs on CUDA tensors, got {v.device}")
    return _launch("y", v, planes, alpha)


def adi_step(u: torch.Tensor, planes: AdiPlanes, alpha: float) -> torch.Tensor:
    """One Peaceman–Rachford ADI step with α = dt/2: two kernel launches on CUDA tensors."""
    return adi_y_half(adi_x_half(u, planes, alpha), planes, alpha)
