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

It also ports the unfused pair (K7, ``csrc/adi_lines.cu``), explicit entry
points of the JAX package: :func:`solve_lines` (``solve_lines_pallas``, its
kernels ``_make_wang_kernel`` and ``_make_kernel``) solves one direction's
CN lines along the middle axis of an (NB, N, B) array, and
:func:`build_adi_step` (``build_pallas_adi_step``) makes a step of two
such solves with the rhs stencils and the layout swaps as torch glue.
Their plain versions are :func:`solve_lines_plain` and
:func:`build_adi_step_plain`.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from functools import partial

import numpy as np
import torch

from ..utils.cuda_build import load_kernels, refuse_grad
from .adi_sep import pick_chunks
from .diffusion import SplitOperator
from .tridiag import tridiag_solve_along, tridiag_solve_thomas, tridiag_solve_wang

__all__ = [
    "LAUNCHES",
    "AdiPlanes",
    "adi_x_half",
    "adi_y_half",
    "adi_step",
    "adi_x_half_plain",
    "adi_y_half_plain",
    "adi_step_plain",
    "kernel_plan",
    "solve_lines",
    "solve_lines_plain",
    "build_adi_step",
    "build_adi_step_plain",
]

#: launches of each half-step kernel (K2) and of the line solve (K7,
#: ``adi_lines``) since import (or since the caller reset it)
LAUNCHES = {"adi_x_half": 0, "adi_y_half": 0, "adi_lines": 0}


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

    def tensors(self) -> tuple[torch.Tensor, ...]:
        return (self.ax_lo, self.ax_hi, self.ax_diag, self.ay_lo, self.ay_hi, self.ay_diag,
                self.src, self.scale)


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

    ``solve`` is the Thomas solve unless a caller hands in another (the
    kernel eliminates the same system in Wang chunks, which agrees to
    roundoff); returns a contiguous tensor, like the kernel (which takes
    only those).
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
    err = fn(
        u.data_ptr(), out.data_ptr(),
        *(t.data_ptr() for t in (x_planes if half == "x" else y_planes)),
        planes.scale.data_ptr(), nb, nbp, ny, nx, pick_chunks(nx if half == "x" else ny),
        float(alpha), torch.cuda.current_stream(u.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"ADI {half}-half kernel launch failed with CUDA error {err}")
    LAUNCHES[f"adi_{half}_half"] += 1
    return out


def kernel_plan(half: str, dtype: torch.dtype, nb: int, ny: int, nx: int) -> dict:
    """How K2's ``half`` launches on the current card for an (nb, ny, nx) state.

    ``tl`` lines per block, ``w`` chunks of a line held at once (``w < k``:
    the two-pass form for long lines), ``pitch`` the shared-memory chunk
    pitch, ``smem`` dynamic shared bytes per block, ``blocks``, ``waves``
    and ``k`` the Wang chunk count launched: ``pick_chunks`` of the line
    length, raised to 32 on lines of 256 cells or more and further where
    one chunk would not fit in shared memory (the last chunk padded with
    identity rows).  Raises when the kernel does not take the shape.  Needs
    the card (it reads its limits).
    """
    out = (ctypes.c_int * 7)()
    k = pick_chunks(nx if half == "x" else ny)
    err = load_kernels().qp_adi_plan(int(half == "x"), torch.finfo(dtype).bits // 8, nb, ny, nx, k,
                                     out)
    if err != 0:
        raise ValueError(f"the ADI {half}-half kernel does not take {nb}x{ny}x{nx} {dtype}")
    return dict(zip(("tl", "w", "pitch", "smem", "blocks", "waves", "k"), out))


def adi_x_half(u: torch.Tensor, planes: AdiPlanes, alpha: float) -> torch.Tensor:
    """x half through the CUDA kernel (plain version on the CPU)."""
    refuse_grad("the fused ADI kernel (K2)", "ops.adi_cuda.adi_x_half_plain", u, *planes.tensors())
    if u.device.type == "cpu":
        return adi_x_half_plain(u, planes, alpha)
    if u.device.type != "cuda":
        raise ValueError(f"ADI kernel runs on CUDA tensors, got {u.device}")
    return _launch("x", u, planes, alpha)


def adi_y_half(v: torch.Tensor, planes: AdiPlanes, alpha: float) -> torch.Tensor:
    """y half through the CUDA kernel (plain version on the CPU)."""
    refuse_grad("the fused ADI kernel (K2)", "ops.adi_cuda.adi_y_half_plain", v, *planes.tensors())
    if v.device.type == "cpu":
        return adi_y_half_plain(v, planes, alpha)
    if v.device.type != "cuda":
        raise ValueError(f"ADI kernel runs on CUDA tensors, got {v.device}")
    return _launch("y", v, planes, alpha)


def adi_step(u: torch.Tensor, planes: AdiPlanes, alpha: float) -> torch.Tensor:
    """One Peaceman–Rachford ADI step with α = dt/2: two kernel launches on CUDA tensors."""
    return adi_y_half(adi_x_half(u, planes, alpha), planes, alpha)


# ---------------------------------------------------------------- K7: the unfused pair


def _line_chunks(n: int, chunks: int | None) -> int:
    k = pick_chunks(n) if chunks is None else int(chunks)
    if k < 1 or n % k:
        raise ValueError(f"{k} Wang chunks do not divide lines of {n}")
    return k


def solve_lines_plain(rhs, lo, di, hi, scale, *, alpha: float, chunks: int | None = None):
    """(I − α·s_b·L) x = rhs along axis −2 in plain PyTorch: the Thomas solve
    at K = 1, the Wang partition into K chunks of N/K rows otherwise."""
    k = _line_chunks(rhs.shape[-2], chunks)
    a_s = (alpha * scale).reshape(-1, 1, 1)
    solve = tridiag_solve_thomas if k == 1 else partial(tridiag_solve_wang, chunk=rhs.shape[-2] // k)
    return tridiag_solve_along(-2, -a_s * lo, 1.0 - a_s * di, -a_s * hi, rhs, solve=solve).contiguous()


def solve_lines(rhs: torch.Tensor, lo: torch.Tensor, di: torch.Tensor, hi: torch.Tensor,
                scale: torch.Tensor, *, alpha: float, chunks: int | None = None) -> torch.Tensor:
    """Solve (I − α·s_b·L_d) x = rhs along axis −2, batched over bins × lines (K7).

    ``rhs`` (NB, N, B); ``lo``/``di``/``hi`` (NBp, N, B), NBp ∈ {1, NB}, the
    direction's geometry planes; ``scale`` (NB,) the per-bin D factor (ones
    when the planes carry D).  ``chunks`` is the Wang chunk count K (it must
    divide N; ``None`` takes the largest of 32, 16, 8, 4, 2 with N/K ≥ 8,
    else 1, the Thomas solve).  On the card K rises to 32 on lines of 256
    cells or more, and further where one chunk would not fit in shared
    memory, the last chunk padded with identity rows: a result that agrees
    with the asked-for solve to roundoff.  Zero coefficient rows
    decouple exactly; any B works.  CUDA tensors launch the kernel (counted
    as ``adi_lines``) or raise; CPU tensors run :func:`solve_lines_plain`.
    """
    refuse_grad("the line-solve kernel (K7)", "ops.adi_cuda.solve_lines_plain", rhs, lo, di, hi, scale)
    if rhs.device.type == "cpu":
        return solve_lines_plain(rhs, lo, di, hi, scale, alpha=alpha, chunks=chunks)
    if rhs.device.type != "cuda":
        raise ValueError(f"line-solve kernel runs on CUDA tensors, got {rhs.device}")
    if rhs.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"line-solve kernel takes float32 or float64, got {rhs.dtype}")
    if rhs.ndim != 3:
        raise ValueError(f"rhs must be (NB, N, B), got {tuple(rhs.shape)}")
    nb, n, batch = rhs.shape
    nbp = lo.shape[0]
    for name, t in (("lo", lo), ("di", di), ("hi", hi)):
        if tuple(t.shape) != (nbp, n, batch) or nbp not in (1, nb):
            raise ValueError(f"{name} must be (1 or {nb}, {n}, {batch}), got {tuple(t.shape)}")
    if tuple(scale.shape) != (nb,):
        raise ValueError(f"scale must be ({nb},), got {tuple(scale.shape)}")
    for t in (rhs, lo, di, hi, scale):
        if t.device != rhs.device or t.dtype != rhs.dtype or not t.is_contiguous():
            raise ValueError("rhs, the planes and scale must be contiguous, on one device and dtype")
    k = _line_chunks(n, chunks)
    if k > 256:
        raise ValueError(f"the line-solve kernel takes at most 256 chunks, got {k}")
    out = torch.empty_like(rhs)
    lib = load_kernels()
    fn = lib.qp_adi_lines_f32 if rhs.dtype == torch.float32 else lib.qp_adi_lines_f64
    err = fn(
        rhs.data_ptr(), lo.data_ptr(), di.data_ptr(), hi.data_ptr(), scale.data_ptr(),
        out.data_ptr(), nb, nbp, n, batch, k, float(alpha),
        torch.cuda.current_stream(rhs.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"line-solve kernel launch failed with CUDA error {err}")
    LAUNCHES["adi_lines"] += 1
    return out


def _build_lines_step(op: SplitOperator, dt: float, dtype, chunks, device, solve):
    alpha = 0.5 * float(dt)
    as_dev = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=dtype, device=device)
    # natural-layout y planes; x planes and the source swapped, (NBp, Nx, Ny)
    ay_lo, ay_hi, ay_diag = as_dev(op.ay_lo), as_dev(op.ay_hi), as_dev(op.ay_diag)
    swap = lambda a: as_dev(a).transpose(-1, -2).contiguous()
    axT_lo, axT_hi, axT_diag = swap(op.ax_lo), swap(op.ax_hi), swap(op.ax_diag)
    src = as_dev(op.source_total())
    srcT = src.transpose(-1, -2)
    if op.bin_scale is not None:
        scale = as_dev(np.asarray(op.bin_scale).reshape(-1))
        sc3 = as_dev(op.bin_scale)  # (NB, 1, 1): the lazy factor of the stencils
        sy = (sc3 * ay_lo, sc3 * ay_hi, sc3 * ay_diag)
        sxT = (sc3 * axT_lo, sc3 * axT_hi, sc3 * axT_diag)
        s_nat, s_T = sc3 * src, sc3 * srcT
    else:
        scale = torch.ones(op.num_bins, dtype=dtype, device=device)
        sy, sxT, s_nat, s_T = (ay_lo, ay_hi, ay_diag), (axT_lo, axT_hi, axT_diag), src, srcT

    def step(state: torch.Tensor) -> torch.Tensor:
        u = state.to(dtype)
        # x-implicit half: (I − αLx) u* = u + α·Ly u + α·s, solved in the
        # swapped layout so the x lines run along the middle axis
        rhs = u + alpha * _apply_dir(u, *sy, -2) + alpha * s_nat
        uT = solve(rhs.transpose(-1, -2).contiguous(), axT_lo, axT_diag, axT_hi, scale,
                   alpha=alpha, chunks=chunks)
        # y-implicit half: (I − αLy) u⁺ = u* + α·Lx u* + α·s
        rhs2T = uT + alpha * _apply_dir(uT, *sxT, -2) + alpha * s_T
        return solve(rhs2T.transpose(-1, -2).contiguous(), ay_lo, ay_diag, ay_hi, scale,
                     alpha=alpha, chunks=chunks).to(state.dtype)

    return step


def build_adi_step(op: SplitOperator, dt: float, dtype=torch.float32, *, chunks: int | None = None,
                   device="cuda"):
    """``step(state) -> state``: one PR-ADI CN step through two :func:`solve_lines` launches.

    The port of ``build_pallas_adi_step``: the same splitting and systems as
    :func:`adi_step` (K2), for an operator with one shared plane set and a
    per-bin scale or with per-bin planes (``bin_scale`` None).  The rhs
    stencils and the layout swaps are torch glue, as they are XLA glue there.
    """
    return _build_lines_step(op, dt, dtype, chunks, device, solve_lines)


def build_adi_step_plain(op: SplitOperator, dt: float, dtype=torch.float32, *,
                         chunks: int | None = None, device="cuda"):
    """:func:`build_adi_step` on :func:`solve_lines_plain` (on any device)."""
    return _build_lines_step(op, dt, dtype, chunks, device, solve_lines_plain)
