"""The separable ADI step on the card: wrappers of the CUDA kernels ``csrc/adi_sep.cu``.

Port of ``qpsim_tpu.ops.pallas_adi_sep.build_pallas_adi_sep_step``
(kernels ``_make_sep_x_kernel`` and ``_make_sep_y_kernel``, body
``_prefactored_sweep``): one Peaceman–Rachford step for a separable
operator, each half forming its rhs from the 1D stencil vectors and
solving along its implicit direction with the host-prefactored Wang packs
of :class:`~qpsim_tpu_torch.ops.adi_sep.SepFactors`.  NB = 1 is the scalar
path, NB > 1 the multi-bin form (one pack per bin).

:func:`adi_sep_x` and :func:`adi_sep_y` launch one kernel each for CUDA
tensors and run their plain PyTorch versions (:func:`adi_sep_x_half_plain`,
:func:`adi_sep_y_half_plain`: the same sweeps, vectorised over lines and
chunks, with a Python loop over the chunk rows and the chunks) for CPU
tensors; they never fall back.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils.cuda_build import load_kernels, refuse_grad
from .adi_sep import SepFactors

__all__ = [
    "LAUNCHES",
    "adi_sep_x",
    "adi_sep_y",
    "adi_sep_step",
    "adi_sep_x_half_plain",
    "adi_sep_y_half_plain",
    "adi_sep_step_plain",
    "kernel_plan",
]

#: launches of each half-step kernel since import (or since the caller reset it)
LAUNCHES = {"adi_sep_x": 0, "adi_sep_y": 0}


def _prefactored_solve(d: torch.Tensor, pack: torch.Tensor, ifc: torch.Tensor) -> torch.Tensor:
    """Wang solve of (NB, lines, n) rhs along the last axis with per-bin packs.

    ``pack`` (NB, 5, M, K) = [a_rt, inv, cp, A, C], ``ifc`` (NB, K, 6) =
    [aL, invI, aR, arw, q, w]; the recurrences of ``_wang_prefactor_1d``.
    """
    nb, lines, n = d.shape
    m, k = pack.shape[2], pack.shape[3]
    d = d.reshape(nb, lines, k, m).clone()  # [..., c, i] is position c·M + i
    row = lambda f, i: pack[:, f, i, :].unsqueeze(1)  # (NB, 1, K)
    dp = d[..., 0] * row(1, 0)
    d[..., 0] = dp
    for i in range(1, m):
        dp = (d[..., i] - row(0, i) * dp) * row(1, i)
        d[..., i] = dp
    D = dp
    for i in range(m - 2, -1, -1):
        D = d[..., i] - row(2, i) * D
        d[..., i] = D
    coef = lambda j, f: ifc[:, j, f].unsqueeze(1)  # (NB, 1)
    g = torch.zeros((nb, lines), dtype=d.dtype, device=d.device)
    ps, gs = [], []
    for j in range(k):
        p = (d[:, :, j, 0] - coef(j, 0) * g) * coef(j, 1)
        g = d[:, :, j, m - 1] - coef(j, 2) * g + coef(j, 3) * p
        ps.append(p)
        gs.append(g)
    l_next = torch.zeros_like(g)
    ls, rs = [None] * k, [None] * k
    for j in range(k - 1, -1, -1):
        ls[j] = ps[j] - coef(j, 4) * l_next
        rs[j] = gs[j] - coef(j, 5) * l_next
        l_next = ls[j]
    zero = torch.zeros_like(g)
    x_left = torch.stack([zero] + rs[:-1], dim=-1).unsqueeze(-1)  # (NB, lines, K, 1)
    x_right = torch.stack(ls[1:] + [zero], dim=-1).unsqueeze(-1)
    field = lambda f: pack[:, f].transpose(1, 2).unsqueeze(1)  # (NB, 1, K, M)
    return (d - field(3) * x_left - field(4) * x_right).reshape(nb, lines, n)


def adi_sep_x_half_plain(u: torch.Tensor, f: SepFactors) -> torch.Tensor:
    """x-implicit half: rhs from the y vectors, Wang solve along x.

    roll wraps around, but the lo vector is zero on the first line and the
    hi vector on the last, so the wrapped neighbours are multiplied by zero.
    """
    yv = f.yv.unsqueeze(-1)  # (NB, 4, Ny, 1)
    rhs = u + yv[:, 0] * torch.roll(u, 1, 1) + yv[:, 1] * torch.roll(u, -1, 1) + yv[:, 2] * u
    rhs = rhs + yv[:, 3] + f.xv[:, 3].unsqueeze(1)
    return _prefactored_solve(rhs, f.facx, f.ifx).contiguous()


def adi_sep_y_half_plain(v: torch.Tensor, f: SepFactors) -> torch.Tensor:
    """y-implicit half: rhs from the x vectors, Wang solve along y."""
    xv = f.xv.unsqueeze(2)  # (NB, 4, 1, Nx)
    rhs = v + xv[:, 0] * torch.roll(v, 1, 2) + xv[:, 1] * torch.roll(v, -1, 2) + xv[:, 2] * v
    rhs = rhs + xv[:, 3] + f.yv[:, 3].unsqueeze(2)
    out = _prefactored_solve(rhs.transpose(1, 2), f.facy, f.ify)
    return out.transpose(1, 2).contiguous()


def adi_sep_step_plain(u: torch.Tensor, f: SepFactors) -> torch.Tensor:
    """One separable Peaceman–Rachford ADI step (plain PyTorch)."""
    return adi_sep_y_half_plain(adi_sep_x_half_plain(u, f), f)


def _launch(half: str, u: torch.Tensor, f: SepFactors) -> torch.Tensor:
    if u.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"separable ADI kernel takes float32 or float64, got {u.dtype}")
    shape = (f.num_bins, *f.grid_shape)
    if tuple(u.shape) != shape:
        raise ValueError(f"state must be {shape}, got {tuple(u.shape)}")
    if not u.is_contiguous():
        raise ValueError("state must be contiguous")
    fac, ifc = (f.facx, f.ifx) if half == "x" else (f.facy, f.ify)
    for t in (f.xv, f.yv, fac, ifc):
        if t.device != u.device or t.dtype != u.dtype or not t.is_contiguous():
            raise ValueError("separable ADI factors must be contiguous, on the state's device and dtype")
    nb, ny, nx = shape
    lib = load_kernels()
    fn = getattr(lib, f"qp_adi_sep_{half}_{'f32' if u.dtype == torch.float32 else 'f64'}")
    out = torch.empty_like(u)
    err = fn(
        u.data_ptr(), out.data_ptr(), f.xv.data_ptr(), f.yv.data_ptr(), fac.data_ptr(),
        ifc.data_ptr(), nb, ny, nx, int(fac.shape[3]),
        torch.cuda.current_stream(u.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"separable ADI {half}-half kernel launch failed with CUDA error {err}")
    LAUNCHES[f"adi_sep_{half}"] += 1
    return out


def kernel_plan(half: str, dtype: torch.dtype, nb: int, ny: int, nx: int, k: int) -> dict:
    """How K1's ``half`` launches on the current card for an (nb, ny, nx)
    state solved in ``k`` Wang chunks: ``tl`` lines per block, ``w`` chunks
    of a line held at once (``w < k``: the two-pass form for long lines),
    ``pitch``, ``smem`` dynamic shared bytes per block, ``blocks``, ``waves``.
    Raises when the kernel does not take the shape.  Needs the card.
    """
    out = (ctypes.c_int * 6)()
    err = load_kernels().qp_adi_sep_plan(int(half == "x"), torch.finfo(dtype).bits // 8, nb, ny,
                                         nx, k, out)
    if err != 0:
        raise ValueError(f"the separable ADI {half}-half kernel does not take {nb}x{ny}x{nx} {dtype}")
    return dict(zip(("tl", "w", "pitch", "smem", "blocks", "waves"), out))


def adi_sep_x(u: torch.Tensor, f: SepFactors) -> torch.Tensor:
    """x half through the CUDA kernel (plain version on the CPU)."""
    refuse_grad("the separable ADI kernel (K1)", "ops.adi_sep_cuda.adi_sep_x_half_plain", u)
    if u.device.type == "cpu":
        return adi_sep_x_half_plain(u, f)
    if u.device.type != "cuda":
        raise ValueError(f"separable ADI kernel runs on CUDA tensors, got {u.device}")
    return _launch("x", u, f)


def adi_sep_y(v: torch.Tensor, f: SepFactors) -> torch.Tensor:
    """y half through the CUDA kernel (plain version on the CPU)."""
    refuse_grad("the separable ADI kernel (K1)", "ops.adi_sep_cuda.adi_sep_y_half_plain", v)
    if v.device.type == "cpu":
        return adi_sep_y_half_plain(v, f)
    if v.device.type != "cuda":
        raise ValueError(f"separable ADI kernel runs on CUDA tensors, got {v.device}")
    return _launch("y", v, f)


def adi_sep_step(u: torch.Tensor, f: SepFactors) -> torch.Tensor:
    """One separable ADI step: two kernel launches on CUDA tensors."""
    return adi_sep_y(adi_sep_x(u, f), f)
