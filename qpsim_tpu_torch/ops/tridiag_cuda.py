"""The batched tridiagonal solve on the card: wrapper of the CUDA kernel ``csrc/tridiag.cu``.

Port of ``qpsim_tpu.ops.pallas_tridiag.tridiag_solve_pallas`` (kernel
``_thomas_kernel``): T x = rhs along the last axis for every leading index,
``sub[..., 0]`` and ``sup[..., -1]`` ignored, zero couplings decoupling
intervals exactly, a line of one cell ``rhs / diag``.

The kernel is the shared-memory line solve of the ADI kernels in Wang
chunks, and it reads the four tensors where they lie, in one of two
layouts (:func:`layout_of`): "rows", every tensor contiguous (a plain
``tridiag_solve`` call, the ``adi`` backend's x half), or "cols", every
tensor the ``movedim(-2, -1)`` view of a contiguous (..., N, B) tensor
(``tridiag_solve_along(-2, ...)``, the ``adi`` backend's y half), whose
solution it writes with rhs's strides, so that moving the axis back
copies nothing.  Any other layout (a broadcast, mixed layouts, other
strides) is copied once into rows.

:func:`thomas` is :class:`ThomasSolve`: it launches the kernel for CUDA
tensors and runs :func:`thomas_plain` (the plain Thomas solve) for CPU
tensors; it never falls back, and raises on a shape the kernel does not
take.  Its backward solves the transposed system the same way (K10 on
the card, counted also as ``thomas_backward``), so gradients flow
through it.  ``tridiag_solve`` calls it under the solvers 'auto' and
'pallas'.
"""

from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from ..utils.cuda_build import load_kernels
from .adi_sep import pick_chunks
from .tridiag import tridiag_solve_thomas as thomas_plain

__all__ = ["LAUNCHES", "ThomasSolve", "kernel_plan", "layout_of", "thomas", "thomas_plain"]

#: launches of the kernel since import (or since the caller reset it):
#: ``thomas`` counts every launch, ``thomas_cols`` those in the cols
#: layout, ``thomas_relayout`` those whose inputs were first copied into
#: rows, ``thomas_backward`` those of :class:`ThomasSolve`'s backward
LAUNCHES = {"thomas": 0, "thomas_cols": 0, "thomas_relayout": 0, "thomas_backward": 0}

#: the kernel's line count and positions are 32-bit; a block index is at most 2³¹ − 1
_MAX_LINES = 2**31 - 2**16


def layout_of(sub, diag, sup, rhs):
    """How the kernel reads the four tensors in place, or None if they need a copy.

    ``("rows", lines, n, 1)``: every tensor contiguous, line L's position
    p at L·n + p.  ``("cols", lines, n, lead)``: every tensor the
    ``movedim(-2, -1)`` view of a contiguous (..., n, lines) tensor, with
    ``lead`` the product of the leading dimensions: position p of line j
    of lead index g at (g·n + p)·lines + j.  None for tensors of different
    shapes (a broadcast), mixed layouts or any other strides.  Needs a
    last dimension of at least one cell and no empty tensor.
    """
    shape = rhs.shape
    tensors = (sub, diag, sup, rhs)
    if any(t.shape != shape for t in tensors):
        return None
    n = shape[-1]
    if all(t.is_contiguous() for t in tensors):
        return "rows", rhs.numel() // n, n, 1
    if rhs.ndim >= 2 and all(t.transpose(-1, -2).is_contiguous() for t in tensors):
        lines = shape[-2]
        return "cols", lines, n, rhs.numel() // (n * lines)
    return None


def kernel_plan(form: str, dtype: torch.dtype, n: int, lines: int, lead: int = 1) -> dict:
    """How the kernel launches on the current card for ``lead`` × ``lines``
    lines of n in the layout ``form`` ("rows" or "cols"), as :func:`thomas`
    asks (``pick_chunks(n)`` chunks).

    ``tl`` lines per block, ``w`` chunks of a line held at once (``w <
    k``: the two-pass form), ``pitch`` the shared-memory chunk pitch,
    ``smem`` dynamic shared bytes per block, ``blocks``, ``waves`` and
    ``k`` the Wang chunk count launched.  Raises when the kernel does not
    take the shape.  Needs the card (it reads its limits).
    """
    out = (ctypes.c_int * 7)()
    cols = form == "cols"
    err = load_kernels().qp_thomas_plan(int(cols), torch.finfo(dtype).bits // 8, n,
                                        lines if cols else lead * lines, lead if cols else 1,
                                        pick_chunks(n), out)
    if err != 0:
        raise ValueError(f"the tridiagonal kernel does not take {lead}×{lines} {form} lines of {n} {dtype}")
    return dict(zip(("tl", "w", "pitch", "smem", "blocks", "waves", "k"), out))


def _launch(sub, diag, sup, rhs, backward: bool = False) -> torch.Tensor:
    """Launch the kernel; ``backward`` marks the transposed solve of
    :meth:`ThomasSolve.backward`, also counted as ``thomas_backward``."""
    if rhs.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"tridiagonal kernel takes float32 or float64, got {rhs.dtype}")
    for t in (sub, diag, sup):
        if t.device != rhs.device or t.dtype != rhs.dtype:
            raise ValueError("sub, diag, sup and rhs must share the device and dtype")
    if rhs.ndim == 0:
        raise ValueError("the tridiagonal solve needs at least one axis")
    if any(t.shape != rhs.shape for t in (sub, diag, sup)):
        sub, diag, sup, rhs = torch.broadcast_tensors(sub, diag, sup, rhs)
    n = rhs.shape[-1]
    if n == 1:
        return rhs / diag
    if rhs.numel() == 0:
        return torch.empty_like(rhs)
    layout = layout_of(sub, diag, sup, rhs)
    relayout = layout is None
    if relayout:  # one copy into rows
        sub, diag, sup, rhs = (t.contiguous() for t in (sub, diag, sup, rhs))
        layout = "rows", rhs.numel() // n, n, 1
    form, lines, n, lead = layout
    if lines * lead > _MAX_LINES or n > _MAX_LINES:
        raise ValueError(f"the tridiagonal kernel takes fewer than 2^31 lines and cells, got "
                         f"{lines * lead} lines of {n}")
    x = torch.empty_like(rhs)  # rhs's strides: rows, or the cols layout
    lib = load_kernels()
    fn = lib.qp_thomas_f32 if rhs.dtype == torch.float32 else lib.qp_thomas_f64
    err = fn(
        sub.data_ptr(), diag.data_ptr(), sup.data_ptr(), rhs.data_ptr(), x.data_ptr(),
        int(form == "cols"), n, lines, lead, pick_chunks(n),
        torch.cuda.current_stream(rhs.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"tridiagonal kernel launch failed with CUDA error {err} "
                           f"({lead}×{lines} {form} lines of {n}, {rhs.dtype})")
    LAUNCHES["thomas"] += 1
    LAUNCHES["thomas_cols"] += int(form == "cols")
    LAUNCHES["thomas_relayout"] += int(relayout)
    LAUNCHES["thomas_backward"] += int(backward)
    return x


def _solve(sub, diag, sup, rhs, backward: bool = False) -> torch.Tensor:
    """The kernel on CUDA tensors, the plain Thomas solve on CPU tensors."""
    if rhs.device.type == "cpu":
        return thomas_plain(sub, diag, sup, rhs)
    return _launch(sub, diag, sup, rhs, backward)


def _like(t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``t`` in ``x``'s shape and strides (a copy unless it already is)."""
    if t.shape == x.shape and t.stride() == x.stride():
        return t
    return torch.empty_like(x).copy_(t)


def _reduced(grad: torch.Tensor, shape: torch.Size) -> torch.Tensor:
    """A full-shape gradient summed down to an input's (broadcast) ``shape``."""
    return grad if grad.shape == shape else grad.sum_to_size(shape)


class ThomasSolve(torch.autograd.Function):
    """x = T⁻¹ rhs along the last axis, differentiable in all four inputs.

    Forward: the kernel (:func:`_launch`) on CUDA tensors, the plain Thomas
    solve on CPU tensors.  Backward, with ḡ the incoming gradient: solve
    the transposed system Tᵀλ = ḡ the same way, in the forward solution's
    layout — Tᵀ has sub'[i] = sup[i−1] and sup'[i] = sub[i+1], built with
    zeros in the two entries a solve ignores, so the unread ``sub[..., 0]``
    and ``sup[..., -1]`` (NaN or a neighbour's coupling in some callers)
    never reach it — then rhs̄ = λ, diaḡ = −λ·x, sub̄[i] = −λ[i]·x[i−1] and
    sup̄[i] = −λ[i]·x[i+1], with sub̄[..., 0] = sup̄[..., -1] = 0 exactly, as
    ``jax.grad`` of the JAX package's Thomas scan gives.  Inputs that were
    broadcast get their gradients summed back to their shapes.  Once
    differentiable: no caller takes second derivatives through a solve.
    """

    @staticmethod
    def forward(ctx, sub, diag, sup, rhs):
        x = _solve(sub, diag, sup, rhs)
        ctx.save_for_backward(sub, diag, sup, x)
        ctx.rhs_shape = rhs.shape
        return x

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        sub, diag, sup, x = ctx.saved_tensors
        n = x.shape[-1]
        sub_t = torch.zeros_like(x)
        sup_t = torch.zeros_like(x)
        if n > 1:
            sub_t[..., 1:] = sup.expand(x.shape)[..., :-1]
            sup_t[..., :-1] = sub.expand(x.shape)[..., 1:]
        lam = _solve(sub_t, _like(diag.expand(x.shape), x), sup_t, _like(g, x), backward=True)
        grads = [None] * 4
        need = ctx.needs_input_grad
        if need[0]:
            d_sub = torch.zeros_like(x)
            d_sub[..., 1:] = -lam[..., 1:] * x[..., :-1]
            grads[0] = _reduced(d_sub, sub.shape)
        if need[1]:
            grads[1] = _reduced(-(lam * x), diag.shape)
        if need[2]:
            d_sup = torch.zeros_like(x)
            d_sup[..., :-1] = -lam[..., :-1] * x[..., 1:]
            grads[2] = _reduced(d_sup, sup.shape)
        if need[3]:
            grads[3] = _reduced(lam, ctx.rhs_shape)
        return tuple(grads)


def thomas(sub: torch.Tensor, diag: torch.Tensor, sup: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Tridiagonal solve along the last axis through the CUDA kernel (plain
    Thomas on the CPU), differentiable (:class:`ThomasSolve`)."""
    if rhs.device.type not in ("cpu", "cuda"):
        raise ValueError(f"tridiagonal kernel runs on CUDA tensors, got {rhs.device}")
    return ThomasSolve.apply(sub, diag, sup, rhs)
