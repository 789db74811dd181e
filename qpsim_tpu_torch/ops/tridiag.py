"""Batched tridiagonal solves in PyTorch (Thomas algorithm).

The counterpart of ``qpsim_tpu.ops.tridiag``'s Thomas path
(``_tridiag_solve_thomas`` behind ``tridiag_solve``, ``tridiag_solve_along``): the
same recurrences in the same order, so float64 results agree to roundoff.
The sweep is a Python loop over the line axis, batched over every line at
once.  It is the plain PyTorch solve behind ``ADIDiffusion`` and the plain
version of the ADI kernel (``ops.adi_cuda``).  PCR and the Wang partition
come with the scalar branch.
"""

from __future__ import annotations

import torch

__all__ = ["tridiag_solve", "tridiag_solve_along"]


def tridiag_solve(
    sub: torch.Tensor, diag: torch.Tensor, sup: torch.Tensor, rhs: torch.Tensor
) -> torch.Tensor:
    """Solve T x = rhs with T tridiagonal along the last axis (Thomas sweep).

    ``sub[..., i]`` couples row i to i−1 (never read at i=0) and
    ``sup[..., i]`` couples row i to i+1 (never read at the last row).  The
    four arrays broadcast to one shape; batching is over the leading axes.
    """
    sub, diag, sup, rhs = torch.broadcast_tensors(sub, diag, sup, rhs)
    n = rhs.shape[-1]
    if n == 1:
        return rhs / diag
    # line axis first, so every sweep row is one contiguous batch of lines
    a, b, c, r = (t.movedim(-1, 0) for t in (sub, diag, sup, rhs))
    w = torch.empty(r.shape, dtype=r.dtype, device=r.device)
    g = torch.empty_like(w)
    inv = 1.0 / b[0]
    w[0] = c[0] * inv
    g[0] = r[0] * inv
    for i in range(1, n):
        inv = 1.0 / (b[i] - a[i] * w[i - 1])
        if i < n - 1:
            w[i] = c[i] * inv
        g[i] = (r[i] - a[i] * g[i - 1]) * inv
    # back substitution in place over g (saves a third (n, ...) buffer):
    # x_i = g_i - w_i·x_{i+1}
    for i in range(n - 2, -1, -1):
        g[i] -= w[i] * g[i + 1]
    return g.movedim(0, -1)


def tridiag_solve_along(
    axis: int,
    sub: torch.Tensor,
    diag: torch.Tensor,
    sup: torch.Tensor,
    rhs: torch.Tensor,
) -> torch.Tensor:
    """Tridiagonal solve along an arbitrary axis (moves it last and back)."""
    if axis in (-1, rhs.ndim - 1):
        return tridiag_solve(sub, diag, sup, rhs)
    move = lambda t: t.movedim(axis, -1)
    return tridiag_solve(move(sub), move(diag), move(sup), move(rhs)).movedim(-1, axis)
