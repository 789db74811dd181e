"""Host side of the separable ADI step: stencil vectors and prefactored Wang packs.

Carried over from the numpy parts of ``qpsim_tpu.ops.pallas_adi_sep``
(``separable_stencil_vectors``, ``_wang_prefactor_1d``) and
``qpsim_tpu.ops.pallas_adi._pick_chunks``, unchanged, and pinned equal to
them by ``tests/test_torch_adi_sep.py``.

On a full rectangle with one uniform BC per face the directional
operators are separable: the x-direction coefficients depend on x alone,
the y-direction ones on y alone, and the BC source splits as sx(x) + sy(y).
The planes then collapse to four 1D vectors per direction, and the
Wang-partition eliminations of each direction's Crank–Nicolson system
depend only on those, so they are prefactored once on the host in
float64.  :class:`SepFactors` holds the result on the device, per bin:
the vectors pre-scaled by α·s_b, the pack ``[a_rt, inv, cp, A, C]`` of
shape (5, M, K) and the interface table ``[aL, invI, aR, arw, q, w]`` of
shape (K, 6) for each direction.  The TPU kernel's lane replication of
the packs is a VMEM layout and has no counterpart here.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .diffusion import SplitOperator

__all__ = ["SepFactors", "separable_stencil_vectors", "pick_chunks"]


def separable_stencil_vectors(op: SplitOperator):
    """1D stencil vectors of a separable SplitOperator, or None.

    Returns ``(xlo, xhi, xdiag, sx), (ylo, yhi, ydiag, sy)`` — each a 1D
    float64 vector over x (length Nx) or y (length Ny) — when the operator
    is lazily scaled (``bin_scale`` over shared (1, Ny, Nx) planes), its
    x-direction planes are constant along y, its y-direction planes
    constant along x, and the sources split likewise.  Holds exactly for
    full rectangles with per-face-uniform BCs; any interior mask structure
    or per-segment BC variation breaks it and returns None.
    """
    if op.bin_scale is None:
        return None
    xs, ys = [], []
    for p in (op.ax_lo, op.ax_hi, op.ax_diag, op.sx):
        q = np.asarray(p, dtype=np.float64)
        if q.shape[0] != 1 or not np.all(q == q[:, 0:1, :]):
            return None
        xs.append(q[0, 0, :].copy())
    for p in (op.ay_lo, op.ay_hi, op.ay_diag, op.sy):
        q = np.asarray(p, dtype=np.float64)
        if q.shape[0] != 1 or not np.all(q == q[:, :, 0:1]):
            return None
        ys.append(q[0, :, 0].copy())
    return tuple(xs), tuple(ys)


def pick_chunks(n: int) -> int:
    """Chunk count K for the Wang partition (1: no partition).

    The largest K in (32, 16, 8, 4, 2) dividing n with chunk length
    M = n/K ≥ 8.
    """
    for k in (32, 16, 8, 4, 2):
        if n % k == 0 and n // k >= 8:
            return k
    return 1


def _wang_prefactor_1d(a, b, c, k):
    """Host prefactorization of the Wang-partition solve for 1D coefficients.

    Returns ``(pack, ifc)``: ``pack`` is (5, M, K) chunk-major —
    [a_rt, inv, cp, A, C] where the runtime sweeps are

        forward:  dp_i = (d_i − a_rt_i·dp_{i−1})·inv_i        (dp_{−1} := 0)
        backward: D_i  = dp_i − cp_i·D_{i+1}                  (D_{M−1} = dp)
        final:    x_i  = D_i − A_i·X_L − C_i·X_R

    and ``ifc`` is (K, 6) = [aL, invI, aR, arw, q, w] per chunk for the
    interface recurrence

        p_j = (dL_j − aL_j·g_{j−1})·invI_j
        g_j = dR_j − aR_j·g_{j−1} + arw_j·p_j
        L_j = p_j − q_j·L_{j+1};  R_j = g_j − w_j·L_{j+1}.
    """
    n = a.size
    m = n // k
    a_c = a.reshape(k, m).T.copy()
    b_c = b.reshape(k, m).T
    c_c = c.reshape(k, m).T
    inv = np.empty((m, k))
    cp = np.empty((m, k))
    ap = np.empty((m, k))
    inv[0] = 1.0 / b_c[0]
    cp[0] = c_c[0] * inv[0]
    ap[0] = a_c[0] * inv[0]
    for i in range(1, m):
        inv[i] = 1.0 / (b_c[i] - a_c[i] * cp[i - 1])
        cp[i] = c_c[i] * inv[i]
        ap[i] = -a_c[i] * ap[i - 1] * inv[i]
    A = np.empty((m, k))
    C = np.empty((m, k))
    A[m - 1] = ap[m - 1]
    C[m - 1] = cp[m - 1]
    for i in range(m - 2, -1, -1):
        C[i] = -cp[i] * C[i + 1]
        A[i] = ap[i] - cp[i] * A[i + 1]
    aL, cL = A[0].copy(), C[0].copy()
    aR, cR = A[m - 1].copy(), C[m - 1].copy()
    invI = np.empty(k)
    q = np.empty(k)
    w_arr = np.empty(k)
    arw = np.empty(k)
    w_prev = 0.0
    for j in range(k):
        invI[j] = 1.0 / (1.0 - aL[j] * w_prev)
        q[j] = cL[j] * invI[j]
        arw[j] = aR[j] * w_prev
        w_prev = cR[j] + arw[j] * q[j]
        w_arr[j] = w_prev
    a_rt = a_c
    a_rt[0] = 0.0  # row 0 of each chunk: X_L coupling lives in A, not in dp
    pack = np.stack([a_rt, inv, cp, A, C])
    ifc = np.stack([aL, invI, aR, arw, q, w_arr], axis=1)
    return pack, ifc


@dataclass
class SepFactors:
    """One separable ADI step's data on the device, per bin b (α = dt/2).

    ``xv`` (NB, 4, Nx) = α·s_b·(xlo, xhi, xdiag, sx) and ``yv`` (NB, 4, Ny)
    likewise along y; ``facx`` (NB, 5, Mx, Kx) and ``ifx`` (NB, Kx, 6) are
    the prefactored x-direction solve, ``facy``/``ify`` the y-direction one.
    """

    xv: torch.Tensor
    yv: torch.Tensor
    facx: torch.Tensor
    ifx: torch.Tensor
    facy: torch.Tensor
    ify: torch.Tensor

    @property
    def num_bins(self) -> int:
        return int(self.xv.shape[0])

    @property
    def grid_shape(self) -> tuple[int, int]:
        return int(self.yv.shape[2]), int(self.xv.shape[2])

    @classmethod
    def build(cls, op: SplitOperator, dt: float, device, dtype: torch.dtype) -> "SepFactors":
        """Prefactor ``op`` at step ``dt``; raises ValueError when K1 cannot take it."""
        vecs = separable_stencil_vectors(op)
        if vecs is None:
            raise ValueError(
                "the separable ADI step needs a lazy-scaled operator with separable "
                "directional planes"
            )
        (xlo, xhi, xdiag, sx), (ylo, yhi, ydiag, sy) = vecs
        ny, nx = np.asarray(op.mask).shape
        kx, ky = pick_chunks(nx), pick_chunks(ny)
        if kx < 2 or ky < 2:
            raise ValueError(f"the separable ADI step needs Wang chunks on both axes, got {ny}x{nx}")
        scales = 0.5 * float(dt) * np.asarray(op.bin_scale, dtype=np.float64).reshape(-1)
        parts = {name: [] for name in ("xv", "yv", "facx", "ifx", "facy", "ify")}
        for a_s in scales:
            packx, ifcx = _wang_prefactor_1d(-a_s * xlo, 1.0 - a_s * xdiag, -a_s * xhi, kx)
            packy, ifcy = _wang_prefactor_1d(-a_s * ylo, 1.0 - a_s * ydiag, -a_s * yhi, ky)
            parts["xv"].append(np.stack([a_s * xlo, a_s * xhi, a_s * xdiag, a_s * sx]))
            parts["yv"].append(np.stack([a_s * ylo, a_s * yhi, a_s * ydiag, a_s * sy]))
            parts["facx"].append(packx)
            parts["ifx"].append(ifcx)
            parts["facy"].append(packy)
            parts["ify"].append(ifcy)
        return cls(**{
            name: torch.as_tensor(np.stack(arrs), dtype=dtype, device=device)
            for name, arrs in parts.items()
        })
