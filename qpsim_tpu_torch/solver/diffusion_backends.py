"""Crank–Nicolson diffusion backends, carried over from ``qpsim_tpu.solver.diffusion_backends``.

One step contract: ``make_step(dt)`` returns ``step(state) -> state`` for
a (NB, Ny, Nx) state, dt baked in.

* :class:`DenseSpectralDiffusion` — exact unsplit CN.  The masked P×P
  operator L is symmetric, so one host-side eigendecomposition
  L = Q Λ Qᵀ turns every CN solve into two dense matmuls
  (``torch.matmul``): u⁺ = Q·diag((1+αλ)/(1−αλ))·Qᵀu + const.  The choice
  for small grids (≤ 4096 interior cells).
* :class:`ADIDiffusion` — Peaceman–Rachford ADI with batched Thomas solves,
  the plain PyTorch version of the ADI kernel (``ops.adi_cuda``).
* :class:`CudaADI` — the same step through the hand-written CUDA kernels.

Masked-out cells are inert identity rows in every backend.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.adi_cuda import AdiPlanes, adi_step, adi_step_plain
from ..ops.diffusion import SplitOperator, active_indices, assemble_dense_operator

__all__ = [
    "DENSE_BACKEND_MAX_CELLS",
    "DenseSpectralDiffusion",
    "ADIDiffusion",
    "CudaADI",
    "choose_backend",
]

#: grids with at most this many interior cells default to the dense backend.
DENSE_BACKEND_MAX_CELLS = 4096


class DenseSpectralDiffusion:
    """Exact unsplit CN via spectral decomposition of the masked operator."""

    def __init__(self, op: SplitOperator, device, dtype: torch.dtype):
        self.device = torch.device(device)
        self.dtype = dtype
        self.mask = np.asarray(op.mask, dtype=bool)
        self._flat_active = torch.as_tensor(active_indices(self.mask), device=self.device)
        self.num_bins = op.num_bins
        L, src = assemble_dense_operator(op)  # (NB,P,P), (NB,P) float64
        # one eigendecomposition per distinct operator (a per-bin uniform D
        # is already folded in, so detect shared structure cheaply)
        self._shared = all(np.array_equal(L[0], L[b]) for b in range(1, L.shape[0]))
        if self._shared:
            lam, Q = np.linalg.eigh(L[0])
            self._lam, self._Q = lam[None, :], Q[None, :, :]
        else:
            pairs = [np.linalg.eigh(L[b]) for b in range(L.shape[0])]
            self._lam = np.stack([p[0] for p in pairs])
            self._Q = np.stack([p[1] for p in pairs])
        self._src = src

    def make_step(self, dt: float):
        alpha = 0.5 * float(dt)
        ratio = (1.0 + alpha * self._lam) / (1.0 - alpha * self._lam)  # (nb?, P)
        # constant source response dt·(I−αL)⁻¹ s, precomputed in float64
        gain = float(dt) / (1.0 - alpha * self._lam)
        proj_src = np.einsum("bqp,bp->bq", np.swapaxes(self._Q, -1, -2), self._src)
        s_eff = np.einsum("bpq,bq->bp", self._Q, gain * proj_src)
        as_dev = lambda a: torch.as_tensor(a, dtype=self.dtype, device=self.device)
        Q, ratio_d, s_eff_d = as_dev(self._Q), as_dev(ratio), as_dev(s_eff)
        active = self._flat_active
        ny, nx = self.mask.shape
        shared = self._shared

        def step(state: torch.Tensor) -> torch.Tensor:
            nb = state.shape[0]
            u = state.reshape(nb, ny * nx)[:, active]  # (NB, P)
            if shared:
                v = u @ Q[0]  # projections onto the eigenbasis
                u_new = (v * ratio_d) @ Q[0].T
            else:
                v = torch.einsum("bqp,bq->bp", Q, u)
                u_new = torch.einsum("bpq,bq->bp", Q, v * ratio_d)
            out = torch.zeros((nb, ny * nx), dtype=state.dtype, device=state.device)
            out[:, active] = u_new + s_eff_d
            return out.reshape(nb, ny, nx)

        return step


class ADIDiffusion:
    """Peaceman–Rachford ADI with batched Thomas solves (plain PyTorch).

    Uniform-per-bin operators stay factored as unit-D geometry planes ×
    ``bin_scale``; the scale multiplies at use, so (NB, Ny, Nx) coefficient
    planes are never stored.
    """

    def __init__(self, op: SplitOperator, device, dtype: torch.dtype):
        self.device = torch.device(device)
        self.dtype = dtype
        self.mask = np.asarray(op.mask, dtype=bool)
        self.num_bins = op.num_bins
        self.planes = AdiPlanes.from_operator(op, self.device, dtype)

    def make_step(self, dt: float):
        planes, alpha = self.planes, 0.5 * float(dt)
        return lambda state: adi_step_plain(state, planes, alpha)


class CudaADI(ADIDiffusion):
    """ADI through the CUDA kernels (one launch per half-step)."""

    def make_step(self, dt: float):
        planes, alpha = self.planes, 0.5 * float(dt)
        return lambda state: adi_step(state, planes, alpha)


_DEFERRED = {
    "wang": "the prefactored Wang ADI backend",
    "cg": "the conjugate-gradient CN backend",
}


def choose_backend(op: SplitOperator, device, dtype: torch.dtype, preference: str = "auto"):
    """Pick a diffusion backend: 'auto', 'dense' or 'adi'.

    'auto' is dense at ≤ 4096 interior cells; above that it is the CUDA
    kernel on a CUDA device and plain ADI on the CPU.
    """
    device = torch.device(device)
    if preference in _DEFERRED:
        raise NotImplementedError(
            f"diffusion_backend={preference!r} ({_DEFERRED[preference]}) is not ported "
            "yet: ROADMAP.md, queue 1, 'PCR, Wang and the remaining diffusion backends'."
        )
    if preference == "dense":
        return DenseSpectralDiffusion(op, device, dtype)
    if preference == "adi":
        return ADIDiffusion(op, device, dtype)
    if preference != "auto":
        raise ValueError(f"Unknown diffusion backend: {preference!r}")
    if int(np.asarray(op.mask, dtype=bool).sum()) <= DENSE_BACKEND_MAX_CELLS:
        return DenseSpectralDiffusion(op, device, dtype)
    if device.type == "cuda":
        return CudaADI(op, device, dtype)
    return ADIDiffusion(op, device, dtype)
