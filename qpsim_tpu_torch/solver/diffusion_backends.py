"""Crank–Nicolson diffusion backends, carried over from ``qpsim_tpu.solver.diffusion_backends``.

One step contract: ``make_step(dt)`` returns ``step(state) -> state`` for
a (NB, Ny, Nx) state, dt baked in.

* :class:`DenseSpectralDiffusion` — exact unsplit CN.  The masked P×P
  operator L is symmetric, so one host-side eigendecomposition
  L = Q Λ Qᵀ turns every CN solve into two dense matmuls
  (``torch.matmul``): u⁺ = Q·diag((1+αλ)/(1−αλ))·Qᵀu + const.  The choice
  for small grids (≤ 4096 interior cells).
* :class:`ADIDiffusion` — Peaceman–Rachford ADI with batched tridiagonal
  solves through ``ops.tridiag.tridiag_solve`` (so ``set_default_solver``
  picks the algorithm, the CUDA tridiagonal kernel included).
* :class:`PrefactoredWangADI` — ADI with the Wang-partition factors of both
  directions built once per ``make_step`` (``diffusion_backend='wang'``).
* :class:`CGDiffusion` — exact unsplit CN by Jacobi-preconditioned
  conjugate gradient (``diffusion_backend='cg'``).
* :class:`CudaADI` — ADI through the hand-written CUDA kernels: the
  separable prefactored-Wang step (K1) where the operator allows it, else
  the fused ADI step (K2).

Masked-out cells are inert identity rows in every backend.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.adi_cuda import AdiPlanes, _apply_dir, adi_step, adi_step_plain
from ..ops.adi_sep import SepFactors, pick_chunks, separable_stencil_vectors
from ..ops.adi_sep_cuda import adi_sep_step
from ..ops.diffusion import SplitOperator, active_indices, assemble_dense_operator
from ..ops.tridiag import tridiag_solve, wang_apply, wang_factor

__all__ = [
    "DENSE_BACKEND_MAX_CELLS",
    "DenseSpectralDiffusion",
    "ADIDiffusion",
    "PrefactoredWangADI",
    "CGDiffusion",
    "CudaADI",
    "choose_backend",
]

#: grids with at most this many interior cells default to the dense backend.
DENSE_BACKEND_MAX_CELLS = 4096

#: multi-bin separable builds engage only when both extents reach this
SEPARABLE_MULTIBIN_MIN_EXTENT = 512
#: K1 holds one Wang chunk of a line (its host-prefactored length M = n/K)
#: in shared memory; at M ≤ 16384 that is ≤ 133 KB in float64, which a
#: Hopper or Ampere card gives a block.  Longer chunks (a line of 2·odd
#: cells above 32 768, say) take K2, which sizes its own chunks.
SEPARABLE_MAX_CHUNK_ROWS = 16384


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
    """Peaceman–Rachford ADI with batched tridiagonal solves (plain PyTorch).

    Uniform-per-bin operators stay factored as unit-D geometry planes ×
    ``bin_scale``; the scale multiplies at use, so (NB, Ny, Nx) coefficient
    planes are never stored.  The solves go through ``tridiag_solve``, so
    ``set_default_solver`` chooses the algorithm.
    """

    #: the JAX package's budget: a factored operator of at most this many
    #: (NB, Ny, Nx) coefficient elements is folded into per-bin planes on
    #: the host; a larger one keeps its scale lazy.  This class always keeps
    #: it lazy; the sharded step (``parallel.sharded``) applies the rule.
    MATERIALIZE_MAX_ELEMENTS = 4_000_000

    def __init__(self, op: SplitOperator, device, dtype: torch.dtype):
        self.device = torch.device(device)
        self.dtype = dtype
        self.mask = np.asarray(op.mask, dtype=bool)
        self.num_bins = op.num_bins
        self.planes = AdiPlanes.from_operator(op, self.device, dtype)

    def make_step(self, dt: float):
        planes, alpha = self.planes, 0.5 * float(dt)
        return lambda state: adi_step_plain(state, planes, alpha, solve=tridiag_solve)

    def _scaled_planes(self) -> tuple[torch.Tensor, ...]:
        """(ax_lo, ax_hi, ax_diag, ay_lo, ay_hi, ay_diag, src) with bin_scale folded in."""
        p = self.planes
        s = p.scale.reshape(-1, 1, 1)
        return tuple(s * t for t in (p.ax_lo, p.ax_hi, p.ax_diag, p.ay_lo, p.ay_hi, p.ay_diag, p.src))


class PrefactoredWangADI(ADIDiffusion):
    """ADI with once-per-``make_step`` Wang-partition factorizations.

    The CN tridiagonal systems are fixed for a run, so both directions are
    factored once (``wang_factor``, chunk 64) and each step runs only the
    rhs recurrences (``wang_apply``).  Factor memory: 10 arrays of
    (NB, Ny, Nx) per direction.  Opt-in (``diffusion_backend='wang'``), as
    in the JAX package.
    """

    #: Wang chunk length
    CHUNK = 64

    def make_step(self, dt: float):
        alpha = 0.5 * float(dt)
        ax_lo, ax_hi, ax_diag, ay_lo, ay_hi, ay_diag, src = self._scaled_planes()
        fx = wang_factor(-alpha * ax_lo, 1.0 - alpha * ax_diag, -alpha * ax_hi, chunk=self.CHUNK)
        mv = lambda t: t.movedim(-2, -1)
        fy = wang_factor(
            -alpha * mv(ay_lo), 1.0 - alpha * mv(ay_diag), -alpha * mv(ay_hi), chunk=self.CHUNK
        )

        def step(u: torch.Tensor) -> torch.Tensor:
            rhs = u + alpha * _apply_dir(u, ay_lo, ay_hi, ay_diag, -2) + alpha * src
            u_star = wang_apply(fx, rhs)
            rhs2 = u_star + alpha * _apply_dir(u_star, ax_lo, ax_hi, ax_diag, -1) + alpha * src
            return mv(wang_apply(fy, mv(rhs2))).contiguous()

        return step


def _pcg(A, b, x0, diag, tol: float, maxiter: int, check_every: int) -> torch.Tensor:
    """Jacobi-preconditioned CG, stopping as ``jax.scipy.sparse.linalg.cg`` does.

    Iterates while ‖r‖² > tol²·‖b‖² (atol 0) and fewer than ``maxiter``
    iterations ran, with the same updates in the same order.  Convergence
    is decided on the device: each iteration computes the flag as a tensor
    and freezes x, r, p and γ once it is False, so the iterate is the one
    the JAX loop stops at.  The host reads the flag only every
    ``check_every`` iterations to leave the loop, so a CUDA run syncs once
    per ``check_every`` iterations, not every iteration.
    """
    dot = lambda u, v: torch.sum(u * v)
    atol2 = tol * tol * dot(b, b)
    x = x0
    r = b - A(x0)
    z = r / diag
    p = z
    gamma = dot(r, z)
    for k in range(maxiter):
        going = dot(r, r) > atol2
        if k % check_every == 0 and not bool(going):
            break
        Ap = A(p)
        alpha = gamma / dot(p, Ap)
        x_new = x + alpha * p
        r_new = r - alpha * Ap
        z = r_new / diag
        gamma_new = dot(r_new, z)
        p_new = z + (gamma_new / gamma) * p
        x = torch.where(going, x_new, x)
        r = torch.where(going, r_new, r)
        p = torch.where(going, p_new, p)
        gamma = torch.where(going, gamma_new, gamma)
    return x


class CGDiffusion(ADIDiffusion):
    """Exact **unsplit** CN via Jacobi-preconditioned conjugate gradient.

    The masked CN matrix (I − αL) is symmetric positive definite, so
    matrix-free CG needs only the directional stencils: the parity-exact
    backend for masked grids too large for the dense one.  Opt-in
    (``diffusion_backend='cg'``).  One CG runs over the whole (NB, Ny, Nx)
    state, as in the JAX package.
    """

    #: CG stops at ‖r‖ ≤ tol·‖b‖ (tol 1e-7 in float32) or after MAXITER iterations
    TOL = 1e-12
    MAXITER = 400
    #: iterations between the host's reads of the device-side convergence flag
    CHECK_EVERY = 8

    def make_step(self, dt: float):
        alpha = 0.5 * float(dt)
        ax_lo, ax_hi, ax_diag, ay_lo, ay_hi, ay_diag, src = self._scaled_planes()
        tol = self.TOL if self.dtype == torch.float64 else 1e-7
        diag_A = 1.0 - alpha * (ax_diag + ay_diag)  # the Jacobi preconditioner

        def L(u):
            return _apply_dir(u, ax_lo, ax_hi, ax_diag, -1) + _apply_dir(u, ay_lo, ay_hi, ay_diag, -2)

        A = lambda u: u - alpha * L(u)

        def step(state: torch.Tensor) -> torch.Tensor:
            b = state + alpha * L(state) + float(dt) * src
            return _pcg(A, b, state, diag_A, tol, self.MAXITER, self.CHECK_EVERY)

        return step


def _separable_applies(op: SplitOperator, coupled: bool) -> bool:
    """Whether K1 takes ``op``: the JAX package's conditions without the TPU ones."""
    ny, nx = np.asarray(op.mask).shape
    if pick_chunks(ny) < 2 or pick_chunks(nx) < 2:
        return False
    if max(ny // pick_chunks(ny), nx // pick_chunks(nx)) > SEPARABLE_MAX_CHUNK_ROWS:
        return False
    if op.num_bins > 1 and (coupled or min(ny, nx) < SEPARABLE_MULTIBIN_MIN_EXTENT):
        return False
    return separable_stencil_vectors(op) is not None


class CudaADI(ADIDiffusion):
    """ADI through the CUDA kernels, dispatched as the JAX package's ``PallasADI``.

    The separable prefactored-Wang step (K1, ``ops.adi_sep_cuda``) runs when
    the operator is separable and lazily scaled, both extents split into
    K ≥ 2 Wang chunks of at most ``SEPARABLE_MAX_CHUNK_ROWS`` rows, and —
    for NB > 1 — the build is standalone (no collisions composed with it)
    with both extents ≥ 512.  Everything else
    runs the fused ADI step (K2, ``ops.adi_cuda``).  The JAX package's
    TPU-only conditions have no counterpart here and are dropped: 8-row
    and 128-lane tiles (``_pick_tile``), VMEM budgets (``_auto_tile``), the
    Mosaic compile probe and the ``QPSIM_ADI_SEPARABLE*`` switches.  Both
    kernels launch on CUDA tensors and run their plain versions on CPU ones.
    """

    def __init__(self, op: SplitOperator, device, dtype: torch.dtype, *, coupled: bool = False):
        super().__init__(op, device, dtype)
        self._op = op
        #: True when the step runs K1, False when it runs K2
        self.separable = _separable_applies(op, coupled)

    def make_step(self, dt: float):
        # the kernels take contiguous states; the plain collision substep
        # (collision_backend='plain') hands back a transposed view
        if self.separable:
            factors = SepFactors.build(self._op, dt, self.device, self.dtype)
            step = lambda state: adi_sep_step(state.contiguous(), factors)
            step.factors = factors  # K1's packs, for a caller counting its bytes
            return step
        planes, alpha = self.planes, 0.5 * float(dt)
        return lambda state: adi_step(state.contiguous(), planes, alpha)


def choose_backend(
    op: SplitOperator, device, dtype: torch.dtype, preference: str = "auto", *, coupled: bool = False
):
    """Pick a diffusion backend: 'auto', 'dense', 'adi', 'wang', 'cg' or 'pallas'.

    'auto' is dense at ≤ 4096 interior cells; above that it is
    :class:`CudaADI` on a CUDA device and plain ADI on the CPU.  'pallas'
    (the JAX package's name) is :class:`CudaADI` and needs a CUDA device.
    ``coupled=True`` means the step is composed with collision substeps,
    which keeps multi-bin operators off K1 (as in the JAX package).
    """
    device = torch.device(device)
    if preference == "pallas":
        if device.type != "cuda":
            raise ValueError(f"diffusion_backend='pallas' requested but it needs a CUDA device, got {device}")
        return CudaADI(op, device, dtype, coupled=coupled)
    if preference == "dense":
        return DenseSpectralDiffusion(op, device, dtype)
    if preference == "adi":
        return ADIDiffusion(op, device, dtype)
    if preference == "wang":
        return PrefactoredWangADI(op, device, dtype)
    if preference == "cg":
        return CGDiffusion(op, device, dtype)
    if preference != "auto":
        raise ValueError(f"Unknown diffusion backend: {preference!r}")
    if int(np.asarray(op.mask, dtype=bool).sum()) <= DENSE_BACKEND_MAX_CELLS:
        return DenseSpectralDiffusion(op, device, dtype)
    if device.type == "cuda":
        return CudaADI(op, device, dtype, coupled=coupled)
    return ADIDiffusion(op, device, dtype)
