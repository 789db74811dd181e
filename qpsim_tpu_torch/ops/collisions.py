"""Coupled quasiparticle–phonon collision integrator (Fischer–Catelani local).

The plain PyTorch version of the collision substep, carried over from
``qpsim_tpu.ops.collisions`` (``build_collision_plan_arrays``,
``make_collision_step``) for a uniform gap: the same batched einsums over
pixels, the same one-hot ω-scatter matmuls and the same exponential
updates.  It is the CPU path and the plain version the CUDA kernel
(``ops.collisions_cuda``, ``csrc/collisions.cu``) is held against.

Physics summary (per pixel, per collision substep of length dt):

  QP gains/losses
    scattering in :  dE·ρᵢ(1−fᵢ)·Σⱼ K^s_eff[j,i]·nⱼ
    scattering out:  nᵢ·dE·Σⱼ K^s_eff[i,j]·ρⱼ(1−fⱼ)       (rate)
    recombination :  loss 2dE·Σⱼ K^r₀(1+n_ph(Eᵢ+Eⱼ))·nⱼ   (rate)
    pair-breaking :  gain 2dE·ρᵢ(1−fᵢ)·Σⱼ K^r₀·n_ph(Eᵢ+Eⱼ)·ρⱼ(1−fⱼ)
    update: n⁺ = e^{−μdt} n + (1−e^{−μdt})·gain/μ, μ = loss rate  (≥0)

  Phonon rates (scattered onto ω bins)
    emission (i>j):  +dE·nᵢ·K^s₀·ρⱼ(1−fⱼ)  → a and b
    absorption(i<j): −dE·nᵢ·K^s₀·ρⱼ(1−fⱼ)  → b only
    recombination :  +dE·nᵢ·K^r₀·nⱼ         → a and b
    pair-breaking :  −dE·ρᵢ(1−fᵢ)K^r₀ρⱼ(1−fⱼ) → b only
    update: solve y' = a + b·y with frozen coefficients, clamp ≥ 0.

K^s_eff dresses the base kernel with the *local, dynamic* phonon occupation:
(1+n_ph) for emission, n_ph for absorption, zero diagonal.

Pixels are processed in chunks of ``pixel_chunk`` so the (C, NE, NE) pair
temporaries stay bounded on 1024² grids.  An optional (Ny, Nx) generation
plane dt·g is added to every bin before the substep (the forward-Euler
injection the CUDA kernel fuses).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .phonon_map import PhononFrequencyMap

__all__ = [
    "DEFAULT_PIXEL_CHUNK",
    "CollisionPlan",
    "build_collision_plan_arrays",
    "collision_step_plain",
]

#: default number of pixels processed per chunk.
DEFAULT_PIXEL_CHUNK = 4096

_MU_FLOOR = 1e-14
_AFFINE_CLIP = 80.0
_RHO_FLOOR = 1e-30


@dataclass
class CollisionPlan:
    """Device tables of the collision substep for one uniform gap.

    The host maps (``*_np``) feed the CUDA kernel's pair tables
    (``ops.collisions_cuda.build_kernel_tables``); the rest feeds the plain
    einsum version.
    """

    dE: float
    rho: torch.Tensor  # (NE,)
    K_r0: torch.Tensor | None  # (NE, NE)
    K_s0: torch.Tensor | None  # (NE, NE)
    idx_diff: torch.Tensor  # (NE*NE,) int64
    idx_sum: torch.Tensor  # (NE*NE,) int64
    emit_mask: torch.Tensor  # (NE, NE) 1.0 where E_i > E_j
    absorb_mask: torch.Tensor  # (NE, NE) 1.0 where E_i < E_j
    scatter_diff: torch.Tensor  # (NE*NE, NW)
    scatter_sum: torch.Tensor  # (NE*NE, NW)
    enable_recombination: bool
    enable_scattering: bool
    update_phonons: bool
    num_energy_bins: int
    num_omega: int
    pixel_chunk: int
    # host copies, for the kernel's pair tables
    idx_diff_np: np.ndarray  # (NE, NE) int32
    idx_sum_np: np.ndarray  # (NE, NE) int32
    diff_sign_np: np.ndarray  # (NE, NE) int8

    @property
    def active(self) -> bool:
        return self.enable_scattering or self.enable_recombination


def build_collision_plan_arrays(
    *,
    dE: float,
    rho: np.ndarray,
    K_r0: np.ndarray | None,
    K_s0: np.ndarray | None,
    pmap: PhononFrequencyMap,
    enable_recombination: bool,
    enable_scattering: bool,
    update_phonons: bool,
    device: torch.device | str,
    dtype: torch.dtype,
    pixel_chunk: int = DEFAULT_PIXEL_CHUNK,
) -> CollisionPlan:
    """Upload host-precomputed collision data (float64 numpy) as a plan."""
    as_dev = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=dtype, device=device)
    sign = np.asarray(pmap.diff_sign)
    return CollisionPlan(
        dE=float(dE),
        rho=as_dev(rho),
        K_r0=None if K_r0 is None or not enable_recombination else as_dev(K_r0),
        K_s0=None if K_s0 is None or not enable_scattering else as_dev(K_s0),
        idx_diff=torch.as_tensor(pmap.idx_diff.reshape(-1), dtype=torch.int64, device=device),
        idx_sum=torch.as_tensor(pmap.idx_sum.reshape(-1), dtype=torch.int64, device=device),
        emit_mask=as_dev(sign > 0),
        absorb_mask=as_dev(sign < 0),
        scatter_diff=as_dev(pmap.scatter_diff),
        scatter_sum=as_dev(pmap.scatter_sum),
        enable_recombination=bool(enable_recombination and K_r0 is not None),
        enable_scattering=bool(enable_scattering and K_s0 is not None),
        update_phonons=bool(update_phonons),
        num_energy_bins=int(np.asarray(rho).size),
        num_omega=pmap.num_omega,
        pixel_chunk=int(pixel_chunk),
        idx_diff_np=np.asarray(pmap.idx_diff, dtype=np.int32),
        idx_sum_np=np.asarray(pmap.idx_sum, dtype=np.int32),
        diff_sign_np=sign.astype(np.int8),
    )


def _relaxation_update(n, gain, loss_rate, dt: float):
    """Positivity-preserving exponential update for dn/dt = gain − loss·n.

    Uses expm1 for (1−e^{−μdt})/μ: the reference computes exp()−1 directly,
    which cancels catastrophically for μdt ≪ 1.
    """
    mu = torch.clamp(loss_rate, min=0.0)
    p_term = torch.clamp(gain + (mu - loss_rate) * n, min=0.0)
    decay = torch.exp(-mu * dt)
    coeff = torch.where(
        mu < _MU_FLOOR, dt, -torch.expm1(-mu * dt) / torch.clamp(mu, min=_MU_FLOOR)
    )
    return torch.clamp(decay * n + coeff * p_term, min=0.0)


def _affine_growth_update(y, a_term, b_term, dt: float):
    """Exact frozen-coefficient solve of y' = a + b·y, clamped non-negative."""
    x = torch.clamp(b_term * dt, -_AFFINE_CLIP, _AFFINE_CLIP)
    tiny = torch.abs(b_term) < _MU_FLOOR
    safe_b = torch.where(tiny, 1.0, b_term)
    coeff = torch.where(tiny, dt, torch.expm1(x) / safe_b)
    return torch.clamp(torch.exp(x) * y + coeff * a_term, min=0.0)


def _chunk_update(plan: CollisionPlan, q, ph, dt: float):
    """One substep for a (C, NE) / (C, NW) block of pixels."""
    ne = plan.num_energy_bins
    dE = plan.dE
    rho = plan.rho[None, :]
    f = q / torch.clamp(rho, min=_RHO_FLOOR)
    partner = rho * torch.clamp(1.0 - f, min=0.0)  # ρ(1−f): pair-breaking target density

    # the accumulators are updated in place: no new (C, NE)/(C, NW) buffer
    # per term
    gain = torch.zeros_like(q)
    loss = torch.zeros_like(q)
    a_ph = torch.zeros_like(ph)
    b_ph = torch.zeros_like(ph)

    if plan.enable_scattering:
        K_s0 = plan.K_s0[None]
        n_diff = ph[:, plan.idx_diff].reshape(-1, ne, ne)
        np_diff = plan.emit_mask * (1.0 + n_diff) + plan.absorb_mask * n_diff
        Ks_eff = K_s0 * np_diff  # (C, NE, NE)
        gain += dE * partner * torch.einsum("cji,cj->ci", Ks_eff, q)
        loss += dE * torch.einsum("cij,cj->ci", Ks_eff, partner)
        if plan.update_phonons:
            base_sc = dE * (q[:, :, None] * K_s0 * partner[:, None, :])
            emit = (base_sc * plan.emit_mask).reshape(-1, ne * ne) @ plan.scatter_diff
            absorb = (base_sc * plan.absorb_mask).reshape(-1, ne * ne) @ plan.scatter_diff
            a_ph += emit
            b_ph += emit - absorb

    if plan.enable_recombination:
        K_r0 = plan.K_r0[None]
        n_sum = ph[:, plan.idx_sum].reshape(-1, ne, ne)
        loss += 2.0 * dE * torch.einsum("cij,cj->ci", K_r0 * (1.0 + n_sum), q)
        gain += 2.0 * dE * partner * torch.einsum("cij,cj->ci", K_r0 * n_sum, partner)
        if plan.update_phonons:
            base_rec = dE * (q[:, :, None] * K_r0 * q[:, None, :])
            rec = base_rec.reshape(-1, ne * ne) @ plan.scatter_sum
            base_pb = dE * (partner[:, :, None] * K_r0 * partner[:, None, :])
            pb = base_pb.reshape(-1, ne * ne) @ plan.scatter_sum
            a_ph += rec
            b_ph += rec - pb

    q_new = _relaxation_update(q, gain, loss, dt)
    ph_new = _affine_growth_update(ph, a_ph, b_ph, dt) if plan.update_phonons else ph
    return q_new, ph_new


def collision_step_plain(
    plan: CollisionPlan,
    n_qp: torch.Tensor,
    n_ph: torch.Tensor,
    dt: float,
    gen: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One collision substep: (NE, Ny, Nx), (NW, Ny, Nx) → new states.

    ``gen`` is an optional (Ny, Nx) plane of forward-Euler increments dt·g
    added to every bin first.  Inputs are not modified.
    """
    if gen is not None:
        n_qp = n_qp + gen[None]
    if not plan.active:
        return n_qp, n_ph
    ne, ny, nx = n_qp.shape
    nw = plan.num_omega
    p_live = ny * nx
    q = n_qp.reshape(ne, p_live).T
    ph = n_ph.reshape(nw, p_live).T
    q_out = torch.empty((p_live, ne), dtype=n_qp.dtype, device=n_qp.device)
    ph_out = torch.empty((p_live, nw), dtype=n_ph.dtype, device=n_ph.device)
    dt = float(dt)
    for lo in range(0, p_live, plan.pixel_chunk):
        hi = min(lo + plan.pixel_chunk, p_live)
        q_out[lo:hi], ph_out[lo:hi] = _chunk_update(plan, q[lo:hi], ph[lo:hi], dt)
    if not plan.update_phonons:
        return q_out.T.reshape(ne, ny, nx), n_ph
    return q_out.T.reshape(ne, ny, nx), ph_out.T.reshape(nw, ny, nx)
