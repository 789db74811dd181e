"""Coupled quasiparticle–phonon collision integrator (Fischer–Catelani local).

The plain PyTorch versions of the collision substep, carried over from
``qpsim_tpu.ops.collisions`` (``build_collision_plan_arrays``,
``make_collision_step``): the same batched einsums over pixels, the same
one-hot ω-scatter matmuls and the same exponential updates.  They are the
CPU path and the plain versions the CUDA kernels (``ops.collisions_cuda``,
``csrc/collisions.cu``) are held against:

* :func:`collision_step_plain` — tables per unique gap (G, NE[, NE]),
  gathered per pixel by a dense gap-id plane (K3's plain version; G = 1 is
  a uniform film);
* :func:`collision_step_analytic_plain` — continuous gap maps: K^s₀ and
  K^r₀ affine in Δ²(px) and the Dynes ρ in closed form of Δ², from four
  (NE, NE) tables and a Δ² plane (K4's plain version; the JAX package's
  ``pallas_collisions._make_analytic_kernel``), with no bound on G;
* :func:`make_collision_step` — ``make_collision_step`` of the JAX package:
  ``step(n_qp, n_ph[, gap_id])`` of a per-gap-table plan, the plain
  version on the CPU and the kernels on the card
  (``ops.collisions_blocked_cuda.plan_launcher``).

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
injection the CUDA kernels fuse).
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from .kernels import recombination_kernel_base, scattering_kernel_base
from .phonon_map import PhononFrequencyMap

__all__ = [
    "DEFAULT_PIXEL_CHUNK",
    "AnalyticTables",
    "CollisionPlan",
    "build_analytic_plan",
    "build_collision_plan_arrays",
    "collision_step_analytic_plain",
    "collision_step_plain",
    "make_collision_step",
]

#: default number of pixels processed per chunk.
DEFAULT_PIXEL_CHUNK = 4096

_MU_FLOOR = 1e-14
_AFFINE_CLIP = 80.0
_RHO_FLOOR = 1e-30


@dataclass
class CollisionPlan:
    """Device tables of the collision substep.

    ``rho``/``K_r0``/``K_s0`` hold one table per unique gap (G of them;
    G == 1 for a uniform film) and ``gap_id`` each dense pixel's index into
    them (None when G == 1).  An analytic plan (:func:`build_analytic_plan`)
    carries no per-gap tables at all: its constants come from
    :class:`AnalyticTables`.  The host maps (``*_np``) feed the CUDA
    kernels' pair tables (``ops.collisions_cuda``); the rest feeds the
    plain einsum versions.
    """

    dE: float
    rho: torch.Tensor | None  # (G, NE)
    K_r0: torch.Tensor | None  # (G, NE, NE)
    K_s0: torch.Tensor | None  # (G, NE, NE)
    gap_id: torch.Tensor | None  # (Ny*Nx,) uint8 (G ≤ 256) or int32, None for G == 1
    idx_diff: torch.Tensor  # (NE*NE,) int64
    idx_sum: torch.Tensor  # (NE*NE,) int64
    emit_mask: torch.Tensor  # (NE, NE) 1.0 where E_i > E_j
    absorb_mask: torch.Tensor  # (NE, NE) 1.0 where E_i < E_j
    enable_recombination: bool
    enable_scattering: bool
    update_phonons: bool
    num_energy_bins: int
    num_omega: int
    pixel_chunk: int
    # host copies, for the kernels' pair tables
    idx_diff_np: np.ndarray  # (NE, NE) int32
    idx_sum_np: np.ndarray  # (NE, NE) int32
    diff_sign_np: np.ndarray  # (NE, NE) int8

    @property
    def active(self) -> bool:
        return self.enable_scattering or self.enable_recombination

    @property
    def num_gaps(self) -> int:
        return 0 if self.rho is None else int(self.rho.shape[0])


def _pair_map_fields(pmap: PhononFrequencyMap, device, dtype: torch.dtype) -> dict:
    """The plan's ω-map fields, shared by the gather and the analytic plans."""
    as_dev = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=dtype, device=device)
    sign = np.asarray(pmap.diff_sign)
    return dict(
        idx_diff=torch.as_tensor(pmap.idx_diff.reshape(-1), dtype=torch.int64, device=device),
        idx_sum=torch.as_tensor(pmap.idx_sum.reshape(-1), dtype=torch.int64, device=device),
        emit_mask=as_dev(sign > 0),
        absorb_mask=as_dev(sign < 0),
        num_omega=pmap.num_omega,
        idx_diff_np=np.asarray(pmap.idx_diff, dtype=np.int32),
        idx_sum_np=np.asarray(pmap.idx_sum, dtype=np.int32),
        diff_sign_np=sign.astype(np.int8),
    )


def _device_dtype(device, dtype):
    """The builders' device and dtype: float32 on CUDA, float64 on the CPU unless asked."""
    device = torch.device(device)
    return device, dtype or (torch.float32 if device.type == "cuda" else torch.float64)


#: the JAX package's keyword names of the per-gap tables, and the port's
_JAX_NAMES = {"rho_by_gap": "rho", "K_r0_by_gap": "K_r0", "K_s0_by_gap": "K_s0"}


def build_collision_plan_arrays(
    *,
    dE: float,
    rho: np.ndarray | None = None,
    K_r0: np.ndarray | None = None,
    K_s0: np.ndarray | None = None,
    pmap: PhononFrequencyMap,
    enable_recombination: bool,
    enable_scattering: bool,
    update_phonons: bool,
    device: torch.device | str = "cuda",
    dtype: torch.dtype | None = None,
    pixel_chunk: int = DEFAULT_PIXEL_CHUNK,
    gap_id: np.ndarray | None = None,
    **jax_names,
) -> CollisionPlan:
    """Upload host-precomputed collision data (float64 numpy) as a plan.

    ``rho`` is (NE,) for one gap or (G, NE) per unique gap, ``K_r0``/``K_s0``
    (NE, NE) or (G, NE, NE) to match.  The JAX package's names
    ``rho_by_gap``, ``K_r0_by_gap`` and ``K_s0_by_gap`` are aliases; giving
    both spellings of one table raises ``TypeError``.  ``gap_id`` is the
    dense (Ny, Nx) plane of gap indices (0 on masked-out cells, whose state
    is zero); it may be None when G == 1.  It is kept as uint8 while
    G ≤ 256, the form K3 reads, so the card holds one copy of it.
    ``device`` is "cuda" by default, ``dtype`` float32 on CUDA and float64
    on the CPU unless given.
    """
    tables = {"rho": rho, "K_r0": K_r0, "K_s0": K_s0}
    for name, value in jax_names.items():
        if name not in _JAX_NAMES:
            raise TypeError(f"build_collision_plan_arrays() got an unexpected keyword argument {name!r}")
        port = _JAX_NAMES[name]
        if tables[port] is not None:
            raise TypeError(f"build_collision_plan_arrays() got both {port!r} and its JAX name {name!r}")
        tables[port] = value
    rho, K_r0, K_s0 = tables["rho"], tables["K_r0"], tables["K_s0"]
    if rho is None:
        raise TypeError("build_collision_plan_arrays() needs 'rho' (or its JAX name 'rho_by_gap')")
    device, dtype = _device_dtype(device, dtype)
    by_gap = lambda a, nd: None if a is None else np.asarray(a, dtype=np.float64).reshape(
        (-1,) + np.shape(a)[-nd:]
    )
    rho_g, kr_g, ks_g = by_gap(rho, 1), by_gap(K_r0, 2), by_gap(K_s0, 2)
    n_gaps = rho_g.shape[0]
    if gap_id is None and n_gaps != 1:
        raise ValueError(f"{n_gaps} gap tables need a gap_id plane")
    as_dev = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    return CollisionPlan(
        dE=float(dE),
        rho=as_dev(rho_g),
        K_r0=None if kr_g is None or not enable_recombination else as_dev(kr_g),
        K_s0=None if ks_g is None or not enable_scattering else as_dev(ks_g),
        gap_id=None if n_gaps == 1 else torch.as_tensor(
            np.asarray(gap_id).reshape(-1),
            dtype=torch.uint8 if n_gaps <= 256 else torch.int32, device=device,
        ),
        enable_recombination=bool(enable_recombination and K_r0 is not None),
        enable_scattering=bool(enable_scattering and K_s0 is not None),
        update_phonons=bool(update_phonons),
        num_energy_bins=int(rho_g.shape[1]),
        pixel_chunk=int(pixel_chunk),
        **_pair_map_fields(pmap, device, dtype),
    )


@dataclass
class AnalyticTables:
    """Constants of the analytic-gap substep (K4), in the state dtype.

    K^s₀ = a_s·max(1 − Δ²/(EᵢEⱼ), 0) and K^r₀ = a_r·(1 + Δ²/(EᵢEⱼ)) are
    affine in Δ², so per pixel dE·K^s₀ = max(dEa_s − dEb_s·Δ², 0) and
    2dE·K^r₀ = dEa2_r + dEb2_r·Δ²; the four tables are built in float64.
    The Dynes ρ comes from ``e2`` = Eᵢ² − γ² and ``zi`` = −2Eᵢγ (rounded
    once each, as the TPU kernel's constants are).
    """

    gamma: float
    E: torch.Tensor  # (NE,)
    inv_E: torch.Tensor  # (NE,)
    e2: torch.Tensor  # (NE,) E² − γ²
    zi: torch.Tensor  # (NE,) −2Eγ
    dEa_s: torch.Tensor | None  # (NE, NE) dE·a_s, None when scattering is off
    dEb_s: torch.Tensor | None  # (NE, NE) dE·a_s/(EᵢEⱼ)
    dEa2_r: torch.Tensor | None  # (NE, NE) 2dE·a_r, None when recombination is off
    dEb2_r: torch.Tensor | None  # (NE, NE) 2dE·a_r/(EᵢEⱼ)
    g2: torch.Tensor  # (Ny*Nx,) Δ² per dense pixel


def build_analytic_plan(
    *,
    E_bins: np.ndarray,
    dE: float,
    gap_plane: np.ndarray,
    pmap: PhononFrequencyMap,
    tau_s: float | None,
    tau_r: float | None,
    T_c: float,
    dynes_gamma: float,
    update_phonons: bool,
    device: torch.device | str,
    dtype: torch.dtype,
    pixel_chunk: int = DEFAULT_PIXEL_CHUNK,
) -> tuple[CollisionPlan, AnalyticTables]:
    """The plan (ω maps, flags) and tables of the analytic-gap substep.

    ``gap_plane`` is the dense (Ny, Nx) gap map in µeV (masked-out cells
    may hold any finite value); ``tau_s``/``tau_r`` None turn a channel
    off.  Tables as ``build_pallas_collision_step_analytic`` builds them.
    """
    e = np.asarray(E_bins, dtype=np.float64)
    gamma = float(dynes_gamma)
    prod = np.maximum(e[:, None] * e[None, :], 1e-30)
    as_dev = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=dtype, device=device)
    tabs: dict = dict(dEa_s=None, dEb_s=None, dEa2_r=None, dEb2_r=None)
    if tau_s is not None:
        a_s = scattering_kernel_base(e, 0.0, float(tau_s), T_c)  # coherence ≡ 1
        tabs.update(dEa_s=as_dev(dE * a_s), dEb_s=as_dev(dE * (a_s / prod)))
    if tau_r is not None:
        a_r = recombination_kernel_base(e, 0.0, float(tau_r), T_c)
        tabs.update(dEa2_r=as_dev(2.0 * dE * a_r), dEb2_r=as_dev(2.0 * dE * (a_r / prod)))
    tables = AnalyticTables(
        gamma=gamma, E=as_dev(e), inv_E=as_dev(1.0 / e), e2=as_dev(e * e - gamma * gamma),
        zi=as_dev(-2.0 * e * gamma),
        g2=as_dev(np.asarray(gap_plane, dtype=np.float64).reshape(-1) ** 2), **tabs,
    )
    plan = CollisionPlan(
        dE=float(dE), rho=None, K_r0=None, K_s0=None, gap_id=None,
        enable_recombination=tau_r is not None, enable_scattering=tau_s is not None,
        update_phonons=bool(update_phonons), num_energy_bins=int(e.size),
        pixel_chunk=int(pixel_chunk), **_pair_map_fields(pmap, device, dtype),
    )
    return plan, tables


def analytic_rho(tables: AnalyticTables, g2: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(ρ, 1/ρ) of shape (C, NE) from a (C,) Δ² chunk, in closed form.

    Dynes: ρ = max(Re((E−iγ)/√((E−iγ)² − Δ²)), 0); with z = (E² − γ² − Δ²)
    − 2iEγ the principal root is s + i·t, s = √((|z| + Re z)/2),
    t = −√((|z| − Re z)/2).  1/ρ is 0 where ρ vanishes.
    """
    g2 = g2[:, None]
    if tables.gamma == 0.0:
        r2 = tables.e2 - g2
        t = torch.rsqrt(torch.clamp(r2, min=_RHO_FLOOR))
        pos = r2 > 0.0
        rho = torch.where(pos, tables.E * t, 0.0)
        inv = torch.where(pos, (r2 * t) * tables.inv_E, 0.0)
        return rho, inv
    zr = tables.e2 - g2
    zi = tables.zi
    r = torch.sqrt(zr * zr + zi * zi)
    s = torch.sqrt(torch.clamp(0.5 * (r + zr), min=0.0))
    tq = -torch.sqrt(torch.clamp(0.5 * (r - zr), min=0.0))
    rho = torch.clamp((tables.E * s - tables.gamma * tq) / torch.clamp(r, min=_RHO_FLOOR), min=0.0)
    inv = torch.where(rho > _RHO_FLOOR, 1.0 / torch.clamp(rho, min=_RHO_FLOOR), 0.0)
    return rho, inv


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


def _pair_update(plan: CollisionPlan, q, ph, partner, ks, kr2, dt: float):
    """The substep of a (C, NE) / (C, NW) block from its per-pixel constants.

    ``ks`` is dE·K^s₀ and ``kr2`` 2dE·K^r₀, each (C or 1, NE, NE) or None.
    The pair terms reach their ω rows by ``index_add_`` over the plan's
    pair-to-row maps, where the JAX package multiplies by (NE², NW) one-hot
    matrices: the same sums, in another order, without those matrices
    (2 × 12.9 GB in float32 at 1024 bins).
    """
    ne = plan.num_energy_bins
    to_rows = lambda terms, idx: torch.zeros_like(ph).index_add_(1, idx, terms.reshape(-1, ne * ne))
    # the accumulators are updated in place: no new (C, NE)/(C, NW) buffer
    # per term
    gain = torch.zeros_like(q)
    loss = torch.zeros_like(q)
    a_ph = torch.zeros_like(ph)
    b_ph = torch.zeros_like(ph)

    if ks is not None:
        n_diff = ph[:, plan.idx_diff].reshape(-1, ne, ne)
        np_diff = plan.emit_mask * (1.0 + n_diff) + plan.absorb_mask * n_diff
        Ks_eff = ks * np_diff  # (C, NE, NE)
        gain += partner * torch.einsum("cji,cj->ci", Ks_eff, q)
        loss += torch.einsum("cij,cj->ci", Ks_eff, partner)
        if plan.update_phonons:
            base_sc = q[:, :, None] * ks * partner[:, None, :]
            emit = to_rows(base_sc * plan.emit_mask, plan.idx_diff)
            absorb = to_rows(base_sc * plan.absorb_mask, plan.idx_diff)
            a_ph += emit
            b_ph += emit - absorb

    if kr2 is not None:
        n_sum = ph[:, plan.idx_sum].reshape(-1, ne, ne)
        loss += torch.einsum("cij,cj->ci", kr2 * (1.0 + n_sum), q)
        gain += partner * torch.einsum("cij,cj->ci", kr2 * n_sum, partner)
        if plan.update_phonons:
            kr = 0.5 * kr2  # dE·K^r₀
            rec = to_rows(q[:, :, None] * kr * q[:, None, :], plan.idx_sum)
            pb = to_rows(partner[:, :, None] * kr * partner[:, None, :], plan.idx_sum)
            a_ph += rec
            b_ph += rec - pb

    q_new = _relaxation_update(q, gain, loss, dt)
    ph_new = _affine_growth_update(ph, a_ph, b_ph, dt) if plan.update_phonons else ph
    return q_new, ph_new


def _chunk_update(plan: CollisionPlan, q, ph, gid, dt: float):
    """One substep of a block of pixels with per-gap tables (``gid`` (C,) or None)."""
    if gid is None:  # one gap: the tables broadcast over the block
        rho, K_s0, K_r0 = plan.rho, plan.K_s0, plan.K_r0
    else:
        rho = plan.rho[gid]
        K_s0 = None if plan.K_s0 is None else plan.K_s0[gid]
        K_r0 = None if plan.K_r0 is None else plan.K_r0[gid]
    f = q / torch.clamp(rho, min=_RHO_FLOOR)
    partner = rho * torch.clamp(1.0 - f, min=0.0)  # ρ(1−f): pair-breaking target density
    dE = plan.dE
    ks = None if not plan.enable_scattering else dE * K_s0
    kr2 = None if not plan.enable_recombination else 2.0 * dE * K_r0
    return _pair_update(plan, q, ph, partner, ks, kr2, dt)


def _analytic_chunk_update(plan: CollisionPlan, tables: AnalyticTables, q, ph, g2, dt: float):
    """One substep of a block of pixels from their Δ² (``g2`` (C,))."""
    rho, inv = analytic_rho(tables, g2)
    partner = rho * torch.clamp(1.0 - q * inv, min=0.0)
    g2c = g2[:, None, None]
    ks = (
        torch.clamp(tables.dEa_s - tables.dEb_s * g2c, min=0.0)
        if plan.enable_scattering else None
    )
    kr2 = tables.dEa2_r + tables.dEb2_r * g2c if plan.enable_recombination else None
    return _pair_update(plan, q, ph, partner, ks, kr2, dt)


def _chunked(plan: CollisionPlan, n_qp, n_ph, gen, update):
    """Run ``update(q, ph, lo, hi)`` over pixel chunks of (NE, Ny, Nx) / (NW, Ny, Nx) states."""
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
    for lo in range(0, p_live, plan.pixel_chunk):
        hi = min(lo + plan.pixel_chunk, p_live)
        q_out[lo:hi], ph_out[lo:hi] = update(q[lo:hi], ph[lo:hi], lo, hi)
    if not plan.update_phonons:
        return q_out.T.reshape(ne, ny, nx), n_ph
    return q_out.T.reshape(ne, ny, nx), ph_out.T.reshape(nw, ny, nx)


def _check_pixels(name: str, table: torch.Tensor | None, n_qp: torch.Tensor) -> None:
    if table is not None and table.numel() != n_qp.shape[1] * n_qp.shape[2]:
        raise ValueError(f"{name} holds {table.numel()} pixels, the state {tuple(n_qp.shape[1:])}")


def collision_step_plain(
    plan: CollisionPlan,
    n_qp: torch.Tensor,
    n_ph: torch.Tensor,
    dt: float,
    gen: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One collision substep: (NE, Ny, Nx), (NW, Ny, Nx) → new states.

    Each pixel takes its gap's tables (``plan.gap_id``).  ``gen`` is an
    optional (Ny, Nx) plane of forward-Euler increments dt·g added to every
    bin first.  Inputs are not modified.
    """
    if plan.rho is None:
        raise ValueError("an analytic plan runs collision_step_analytic_plain")
    _check_pixels("gap_id", plan.gap_id, n_qp)
    gid = plan.gap_id
    dt = float(dt)
    return _chunked(
        plan, n_qp, n_ph, gen,
        # .long(): a uint8 index tensor would act as a boolean mask
        lambda q, ph, lo, hi: _chunk_update(plan, q, ph, None if gid is None else gid[lo:hi].long(), dt),
    )


def collision_step_analytic_plain(
    plan: CollisionPlan,
    tables: AnalyticTables,
    n_qp: torch.Tensor,
    n_ph: torch.Tensor,
    dt: float,
    gen: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The analytic-gap collision substep; same contract as :func:`collision_step_plain`."""
    _check_pixels("g2", tables.g2, n_qp)
    dt = float(dt)
    return _chunked(
        plan, n_qp, n_ph, gen,
        lambda q, ph, lo, hi: _analytic_chunk_update(plan, tables, q, ph, tables.g2[lo:hi], dt),
    )


def make_collision_step(plan: CollisionPlan, dt: float, *, gap_id_arg: bool = False):
    """``step(n_qp, n_ph) -> (n_qp, n_ph)`` for one collision substep of ``dt``.

    The JAX package's ``make_collision_step``: states (NE, Ny, Nx) and (NW,
    Ny, Nx), the plan's per-gap tables chosen by its ``gap_id`` plane, the
    identity with no channel on.  A plan on the CPU runs
    :func:`collision_step_plain`; a plan on the card launches the kernel of
    ``ops.collisions_blocked_cuda.plan_launcher`` (K3 or K5; more than eight
    per-gap tables on K5 with int32 gap ids), built here once.  With
    ``gap_id_arg=True`` the step takes a third argument, a dense (Ny, Nx)
    gap-id plane used instead of the plan's (the form spatially sharded
    callers need); a uniform plan ignores it.
    """
    if plan.rho is None:
        raise ValueError("make_collision_step takes a plan of per-gap tables; an analytic plan "
                         "runs collision_step_analytic")
    dt = float(dt)
    if not plan.active:
        if gap_id_arg:
            return lambda n_qp, n_ph, gap_id: (n_qp, n_ph)
        return lambda n_qp, n_ph: (n_qp, n_ph)
    device = plan.emit_mask.device
    launch = None
    if device.type == "cuda":
        from .collisions_blocked_cuda import plan_launcher  # the kernels; that module imports this one

        launch = plan_launcher(plan)

    def run(p: CollisionPlan, n_qp: torch.Tensor, n_ph: torch.Tensor):
        if n_qp.device.type != device.type:
            raise ValueError(f"n_qp is on {n_qp.device}; this step was built for {device}")
        if launch is None:
            return collision_step_plain(p, n_qp, n_ph, dt)
        return launch(p, n_qp, n_ph, dt)

    if not gap_id_arg:
        step = lambda n_qp, n_ph: run(plan, n_qp, n_ph)
        # what a caller timing the kernel needs: the plan, the tables, the plain version
        step.plan, step.tables = plan, getattr(launch, "tables", None)
        step.plain = lambda n_qp, n_ph: collision_step_plain(plan, n_qp, n_ph, dt)
        return step

    def step_with_gid(n_qp: torch.Tensor, n_ph: torch.Tensor, gap_id) -> tuple[torch.Tensor, torch.Tensor]:
        if plan.gap_id is None:  # one gap: every pixel takes its tables
            return run(plan, n_qp, n_ph)
        ids = torch.as_tensor(gap_id, device=device).reshape(-1).to(plan.gap_id.dtype).contiguous()
        return run(replace(plan, gap_id=ids), n_qp, n_ph)

    return step_with_gid
