"""Photon-drive collision terms: resonator photons acting on the QP gas.

Implements the photon collision integrals of Fischer et al., "Nonequilibrium
Quasiparticle Distribution in Superconducting Resonators — Effect of
Pair-Breaking Photons" (2024) — the first entry in the reference repo's own
"Not yet Implemented" queue; the reference has no counterpart.  Carried
over from ``qpsim_tpu.ops.photon_drive``: the plans are the same host numpy,
the substeps plain torch on tensors (differentiable ops only).  A single photon mode of energy ω and occupation n̄ couples to
the quasiparticles with rate constant c (the paper's c^QP_Phot, 1/ns):

* **Scattering** (any ω): number-conserving redistribution by absorption /
  stimulated+spontaneous emission of photons, paper Eq. (3)::

      St_s(E) = c·U⁺(E, E+ω)·{ f(E+ω)[1−f(E)](n̄+1) − f(E)[1−f(E+ω)]n̄ }
              + c·U⁺(E, E−ω)·{ f(E−ω)[1−f(E)]n̄ − f(E)[1−f(E−ω)](n̄+1) }

* **Pair breaking** (ω > 2Δ): generation of QP pairs at (E, ω−E), Eq. (4),
  and the reverse recombination with photon emission, Eq. (5)::

      St_g(E) = +c·U⁻(E, ω−E)·n̄·[1−f(E)][1−f(ω−E)]
      St_r(E) = −c·U⁻(E, ω−E)·(1+n̄)·f(ω−E)·f(E)

  with U±(E₁,E₂) = K±(E₁,E₂)·ρ(E₂) and coherence factors
  K±(E₁,E₂) = 1 ± Δ²/(E₁E₂).

In the framework's n(E) = ρ(E)·f(E) state the terms reduce to the same
loss/gain structure as the Fischer–Catelani phonon integrator — losses
µ(E)·n(E), gains partner(E)·G(E) with partner = ρ(1−f) — advanced by the
identical positivity-preserving exponential relaxation
n⁺ = e^{−µ·dt}·n + (1−e^{−µ·dt})·P/µ.  Everything is a single-offset pair
coupling on the uniform energy grid (O(NE·Npix) per substep, vs the
collision operator's O(NE²·Npix)); the JAX package computes it as XLA
elementwise glue with no Pallas kernel, and here it is plain torch.

Detailed balance holds exactly on the grid when ω is grid-aligned: with
n̄ = n_BE(ω_eff, T) and f = f_FD(T), absorption/emission and
generation/recombination balance bin-by-bin.
ω is snapped to the grid (offset k = round(ω/dE) for scattering, pair
index s = round((ω − 2E₀)/dE)); the snapped effective energies are
reported on the plan.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

__all__ = [
    "PhotonDrivePlan",
    "PhotonDrivePlanAnalytic",
    "build_photon_drive_plan",
    "build_photon_drive_plan_analytic",
    "make_photon_substep",
    "make_photon_substep_per_pixel",
    "photon_plan_device",
    "photon_loss_gain",
]

_MU_FLOOR = 1e-30
_EPS_RHO = 1e-12


@dataclass(frozen=True)
class PhotonDrivePlan:
    """Static per-bin coefficient rows for one photon mode on one E-grid."""

    num_bins: int
    k_offset: int              # scattering offset (bins); 0 = inert
    s_index: int               # pair anti-diagonal i+j = s; -1 = inert
    omega_eff_scatter: float   # k·dE (µeV)
    omega_eff_pair: float      # 2E₀ + s·dE (µeV)
    coupling: float            # c (1/ns)
    occupancy: float           # n̄
    # (NE,) float64 coefficient rows, zero where the partner bin is off-grid:
    kp_up: np.ndarray          # K⁺(E_i, E_{i+k})
    kp_dn: np.ndarray          # K⁺(E_i, E_{i−k})
    km_pair: np.ndarray        # K⁻(E_i, E_{s−i})
    rho: np.ndarray            # ρ(E_i) (Dynes)


def build_photon_drive_plan(
    *,
    E_bins: np.ndarray,
    dE: float,
    gap: float,
    rho: np.ndarray,
    omega: float,
    coupling: float,
    occupancy: float,
    include_scattering: bool = True,
    include_pair_breaking: bool = True,
) -> PhotonDrivePlan:
    """Precompute the static coefficient rows for one photon mode.

    ``rho`` is the (Dynes) DOS on the grid — passed in rather than
    recomputed so the drive shares the engine's exact DOS.  Pair-breaking
    terms are built only when ω exceeds 2Δ AND the anti-diagonal intersects
    the grid; scattering only when the offset k ≥ 1 fits on the grid.
    """
    e = np.asarray(E_bins, dtype=np.float64)
    ne = int(e.size)
    rho = np.asarray(rho, dtype=np.float64).reshape(ne)
    if ne < 2:
        raise ValueError("photon drive needs an energy-resolved grid (>= 2 bins)")
    step = float(dE)
    gap2 = float(gap) ** 2

    kp_up = np.zeros(ne)
    kp_dn = np.zeros(ne)
    km_pair = np.zeros(ne)

    k = int(round(float(omega) / step)) if include_scattering else 0
    if k < 1 or k >= ne:
        k = 0
    if k:
        i = np.arange(ne - k)
        kp_up[i] = 1.0 + gap2 / (e[i] * e[i + k])
        kp_dn[i + k] = 1.0 + gap2 / (e[i + k] * e[i])

    s = int(round((float(omega) - 2.0 * e[0]) / step)) if include_pair_breaking else -1
    if not (float(omega) > 2.0 * float(gap) and 0 <= s <= 2 * (ne - 1)):
        s = -1
    if s >= 0:
        i = np.arange(max(0, s - ne + 1), min(ne, s + 1))
        km_pair[i] = np.maximum(1.0 - gap2 / (e[i] * e[s - i]), 0.0)

    return PhotonDrivePlan(
        num_bins=ne,
        k_offset=k,
        s_index=s,
        omega_eff_scatter=k * step,
        omega_eff_pair=(2.0 * e[0] + s * step) if s >= 0 else 0.0,
        coupling=float(coupling),
        occupancy=float(occupancy),
        kp_up=kp_up,
        kp_dn=kp_dn,
        km_pair=km_pair,
        rho=rho,
    )


@dataclass(frozen=True)
class PhotonDrivePlanAnalytic:
    """Δ²-affine photon-drive structure for spatially varying gaps.

    The coherence factors K±(E₁,E₂) = 1 ± Δ²/(E₁E₂) are affine in Δ² — the
    same identity the analytic collision kernels exploit — so one static
    inverse-energy row per channel plus a per-pixel Δ² plane replaces the
    per-gap coefficient tables.  The grid snap (offset k, anti-diagonal s)
    is global: the energy grid is shared by all pixels; only Δ varies.
    """

    num_bins: int
    k_offset: int              # scattering offset (bins); 0 = inert
    s_index: int               # pair anti-diagonal i+j = s; -1 = inert
    omega: float               # raw ω (µeV) — per-pixel 2Δ(x) gate uses it
    omega_eff_scatter: float
    omega_eff_pair: float
    coupling: float
    occupancy: float
    # (NE,) float64 rows: indicator = 1 where the partner bin is on-grid,
    # inv = 1/(E_i·E_partner) there (0 elsewhere):
    ind_up: np.ndarray
    inv_up: np.ndarray
    ind_dn: np.ndarray
    inv_dn: np.ndarray
    ind_pair: np.ndarray
    inv_pair: np.ndarray


def build_photon_drive_plan_analytic(
    *,
    E_bins: np.ndarray,
    dE: float,
    omega: float,
    coupling: float,
    occupancy: float,
    include_scattering: bool = True,
    include_pair_breaking: bool = True,
) -> PhotonDrivePlanAnalytic:
    """Precompute the gap-independent structure for a per-pixel-gap drive.

    Unlike :func:`build_photon_drive_plan` the pair channel is kept
    whenever the anti-diagonal intersects the grid — the physical ω > 2Δ
    threshold is applied per pixel inside the substep (ω² > 4Δ²(x)), so a
    gap-gradient film pair-breaks exactly where the local gap allows it.
    """
    e = np.asarray(E_bins, dtype=np.float64)
    ne = int(e.size)
    if ne < 2:
        raise ValueError("photon drive needs an energy-resolved grid (>= 2 bins)")
    step = float(dE)

    ind_up = np.zeros(ne)
    inv_up = np.zeros(ne)
    ind_dn = np.zeros(ne)
    inv_dn = np.zeros(ne)
    ind_pair = np.zeros(ne)
    inv_pair = np.zeros(ne)

    k = int(round(float(omega) / step)) if include_scattering else 0
    if k < 1 or k >= ne:
        k = 0
    if k:
        i = np.arange(ne - k)
        ind_up[i] = 1.0
        inv_up[i] = 1.0 / (e[i] * e[i + k])
        ind_dn[i + k] = 1.0
        inv_dn[i + k] = 1.0 / (e[i + k] * e[i])

    s = int(round((float(omega) - 2.0 * e[0]) / step)) if include_pair_breaking else -1
    if not (0 <= s <= 2 * (ne - 1)):
        s = -1
    if s >= 0:
        i = np.arange(max(0, s - ne + 1), min(ne, s + 1))
        ind_pair[i] = 1.0
        inv_pair[i] = 1.0 / (e[i] * e[s - i])

    return PhotonDrivePlanAnalytic(
        num_bins=ne,
        k_offset=k,
        s_index=s,
        omega=float(omega),
        omega_eff_scatter=k * step,
        omega_eff_pair=(2.0 * e[0] + s * step) if s >= 0 else 0.0,
        coupling=float(coupling),
        occupancy=float(occupancy),
        ind_up=ind_up,
        inv_up=inv_up,
        ind_dn=ind_dn,
        inv_dn=inv_dn,
        ind_pair=ind_pair,
        inv_pair=inv_pair,
    )


def _pad0(x: torch.Tensor, before: int, after: int) -> torch.Tensor:
    """``x`` zero-padded along axis 0."""
    parts = []
    if before:
        parts.append(x.new_zeros((before, *x.shape[1:])))
    parts.append(x)
    if after:
        parts.append(x.new_zeros((after, *x.shape[1:])))
    return torch.cat(parts) if len(parts) > 1 else x


def _shift_up(x: torch.Tensor, k: int) -> torch.Tensor:
    """y[i] = x[i+k] along axis 0, zero-filled."""
    return _pad0(x[k:], 0, k)


def _shift_dn(x: torch.Tensor, k: int) -> torch.Tensor:
    """y[i] = x[i−k] along axis 0, zero-filled."""
    return _pad0(x[:-k], k, 0)


def _flip_pair(x: torch.Tensor, s: int, ne: int) -> torch.Tensor:
    """y[i] = x[s−i] along axis 0, zero where s−i is off-grid."""
    lo = max(0, s - ne + 1)
    hi = min(ne, s + 1)
    seg = x[s - hi + 1 : s - lo + 1].flip(0)
    return _pad0(seg, lo, ne - hi)


def photon_plan_device(plan: PhotonDrivePlan, dtype=torch.float64, device="cuda") -> dict:
    """Device-ready coefficient columns + static indices for a plan."""
    ne = plan.num_bins
    col = lambda v: torch.as_tensor(np.asarray(v), dtype=dtype, device=device).reshape(ne, 1)
    return dict(
        ne=ne,
        k=plan.k_offset,
        s=plan.s_index,
        kp_up=col(plan.kp_up),
        kp_dn=col(plan.kp_dn),
        km=col(plan.km_pair),
        rho=col(plan.rho),
    )


def photon_loss_gain(q: torch.Tensor, partner: torch.Tensor, nbar, dev: dict):
    """Unscaled photon (µ, G) accumulators for (NE, P) state columns.

    ``nbar`` may be a tensor (a differentiable photon occupation).  The
    caller folds the rate constant (amp·c·weight) into both and advances
    with its own positivity-preserving update; losses enter as µ·n, gains
    as partner·G.
    """
    mu = torch.zeros_like(q)
    gain = torch.zeros_like(q)
    k, s, ne = dev["k"], dev["s"], dev["ne"]
    if k:
        mu = mu + dev["kp_up"] * (nbar * _shift_up(partner, k)) + dev["kp_dn"] * (
            (nbar + 1.0) * _shift_dn(partner, k)
        )
        gain = gain + dev["kp_up"] * ((nbar + 1.0) * _shift_up(q, k)) + dev["kp_dn"] * (
            nbar * _shift_dn(q, k)
        )
    if s >= 0:
        mu = mu + dev["km"] * ((1.0 + nbar) * _flip_pair(q, s, ne))
        gain = gain + dev["km"] * (nbar * _flip_pair(partner, s, ne))
    return mu, gain


def _rate(amp, c: float, weight: torch.Tensor | None, dtype) -> torch.Tensor | float:
    """amp·c, times the spatial weight row when one is given."""
    rate = amp.to(dtype) * c if isinstance(amp, torch.Tensor) else float(amp) * c
    if weight is not None:
        rate = rate * weight.to(dtype).reshape(1, -1)
    return rate


def make_photon_substep(plan: PhotonDrivePlan, dt: float, dtype=torch.float64, device="cuda"):
    """Build ``(n_qp, amp[, weight]) -> n_qp`` advancing the photon terms by ``dt``.

    ``n_qp`` is (NE, ...) with any trailing spatial shape, on ``device``;
    ``amp`` is a scalar gate (0 outside the drive window, 1 inside — folded
    into the rates, so the step is branchless and a gated-off step is the
    identity on a non-negative state).  ``weight`` is an optional spatial
    rate profile over the trailing shape (the engine passes the geometry
    mask so pair-breaking generation never creates QPs outside the film).
    Positivity-preserving exponential relaxation, matching the collision
    integrator's update form (ops/collisions.py).
    """
    dt = float(dt)
    c = plan.coupling
    ne = plan.num_bins
    dev = photon_plan_device(plan, dtype, device)
    rho_c = dev["rho"]
    safe_rho = torch.clamp(rho_c, min=_EPS_RHO)
    has_rho = rho_c > _EPS_RHO

    def substep(
        n_qp: torch.Tensor,
        amp,
        weight: torch.Tensor | None = None,
        nbar=None,
    ) -> torch.Tensor:
        shape = n_qp.shape
        q = n_qp.reshape(ne, -1).to(dtype)
        f = torch.where(has_rho, q / safe_rho, 0.0)
        partner = torch.where(has_rho, rho_c * torch.clamp(1.0 - f, min=0.0), 0.0)

        nb = _nbar_or_plan(nbar, plan.occupancy, dtype)
        mu, gain = photon_loss_gain(q, partner, nb, dev)

        rate = _rate(amp, c, weight, dtype)
        mu = rate * mu
        p_total = partner * (rate * gain)
        return _relax(q, mu, p_total, dt).reshape(shape).to(n_qp.dtype)

    return substep


def _nbar_or_plan(nbar, plan_value: float, dtype):
    """Resolve the runtime photon-occupancy override.

    ``None`` → the plan's scalar; a scalar → used as-is (the differentiable
    API); an array → reshaped to an (1, Npix) row so a per-pixel/per-member
    n̄ plane broadcasts against (NE, Npix) terms."""
    if nbar is None:
        return plan_value
    nb = torch.as_tensor(nbar, dtype=dtype)
    return nb.reshape(1, -1) if nb.ndim > 0 else nb


def _relax(q: torch.Tensor, mu: torch.Tensor, p_total: torch.Tensor, dt: float) -> torch.Tensor:
    """Positivity-preserving exponential relaxation n⁺ = e^{−µdt}n + (1−e^{−µdt})P/µ."""
    x = mu * dt
    decay = torch.exp(-x)
    taylor = x * (1.0 - x * (0.5 - x * ((1.0 / 6.0) - x * (1.0 / 24.0))))
    one_minus_decay = torch.where(x < 1e-2, taylor, 1.0 - decay)
    coeff = torch.where(
        mu < _MU_FLOOR, dt, one_minus_decay / torch.clamp(mu, min=_MU_FLOOR)
    )
    return torch.clamp(decay * q + coeff * p_total, min=0.0)


def make_photon_substep_per_pixel(
    plan: PhotonDrivePlanAnalytic, dt: float, dtype=torch.float64, device="cuda"
):
    """Build ``(n_qp, amp, weight, delta2, rho) -> n_qp`` for gap-map films.

    Same operator as :func:`make_photon_substep` with the coefficients
    evaluated per pixel from the Δ²-affine identity: ``delta2`` is a Δ²(x,y)
    array broadcastable over the trailing spatial shape and ``rho`` the
    per-pixel Dynes DOS shaped like ``n_qp`` (the engine's Pauli ρ state).
    The physical pair-breaking threshold is applied per pixel
    (ω² > 4Δ²(x)), so a drive above threshold only in part of the film
    generates QPs only there.  Out-of-film pixels have ρ = 0, which makes
    the substep the identity.
    """
    dt = float(dt)
    c = plan.coupling
    ne = plan.num_bins
    k, s = plan.k_offset, plan.s_index
    omega2 = plan.omega * plan.omega
    col = lambda v: torch.as_tensor(np.asarray(v), dtype=dtype, device=device).reshape(ne, 1)
    ind_up, inv_up = col(plan.ind_up), col(plan.inv_up)
    ind_dn, inv_dn = col(plan.ind_dn), col(plan.inv_dn)
    ind_pair, inv_pair = col(plan.ind_pair), col(plan.inv_pair)

    def substep(
        n_qp: torch.Tensor,
        amp,
        weight: torch.Tensor | None,
        delta2: torch.Tensor,
        rho: torch.Tensor,
        nbar=None,
    ) -> torch.Tensor:
        shape = n_qp.shape
        q = n_qp.reshape(ne, -1).to(dtype)
        rho_c = rho.to(dtype).reshape(ne, -1)
        d2 = delta2.to(dtype).reshape(1, -1)
        safe_rho = torch.clamp(rho_c, min=_EPS_RHO)
        has_rho = rho_c > _EPS_RHO
        f = torch.where(has_rho, q / safe_rho, 0.0)
        partner = torch.where(has_rho, rho_c * torch.clamp(1.0 - f, min=0.0), 0.0)

        pair_gate = (omega2 > 4.0 * d2).to(dtype)
        dev = dict(
            ne=ne,
            k=k,
            s=s,
            kp_up=ind_up * (1.0 + d2 * inv_up),
            kp_dn=ind_dn * (1.0 + d2 * inv_dn),
            km=pair_gate * ind_pair * torch.clamp(1.0 - d2 * inv_pair, min=0.0),
            rho=rho_c,
        )
        nb = _nbar_or_plan(nbar, plan.occupancy, dtype)
        mu, gain = photon_loss_gain(q, partner, nb, dev)
        rate = _rate(amp, c, weight, dtype)
        mu = rate * mu
        p_total = partner * (rate * gain)
        return _relax(q, mu, p_total, dt).reshape(shape).to(n_qp.dtype)

    return substep
