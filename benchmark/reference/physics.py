"""Host tables of the film physics, worked out from a configuration (float64 numpy).

A frozen copy of the formulas the simulation states (Fischer–Catelani
collision kernels, BCS density of states, Bose–Einstein phonons, the
cell-centred energy grid and the pair-energy phonon grid), so that the
plain reference needs nothing of the program under test.  k_B is the
CODATA value in µeV/K.
"""

from __future__ import annotations

import numpy as np

K_B_UEV_PER_K = 86.17333262145
EXP_CLIP = 500.0


def energy_grid(gap: float, f_min: float, f_max: float, ne: int) -> tuple[np.ndarray, float]:
    """Cell-centred bins on [f_min·Δ, f_max·Δ]: (centres, width)."""
    lo, hi = f_min * gap, f_max * gap
    de = (hi - lo) / float(ne)
    return lo + (np.arange(ne, dtype=np.float64) + 0.5) * de, de


def bcs_dos(e: np.ndarray, gap: float) -> np.ndarray:
    """ρ(E) = E/√(E² − Δ²) above the gap, 0 below."""
    rho = np.zeros_like(e)
    above = e > gap
    rho[above] = e[above] / np.sqrt(e[above] ** 2 - gap**2)
    return rho


def bose_einstein(omega: np.ndarray, temperature: float) -> np.ndarray:
    """n_BE(ω, T), 0 where the exponent overflows and at T ≤ 0."""
    if temperature <= 0:
        return np.zeros_like(omega)
    x = np.minimum(omega / (K_B_UEV_PER_K * temperature), EXP_CLIP)
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        occ = 1.0 / (np.exp(x) - 1.0)
    occ[~np.isfinite(occ)] = 0.0
    return np.maximum(occ, 0.0)


def scattering_kernel(e: np.ndarray, gap: float, tau_s: float, t_c: float) -> np.ndarray:
    """K^s₀(Eᵢ, Eⱼ) = (Eᵢ − Eⱼ)²/(k T_c)³ · max(1 − Δ²/(EᵢEⱼ), 0) / τ_s, zero diagonal."""
    ktc = K_B_UEV_PER_K * t_c
    coherence = np.maximum(1.0 - gap**2 / np.maximum(np.outer(e, e), 1e-30), 0.0)
    k = (e[:, None] - e[None, :]) ** 2 / ktc**3 * coherence / tau_s
    np.fill_diagonal(k, 0.0)
    return k


def recombination_kernel(e: np.ndarray, gap: float, tau_r: float, t_c: float) -> np.ndarray:
    """K^r₀(Eᵢ, Eⱼ) = ((Eᵢ + Eⱼ)/k T_c)² / (k T_c) · (1 + Δ²/(EᵢEⱼ)) / τ_r."""
    ktc = K_B_UEV_PER_K * t_c
    coherence = 1.0 + gap**2 / np.maximum(np.outer(e, e), 1e-30)
    return ((e[:, None] + e[None, :]) / ktc) ** 2 / ktc * coherence / tau_r


def phonon_grid(e: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The ω grid of every pair energy |Eᵢ − Eⱼ| and Eᵢ + Eⱼ (unique at 1e-12),
    with each pair's ω index: (omega, idx_diff (NE, NE), idx_sum (NE, NE))."""
    ne = e.size
    pooled = np.concatenate([np.abs(e[:, None] - e[None, :]).ravel(), (e[:, None] + e[None, :]).ravel()])
    omega, inverse = np.unique(np.round(pooled, 12), return_inverse=True)
    return omega, inverse[: ne * ne].reshape(ne, ne), inverse[ne * ne:].reshape(ne, ne)


def bin_widths(centres: np.ndarray) -> np.ndarray:
    """Widths of strictly increasing centres: edges at the midpoints, half a spacing past each end."""
    c = centres
    edges = np.concatenate([[c[0] - 0.5 * (c[1] - c[0])], 0.5 * (c[:-1] + c[1:]),
                            [c[-1] + 0.5 * (c[-1] - c[-2])]])
    return np.diff(edges)


def diffusion_of_energy(d0: float, e: np.ndarray, gap: float) -> np.ndarray:
    """D(E) = D₀·√(1 − (Δ/E)²), 0 at and below the gap."""
    ratio = np.minimum(gap / e, 1.0)
    return d0 * np.sqrt(np.maximum(0.0, 1.0 - ratio**2))
