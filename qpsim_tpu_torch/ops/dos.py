"""Densities of states and thermal occupation factors (host-side numpy).

These are one-time precompute quantities uploaded to the device; they stay in
float64 numpy regardless of the on-device compute dtype.

Physics (reference ``reference qpsim/solver.py:324-460``):
  BCS:   ρ(E) = E/√(E²−Δ²) for E>Δ else 0
  Dynes: ρ(E) = Re{(E−iΓ)/√((E−iΓ)²−Δ²)}, clamped ≥0 (→ BCS when Γ=0)
  n_BE(ω,T), f_FD(E,T) with exponent clipping; thermal QP weights ρ·f_FD.
"""

from __future__ import annotations

import numpy as np

from ..constants import K_B_UEV_PER_K, OCCUPATION_EXP_CLIP

__all__ = [
    "bcs_density_of_states",
    "dynes_density_of_states",
    "dynes_density_of_states_per_pixel",
    "bose_einstein_occupation",
    "fermi_dirac_occupation",
    "thermal_phonon_occupation",
    "thermal_qp_weights",
    "diffusion_coefficient_of_energy",
]


def bcs_density_of_states(E: np.ndarray, gap: float) -> np.ndarray:
    E = np.asarray(E, dtype=np.float64)
    rho = np.zeros_like(E)
    above = E > gap
    rho[above] = E[above] / np.sqrt(E[above] ** 2 - gap**2)
    return rho


def dynes_density_of_states(E: np.ndarray, gap: float, gamma: float = 0.0) -> np.ndarray:
    if gamma <= 0:
        return bcs_density_of_states(E, gap)
    z = np.asarray(E, dtype=np.float64) - 1j * gamma
    with np.errstate(invalid="ignore"):
        rho = np.real(z / np.sqrt(z**2 - gap**2))
    return np.maximum(rho, 0.0)


def dynes_density_of_states_per_pixel(
    E: np.ndarray, gap_values: np.ndarray, gamma: float = 0.0
) -> np.ndarray:
    """Vectorized ρ(Eᵢ, Δₚ): (NE, P) from per-pixel gaps in one shot.

    Same formula as :func:`dynes_density_of_states`; avoids the per-unique-
    gap Python loop, which matters for continuous gap maps where the number
    of distinct gaps is comparable to the pixel count.
    """
    E = np.asarray(E, dtype=np.float64)[:, None]
    g = np.asarray(gap_values, dtype=np.float64)[None, :]
    if gamma <= 0:
        above = E > g
        r2 = np.where(above, E**2 - g**2, 1.0)
        return np.where(above, E / np.sqrt(r2), 0.0)
    z = E - 1j * gamma
    with np.errstate(invalid="ignore"):
        rho = np.real(z / np.sqrt(z**2 - g**2))
    return np.maximum(rho, 0.0)


def bose_einstein_occupation(omega: np.ndarray, temperature: float) -> np.ndarray:
    """n_BE(ω,T); returns 0 for T<=0 and at ω where the expression overflows."""
    omega = np.asarray(omega, dtype=np.float64)
    if temperature <= 0:
        return np.zeros_like(omega)
    kT = K_B_UEV_PER_K * float(temperature)
    x = np.minimum(omega / max(kT, 1e-30), OCCUPATION_EXP_CLIP)
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        occ = 1.0 / (np.exp(x) - 1.0)
    occ[~np.isfinite(occ)] = 0.0
    return np.maximum(occ, 0.0)


def fermi_dirac_occupation(E: np.ndarray, temperature: float) -> np.ndarray:
    E = np.asarray(E, dtype=np.float64)
    if temperature <= 0:
        return np.zeros_like(E)
    kT = K_B_UEV_PER_K * float(temperature)
    x = np.minimum(E / kT, OCCUPATION_EXP_CLIP)
    return 1.0 / (np.exp(x) + 1.0)


def thermal_phonon_occupation(omega_bins: np.ndarray, temperature: float) -> np.ndarray:
    """Validated thermal Bose–Einstein occupation over a 1D ω grid."""
    omega = np.asarray(omega_bins, dtype=np.float64)
    if omega.ndim != 1:
        raise ValueError("omega_bins must be a 1D array.")
    if not np.all(np.isfinite(omega)):
        raise ValueError("omega_bins must contain only finite values.")
    if np.any(omega < 0):
        raise ValueError("omega_bins must be non-negative.")
    return bose_einstein_occupation(omega, temperature)


def thermal_qp_weights(
    E_bins: np.ndarray,
    gap: float,
    temperature: float,
    dynes_gamma: float = 0.0,
) -> np.ndarray:
    """Un-normalised thermal-equilibrium spectral density n_eq(E) = ρ(E)·f_FD(E,T).

    E is the Bogoliubov excitation energy (chemical potential 0), so no shift
    by Δ is applied.  T<=0 returns zeros.
    """
    rho = dynes_density_of_states(E_bins, gap, dynes_gamma)
    if temperature <= 0:
        return np.zeros_like(rho)
    return rho * fermi_dirac_occupation(np.asarray(E_bins, dtype=np.float64), temperature)


def diffusion_coefficient_of_energy(
    D0: float,
    E_bins: np.ndarray,
    gap: np.ndarray | float,
) -> np.ndarray:
    """Energy-dependent quasiparticle diffusion D(E) = D₀·√(1 − (Δ/E)²).

    ``gap`` may be a scalar (uniform film) or an array broadcastable against
    E_bins (e.g. per-pixel Δ with E_bins[:,None]).  Values at E<=Δ clamp to 0.
    """
    E = np.asarray(E_bins, dtype=np.float64)
    ratio = np.minimum(np.asarray(gap, dtype=np.float64) / E, 1.0)
    return D0 * np.sqrt(np.maximum(0.0, 1.0 - ratio**2))
