"""Fischer–Catelani / Kaplan collision kernels (host-side numpy, μeV·ns units).

Precomputed once per (gap, τ, T_c) and uploaded to the device; the runtime
collision integrator (``qpsim_tpu_torch.ops.collisions``) consumes the *base*
kernels and dresses them with the dynamic phonon occupation on-device.

Physics (reference ``reference qpsim/solver.py:463-548``):
  K^r₀(Eᵢ,Eⱼ) = (1/τᵣ)·((Eᵢ+Eⱼ)/k_BT_c)²/(k_BT_c)·(1 + Δ²/(EᵢEⱼ))
  K^s₀(Eᵢ,Eⱼ) = (1/τₛ)·(Eᵢ−Eⱼ)²/(k_BT_c)³·max(1 − Δ²/(EᵢEⱼ), 0), zero diagonal
  Bath-dressed variants multiply by static Bose factors of the bath:
    recombination: N_p(Eᵢ+Eⱼ) = 1 + n_BE
    scattering:    1 + n_BE for emission (Eᵢ>Eⱼ), n_BE for absorption.
"""

from __future__ import annotations

import numpy as np

from ..constants import K_B_UEV_PER_K, OCCUPATION_EXP_CLIP

__all__ = [
    "recombination_kernel_base",
    "scattering_kernel_base",
    "recombination_kernel",
    "scattering_kernel",
    "thermal_generation_rate",
]


def _pair_sums(E: np.ndarray) -> np.ndarray:
    return E[:, None] + E[None, :]


def _pair_diffs(E: np.ndarray) -> np.ndarray:
    return E[:, None] - E[None, :]


def recombination_kernel_base(
    E_bins: np.ndarray,
    gap: float,
    tau_r: float,
    T_c: float,
) -> np.ndarray:
    """Base recombination kernel K^r₀ without phonon occupancy factors."""
    E = np.asarray(E_bins, dtype=np.float64)
    kTc = K_B_UEV_PER_K * T_c
    coherence = 1.0 + gap**2 / np.maximum(E[:, None] * E[None, :], 1e-30)
    return (1.0 / tau_r) * (_pair_sums(E) / kTc) ** 2 / kTc * coherence


def scattering_kernel_base(
    E_bins: np.ndarray,
    gap: float,
    tau_s: float,
    T_c: float,
) -> np.ndarray:
    """Base scattering kernel K^s₀ without phonon occupancy; zero diagonal."""
    E = np.asarray(E_bins, dtype=np.float64)
    kTc = K_B_UEV_PER_K * T_c
    coherence = np.maximum(1.0 - gap**2 / np.maximum(E[:, None] * E[None, :], 1e-30), 0.0)
    K = (1.0 / tau_s) * _pair_diffs(E) ** 2 / kTc**3 * coherence
    np.fill_diagonal(K, 0.0)
    return K


def recombination_kernel(
    E_bins: np.ndarray,
    gap: float,
    tau_r: float,
    T_c: float,
    bath_temperature: float,
) -> np.ndarray:
    """Bath-dressed recombination kernel K^r = K^r₀ · (1 + n_BE(Eᵢ+Eⱼ, T_bath))."""
    E = np.asarray(E_bins, dtype=np.float64)
    kTp = K_B_UEV_PER_K * bath_temperature
    if kTp > 0:
        x = np.minimum(_pair_sums(E) / kTp, OCCUPATION_EXP_CLIP)
        phonon_factor = 1.0 + 1.0 / (np.exp(x) - 1.0)
    else:
        phonon_factor = np.ones((E.size, E.size), dtype=np.float64)
    return recombination_kernel_base(E_bins, gap, tau_r, T_c) * phonon_factor


def scattering_kernel(
    E_bins: np.ndarray,
    gap: float,
    tau_s: float,
    T_c: float,
    bath_temperature: float,
) -> np.ndarray:
    """Bath-dressed scattering kernel.

    Emission (Eᵢ>Eⱼ) picks up 1+n_BE(|ΔE|); absorption picks up n_BE(|ΔE|);
    the diagonal is zero (no self-scattering).
    """
    E = np.asarray(E_bins, dtype=np.float64)
    diffs = _pair_diffs(E)
    kTp = K_B_UEV_PER_K * bath_temperature
    if kTp > 0:
        x = np.minimum(np.abs(diffs) / kTp, OCCUPATION_EXP_CLIP)
        with np.errstate(divide="ignore", invalid="ignore"):
            n_be = 1.0 / (np.exp(x) - 1.0)
        phonon_factor = np.where(diffs > 0, 1.0 + n_be, n_be)
    else:
        phonon_factor = np.where(diffs > 0, 1.0, 0.0)
    np.fill_diagonal(phonon_factor, 0.0)
    return scattering_kernel_base(E_bins, gap, tau_s, T_c) * phonon_factor


def thermal_generation_rate(
    n_eq: np.ndarray,
    K_r: np.ndarray,
    dE: float,
) -> np.ndarray:
    """Thermal pair-breaking generation G_therm = 2·n_eq·dE·(K_r @ n_eq).

    At equilibrium this exactly balances the recombination loss
    2·n·dE·(K_r @ n) evaluated at n = n_eq (reference precompute.py:240).
    """
    n_eq = np.asarray(n_eq, dtype=np.float64)
    return 2.0 * n_eq * dE * (np.asarray(K_r, dtype=np.float64) @ n_eq)
