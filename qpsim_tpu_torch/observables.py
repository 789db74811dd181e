"""Resonator observables from simulated quasiparticle states (Mattis–Bardeen).

The reference stops at quasiparticle densities; what an MKID experiment
actually measures is the resonator's complex conductivity response — the
fractional frequency shift δf/f and dissipation δ(1/Q) induced by the
nonequilibrium occupation f(E) = n(E)/ρ(E).  This module computes the
Mattis–Bardeen integrals (dirty local limit, ħω < 2Δ) directly over the
engine's spectral state:

    σ₁/σₙ = (2/ħω) ∫_Δ^∞ dE [f(E) − f(E+ħω)] g(E)
    σ₂/σₙ = (1/ħω) ∫_{Δ−ħω}^{Δ} dE [1 − 2 f(E+ħω)] g(E)
    g(E)  = (E² + Δ² + ħωE) / (√|E²−Δ²| · √((E+ħω)²−Δ²))

(Mattis & Bardeen 1958; Gao 2008 ch. 2 is the standard modern treatment.)
Numerics respect both inverse-square-root singularities exactly: the σ₂
integral uses Gauss–Chebyshev nodes (the 1/√(1−x²) weight *is* the
singular factor at both endpoints), and σ₁ integrates the 1/√(E−Δ) weight
analytically per energy cell with the smooth remainder held at the cell
center.  A thermal Fermi–Dirac occupation reproduces the analytic
low-temperature approximations (sinh·K₀ / exp·I₀ forms) to the expected
few-percent accuracy of those approximations.

Responses follow the standard small-perturbation form

    δf/f   = (α/2) · δσ₂/σ₂
    δ(1/Q) =  α    · δσ₁/σ₂

with α the kinetic-inductance fraction of the resonator (device-specific;
default 1.0 — scale by your α).

The port of ``qpsim_tpu.observables``: the numpy functions are the JAX
package's, copied unchanged (``tests/test_torch_observables.py`` pins them
equal); :func:`mattis_bardeen_conductivity_traced` is written in torch, so
it differentiates through the occupation and a gap tensor (the ``"mkid"``
observable of :mod:`qpsim_tpu_torch.diff`).  Its ``jnp.interp`` is
:func:`interp`, with the same out-of-range values and gradients.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.dos import dynes_density_of_states

__all__ = [
    "PLANCK_UEV_PER_GHZ",
    "mattis_bardeen_conductivity",
    "interp",
    "mattis_bardeen_conductivity_traced",
    "occupation_from_spectral",
    "mkid_response_trace",
]

#: h in µeV per GHz: hf[µeV] = 4.135668 · f[GHz]
PLANCK_UEV_PER_GHZ = 4.135667696


def occupation_from_spectral(
    n_spectral: np.ndarray, E_bins: np.ndarray, gap: float, dynes_gamma: float = 0.0
) -> np.ndarray:
    """f(E) = n(E)/ρ(E) along the leading (energy) axis of ``n_spectral``."""
    rho = dynes_density_of_states(np.asarray(E_bins, np.float64), float(gap), dynes_gamma)
    rho = np.maximum(rho, 1e-30)
    shape = (-1,) + (1,) * (np.ndim(n_spectral) - 1)
    return np.asarray(n_spectral, np.float64) / rho.reshape(shape)


def _interp_f(f_occ: np.ndarray, E_bins: np.ndarray, E: np.ndarray) -> np.ndarray:
    """Linear interpolation of f on the bin centers; 0 outside the grid
    above (unoccupied high-energy states) and clamped to f[0] below the
    first center (occupation is flat over the first half-cell)."""
    return np.interp(E, E_bins, f_occ, left=float(f_occ[0]), right=0.0)


def mattis_bardeen_conductivity(
    f_occ: np.ndarray,
    E_bins: np.ndarray,
    gap: float,
    hnu: float,
    *,
    n_cheb: int = 128,
) -> tuple[float, float]:
    """(σ₁/σₙ, σ₂/σₙ) for occupation ``f_occ`` on ``E_bins`` (all µeV).

    ``hnu`` is the readout photon energy ħω in µeV
    (= ``PLANCK_UEV_PER_GHZ · f_GHz``); requires ``hnu < 2·gap`` (no
    pair-breaking by the readout).
    """
    E = np.asarray(E_bins, np.float64)
    f = np.asarray(f_occ, np.float64)
    gap = float(gap)
    hnu = float(hnu)
    if hnu <= 0:
        raise ValueError("hnu must be positive.")
    if hnu >= 2 * gap:
        raise ValueError(
            f"Mattis–Bardeen thermal branch needs hnu < 2Δ (got {hnu:g} µeV "
            f"vs 2Δ = {2 * gap:g} µeV — a pair-breaking readout)."
        )
    if E.ndim != 1 or f.shape != E.shape:
        raise ValueError("f_occ and E_bins must be matching 1D arrays.")

    # --- σ₁: ∫_Δ^∞ [f(E) − f(E+ω)] g(E) dE  over the occupied grid.
    # Weight 1/√(E−Δ) integrated analytically per cell (2√(E−Δ) primitive),
    # smooth remainder at the cell center.  Cells are the midpoints between
    # bin centers, closed at Δ below and at the last center + dE/2 above.
    edges = np.empty(E.size + 1)
    edges[1:-1] = 0.5 * (E[1:] + E[:-1])
    edges[0] = max(gap, E[0] - 0.5 * (E[1] - E[0]) if E.size > 1 else gap)
    edges[-1] = E[-1] + (0.5 * (E[-1] - E[-2]) if E.size > 1 else 0.0)
    edges = np.maximum(edges, gap)
    df = f - _interp_f(f, E, E + hnu)
    smooth = (
        (E * E + gap * gap + hnu * E)
        / np.sqrt(np.maximum(E + gap, 1e-30))
        / np.sqrt(np.maximum((E + hnu) ** 2 - gap * gap, 1e-30))
    )
    cell_weight = 2.0 * (np.sqrt(edges[1:] - gap) - np.sqrt(edges[:-1] - gap))
    sigma1 = float(2.0 / hnu * np.sum(df * smooth * cell_weight))

    # --- σ₂: ∫ over [max(Δ−ω, −Δ), Δ].  Substituting E = c + r·x maps the
    # two endpoint 1/√ singularities onto the Gauss–Chebyshev weight
    # exactly (√(Δ−E) = √(r(1−x))·…, √(E+ω−Δ) = √(r(1+x))·…), so the
    # quadrature converges fast with no special casing.
    lo = max(gap - hnu, -gap)
    c = 0.5 * (lo + gap)
    r = 0.5 * (gap - lo)
    k = np.arange(1, n_cheb + 1)
    x = np.cos((2 * k - 1) * np.pi / (2 * n_cheb))
    Eq = c + r * x
    f_up = _interp_f(f, E, Eq + hnu)
    num = Eq * Eq + gap * gap + hnu * Eq
    den = np.sqrt(np.maximum(gap + Eq, 1e-30)) * np.sqrt(
        np.maximum(Eq + hnu + gap, 1e-30)
    )
    sigma2 = float(
        1.0 / hnu * (np.pi / n_cheb) * np.sum((1.0 - 2.0 * f_up) * num / den)
    )
    return sigma1, sigma2


def mkid_response_trace(
    energy_frames,
    E_bins: np.ndarray,
    gap: float,
    *,
    readout_ghz: float = 5.0,
    dynes_gamma: float = 0.0,
    alpha: float = 1.0,
    weights: np.ndarray | None = None,
    reference_index: int = 0,
    n_cheb: int = 128,
) -> dict:
    """Resonator response trace from the engine's stored spectral frames.

    ``energy_frames``: the per-snapshot list of per-bin 2D frames the
    engine returns (NaN outside the mask).  Per snapshot the occupation is
    averaged over the film (optionally weighted by ``weights`` — e.g. the
    resonator current-density profile |J|², which is what the device
    actually senses), the Mattis–Bardeen integrals evaluated, and the
    response referenced to snapshot ``reference_index``:

    Returns ``{"sigma1", "sigma2", "df_over_f", "dQ_inv"}`` (lists, one
    entry per stored snapshot).
    """
    E = np.asarray(E_bins, np.float64)
    hnu = PLANCK_UEV_PER_GHZ * float(readout_ghz)
    s1_list: list[float] = []
    s2_list: list[float] = []
    for frames in energy_frames:
        stack = np.asarray(
            [np.asarray(fr, np.float64) for fr in frames]
        )  # (NE, ny, nx)
        mask = np.isfinite(stack[0])
        if weights is None:
            w = mask.astype(np.float64)
        else:
            w = np.where(mask, np.asarray(weights, np.float64), 0.0)
        wsum = max(float(w.sum()), 1e-300)
        n_avg = np.array(
            [float(np.nansum(np.where(mask, b, 0.0) * w)) / wsum for b in stack]
        )
        f_avg = occupation_from_spectral(n_avg, E, gap, dynes_gamma)
        s1, s2 = mattis_bardeen_conductivity(f_avg, E, gap, hnu, n_cheb=n_cheb)
        s1_list.append(s1)
        s2_list.append(s2)
    s1_ref = s1_list[reference_index]
    s2_ref = s2_list[reference_index]
    df_over_f = [0.5 * alpha * (s2 - s2_ref) / s2_ref for s2 in s2_list]
    dq_inv = [alpha * (s1 - s1_ref) / s2_ref for s1 in s1_list]
    return {
        "sigma1": s1_list,
        "sigma2": s2_list,
        "df_over_f": df_over_f,
        "dQ_inv": dq_inv,
    }


def interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor, left, right) -> torch.Tensor:
    """``jnp.interp(x, xp, fp, left=left, right=right)`` in torch.

    The same formula: i = clip(searchsorted(xp, x, right), 1, N − 1), the
    lerp fp[i−1] + (x − xp[i−1])/dx·df (fp[i−1] where |dx| ≤ spacing(eps),
    so no NaN gradient), ``left`` where x < xp[0], ``right`` where x >
    xp[−1]; so values and gradients (through x, fp and the bounds) agree.
    ``fp`` may carry leading batch axes (..., N), one curve per row at the
    same (K,) points ``x``: the result is (..., K), as ``vmap`` over rows
    gives.
    """
    n = xp.shape[0]
    i = torch.clamp(torch.searchsorted(xp, x.detach().contiguous(), right=True), 1, n - 1)
    x0, x1, f0, f1 = xp[i - 1], xp[i], fp[..., i - 1], fp[..., i]
    dx = x1 - x0
    eps = float(np.spacing(np.finfo(np.float64 if xp.dtype == torch.float64 else np.float32).eps))
    dx0 = torch.abs(dx) <= eps
    f = torch.where(dx0, f0, f0 + ((x - x0) / torch.where(dx0, torch.ones_like(dx), dx)) * (f1 - f0))
    f = torch.where(x < xp[0], left, f)
    return torch.where(x > xp[-1], right, f)


def mattis_bardeen_conductivity_traced(
    f_occ: torch.Tensor, E_bins: np.ndarray, gap, hnu: float, *, n_cheb: int = 128
):
    """Differentiable (σ₁/σₙ, σ₂/σₙ): same math as
    :func:`mattis_bardeen_conductivity`, built from torch ops so it
    differentiates — through the occupation (and through a gap tensor) —
    and composes with :mod:`qpsim_tpu_torch.diff`'s ``"mkid"`` observable.

    ``E_bins`` stays a static numpy grid (fixed discretization); ``gap``
    may be a tensor.  Energies in µeV; requires ``hnu < 2·gap`` at the
    NOMINAL gap (checked by callers holding the static value).  The
    result lies on ``f_occ``'s device, in its dtype.  ``f_occ`` may be
    (..., NE), a batch of occupations: σ₁ and σ₂ are then (...), as
    ``vmap`` over the rows gives, in one call.
    """
    E = np.asarray(E_bins, np.float64)
    hnu = float(hnu)
    f = f_occ
    dt, dev = f.dtype, f.device
    gap = torch.as_tensor(gap, dtype=dt, device=dev)
    Ej = torch.as_tensor(E, dtype=dt, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)

    def interp_f(x):
        return interp(x, Ej, f, f[..., :1], zero)

    # σ₁ — analytic 1/√(E−Δ) cell weights, smooth part at bin centers
    edges = np.empty(E.size + 1)
    edges[1:-1] = 0.5 * (E[1:] + E[:-1])
    edges[0] = E[0] - (0.5 * (E[1] - E[0]) if E.size > 1 else 0.0)
    edges[-1] = E[-1] + (0.5 * (E[-1] - E[-2]) if E.size > 1 else 0.0)
    edges_j = torch.maximum(torch.as_tensor(edges, dtype=dt, device=dev), gap)
    df = f - interp_f(Ej + hnu)
    smooth = (
        (Ej * Ej + gap * gap + hnu * Ej)
        / torch.sqrt(torch.clamp(Ej + gap, min=1e-30))
        / torch.sqrt(torch.clamp((Ej + hnu) ** 2 - gap * gap, min=1e-30))
    )

    def safe_sqrt(d):
        # d >= 0 by construction; at the clamped edge d == 0 exactly and
        # sqrt'(0) = inf would poison gradients through a gap tensor — the
        # clamped edge contributes 0 for ALL nearby gaps, so the correct
        # derivative there is 0 (the double-where pattern: the unselected
        # branch never sees 0)
        pos = d > 0
        return torch.where(pos, torch.sqrt(torch.where(pos, d, torch.ones_like(d))), zero)

    cell_w = 2.0 * (safe_sqrt(edges_j[1:] - gap) - safe_sqrt(edges_j[:-1] - gap))
    sigma1 = 2.0 / hnu * torch.sum(df * smooth * cell_w, dim=-1)

    # σ₂ — Gauss–Chebyshev over [max(Δ−ω, −Δ), Δ] (endpoint singularities
    # absorbed by the node weight)
    k = np.arange(1, n_cheb + 1)
    x = torch.as_tensor(np.cos((2 * k - 1) * np.pi / (2 * n_cheb)), dtype=dt, device=dev)
    lo = torch.maximum(gap - hnu, -gap)
    c = 0.5 * (lo + gap)
    r = 0.5 * (gap - lo)
    Eq = c + r * x
    f_up = interp_f(Eq + hnu)
    num = Eq * Eq + gap * gap + hnu * Eq
    den = torch.sqrt(torch.clamp(gap + Eq, min=1e-30)) * torch.sqrt(
        torch.clamp(Eq + hnu + gap, min=1e-30)
    )
    sigma2 = 1.0 / hnu * (np.pi / n_cheb) * torch.sum((1.0 - 2.0 * f_up) * num / den, dim=-1)
    return sigma1, sigma2
