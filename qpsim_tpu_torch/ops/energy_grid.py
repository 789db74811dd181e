"""Energy-grid construction (host-side, float64 numpy).

Semantics match the reference (``reference qpsim/solver.py:61-109``):
cell-centered bins spanning [f_min·Δ, f_max·Δ]; a single-bin grid uses a unit
integration weight; non-uniform centers get trapezoid-style widths.
"""

from __future__ import annotations

import numpy as np

__all__ = ["build_energy_grid", "integration_widths_from_centers"]


def build_energy_grid(
    gap: float,
    energy_min_factor: float,
    energy_max_factor: float,
    num_energy_bins: int,
) -> tuple[np.ndarray, float]:
    """Return (bin centers [μeV], bin width dE).

    The grid is cell-centered: E_i = E_min + (i + 1/2)·dE with
    dE = (E_max − E_min)/NE.  For NE == 1 the center is the interval midpoint
    and the integration weight is 1 (so sums equal densities).
    """
    if gap <= 0:
        raise ValueError("gap must be positive.")
    if num_energy_bins <= 0:
        raise ValueError("num_energy_bins must be >= 1.")

    e_lo = energy_min_factor * gap
    e_hi = energy_max_factor * gap
    if num_energy_bins == 1:
        return np.array([0.5 * (e_lo + e_hi)], dtype=np.float64), 1.0
    if e_hi <= e_lo:
        raise ValueError(
            "energy_max_factor must be > energy_min_factor for num_energy_bins > 1."
        )
    dE = (e_hi - e_lo) / float(num_energy_bins)
    centers = e_lo + (np.arange(num_energy_bins, dtype=np.float64) + 0.5) * dE
    return centers, dE


def integration_widths_from_centers(
    centers: np.ndarray,
    *,
    fallback_width: float = 1.0,
) -> np.ndarray:
    """Integration weights for strictly increasing bin centers.

    Edges are midpoints between neighbours, extrapolated half a spacing past
    the first/last center; a single center gets ``fallback_width``.
    """
    c = np.asarray(centers, dtype=np.float64).reshape(-1)
    if c.size == 0:
        raise ValueError("centers must be non-empty.")
    if c.size == 1:
        return np.array([float(fallback_width)], dtype=np.float64)
    if not np.all(np.isfinite(c)):
        raise ValueError("centers must contain finite values.")
    if np.any(np.diff(c) <= 0):
        raise ValueError("centers must be strictly increasing.")
    edges = np.concatenate(
        [
            [c[0] - 0.5 * (c[1] - c[0])],
            0.5 * (c[:-1] + c[1:]),
            [c[-1] + 0.5 * (c[-1] - c[-2])],
        ]
    )
    widths = np.diff(edges)
    if np.any(widths <= 0):
        raise ValueError("Derived non-positive integration width from centers.")
    return widths
