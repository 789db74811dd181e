"""Phonon frequency grid and static pair-index maps (host-side).

The coupled QP–phonon integrator tracks a phonon occupation n_ph(ω) on the
grid of all energies a QP pair can emit or absorb:
ω ∈ unique({|Eᵢ−Eⱼ|} ∪ {Eᵢ+Eⱼ}), rounded at 1e-12 like the reference
(``reference qpsim/solver.py:668-683``).  The maps are data-independent
given the energy grid, so they are computed once on the host and baked into
the collision step as static int32 tables.

For the plain collision integrator we additionally precompute **one-hot scatter
matrices** S_diff/S_sum of shape (NE², NW): summing pair quantities onto ω
bins then becomes a single (P, NE²) @ (NE², NW) matmul instead of
a scatter-add (the reference uses np.bincount per pixel, solver.py:757-787).
For a uniform energy grid NW is only O(NE) (sums/diffs are Toeplitz/Hankel in
(i,j)), so this matmul is cheap.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["PhononFrequencyMap", "build_phonon_frequency_map"]


@dataclass(frozen=True)
class PhononFrequencyMap:
    """Static ω-grid structure shared by all pixels.

    Attributes
    ----------
    omega_bins : (NW,) float64 — sorted unique pair energies.
    idx_diff   : (NE, NE) int32 — ω index of |Eᵢ−Eⱼ|.
    idx_sum    : (NE, NE) int32 — ω index of Eᵢ+Eⱼ.
    diff_sign  : (NE, NE) int8  — sign(Eᵢ−Eⱼ): +1 emission, −1 absorption.
    scatter_diff : (NE², NW) float — one-hot rows mapping pair (i,j) → ω bin.
    scatter_sum  : (NE², NW) float — same for sums.
    """

    omega_bins: np.ndarray
    idx_diff: np.ndarray
    idx_sum: np.ndarray
    diff_sign: np.ndarray
    scatter_diff: np.ndarray
    scatter_sum: np.ndarray

    @property
    def num_omega(self) -> int:
        return int(self.omega_bins.size)


def _one_hot(indices: np.ndarray, depth: int, dtype=np.float64) -> np.ndarray:
    flat = indices.reshape(-1)
    out = np.zeros((flat.size, depth), dtype=dtype)
    out[np.arange(flat.size), flat] = 1.0
    return out


def build_phonon_frequency_map(E_bins: np.ndarray) -> PhononFrequencyMap:
    E = np.asarray(E_bins, dtype=np.float64)
    if E.ndim != 1:
        raise ValueError("E_bins must be a 1D array.")
    diffs = np.abs(E[:, None] - E[None, :])
    sums = E[:, None] + E[None, :]
    pooled = np.concatenate([diffs.ravel(), sums.ravel()])
    omega_bins, inverse = np.unique(np.round(pooled, 12), return_inverse=True)
    ne = E.size
    idx_diff = inverse[: ne * ne].reshape(ne, ne).astype(np.int32)
    idx_sum = inverse[ne * ne :].reshape(ne, ne).astype(np.int32)
    diff_sign = np.sign(E[:, None] - E[None, :]).astype(np.int8)
    nw = int(omega_bins.size)
    return PhononFrequencyMap(
        omega_bins=omega_bins,
        idx_diff=idx_diff,
        idx_sum=idx_sum,
        diff_sign=diff_sign,
        scatter_diff=_one_hot(idx_diff, nw),
        scatter_sum=_one_hot(idx_sum, nw),
    )
