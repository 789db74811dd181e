"""Phonon frequency grid and static pair-index maps (host-side).

The coupled QP–phonon integrator tracks a phonon occupation n_ph(ω) on the
grid of all energies a QP pair can emit or absorb:
ω ∈ unique({|Eᵢ−Eⱼ|} ∪ {Eᵢ+Eⱼ}), rounded at 1e-12 like the reference
(``reference qpsim/solver.py:668-683``).  The maps are data-independent
given the energy grid, so they are computed once on the host and baked into
the collision step as static int32 tables.

The JAX package's plain integrator sums pair quantities onto ω bins by
**one-hot scatter matrices** S_diff/S_sum of shape (NE², NW); the map still
offers them (``scatter_diff``/``scatter_sum``, formed when read, as the
differentiable simulation reads them), but the port's plain substep scatters
by the index maps instead: at 1024 bins each matrix holds 3.2·10⁹ entries.
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
    scatter_diff : (NE², NW) float — one-hot rows mapping pair (i,j) → ω bin
                   (formed on each read).
    scatter_sum  : (NE², NW) float — same for sums.
    """

    omega_bins: np.ndarray
    idx_diff: np.ndarray
    idx_sum: np.ndarray
    diff_sign: np.ndarray

    @property
    def num_omega(self) -> int:
        return int(self.omega_bins.size)

    @property
    def scatter_diff(self) -> np.ndarray:
        return _one_hot(self.idx_diff, self.num_omega)

    @property
    def scatter_sum(self) -> np.ndarray:
        return _one_hot(self.idx_sum, self.num_omega)


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
    return PhononFrequencyMap(
        omega_bins=omega_bins,
        idx_diff=idx_diff,
        idx_sum=idx_sum,
        diff_sign=diff_sign,
    )
