"""Snapshot helper shared by the runners (from ``qpsim_tpu.solver.phonon_history``).

The fixed-temperature phonon scaffold of the scalar branch comes with that
branch.
"""

from __future__ import annotations

import numpy as np

__all__ = ["reconstruct_field"]


def reconstruct_field(mask: np.ndarray, values: np.ndarray) -> np.ndarray:
    """Scatter interior values onto the dense grid with NaN outside."""
    field = np.full(mask.shape, np.nan, dtype=np.float64)
    field[np.asarray(mask, dtype=bool)] = values
    return field
