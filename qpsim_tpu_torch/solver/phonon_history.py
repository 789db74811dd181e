"""Snapshot helper and the scalar branch's fixed-temperature phonon scaffold.

Carried over from ``qpsim_tpu.solver.phonon_history``.  Scalar
(energy-integrated) runs have no dynamic phonon field; for viewer and
storage parity the solver still emits constant bath-temperature maps
aligned to the stored times.
"""

from __future__ import annotations

import numpy as np

from ..ops.dos import thermal_phonon_occupation

__all__ = ["build_fixed_phonon_history", "reconstruct_field"]


def reconstruct_field(mask: np.ndarray, values: np.ndarray) -> np.ndarray:
    """Scatter interior values onto the dense grid with NaN outside."""
    field = np.full(mask.shape, np.nan, dtype=np.float64)
    field[np.asarray(mask, dtype=bool)] = values
    return field


def build_fixed_phonon_history(
    *,
    mask: np.ndarray,
    times: list[float] | np.ndarray,
    bath_temperature: float,
    phonon_energy_bins: np.ndarray | None = None,
) -> tuple[
    list[np.ndarray],
    list[list[np.ndarray]] | None,
    np.ndarray | None,
    dict[str, float | str | bool],
]:
    """Constant-bath phonon frames aligned to stored times.

    Returns (frames [K maps], energy_frames or None, omega bins or None,
    metadata).  Every stored time shows the same constant map, so the
    per-time lists alias one read-only array each: a run with many stored
    frames never holds many identical copies.
    """
    m = np.asarray(mask, dtype=bool)
    n_spatial = int(m.sum())
    if n_spatial == 0:
        raise ValueError("Geometry mask has no interior points.")
    n_frames = len(times)
    if n_frames <= 0:
        raise ValueError("times must contain at least one stored timepoint.")

    temp_frame = reconstruct_field(m, np.full(n_spatial, float(bath_temperature)))
    temp_frame.flags.writeable = False
    frames = [temp_frame] * n_frames

    energy_frames: list[list[np.ndarray]] | None = None
    bins_out: np.ndarray | None = None
    if phonon_energy_bins is not None:
        bins_out = np.asarray(phonon_energy_bins, dtype=np.float64).copy()
        if bins_out.ndim != 1:
            raise ValueError("phonon_energy_bins must be a 1D array.")
        if not np.all(np.isfinite(bins_out)):
            raise ValueError("phonon_energy_bins must contain only finite values.")
        if np.any(bins_out < 0):
            raise ValueError("phonon_energy_bins must be non-negative.")
        occ = thermal_phonon_occupation(bins_out, float(bath_temperature))
        per_time = [reconstruct_field(m, np.full(n_spatial, float(v))) for v in occ]
        for fr in per_time:
            fr.flags.writeable = False
        energy_frames = [list(per_time) for _ in range(n_frames)]

    metadata: dict[str, float | str | bool] = {
        "mode": "fixed_temperature",
        "phonon_temperature_K": float(bath_temperature),
        "field_units": "K",
        "energy_frame_units": "occupation",
        "omega_bins_match_qp_energy_bins": bool(phonon_energy_bins is not None),
    }
    return frames, energy_frames, bins_out, metadata
