"""Pauli-exclusion monitoring: on-device stats, host-side enforcement.

Carried over from ``qpsim_tpu.solver.pauli``.  The spectral density may
never exceed the density of states (occupation f = n/ρ ≤ 1) and must
vanish where ρ ≈ 0.  The per-step statistics are reduced on the device
into one small tensor per step, which stays there until the engine drains
its segment; enforcement — exceptions and warnings with the reference's
message format — happens on the host.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["make_pauli_stats_fn", "PauliEnforcer"]

_RHO_PRESENT = 1e-30


def make_pauli_stats_fn(rho_state: torch.Tensor, density_floor: float):
    """``stats(q) -> (4,) float64 tensor`` on q's device:
    (max_occ, argmax_flat, forbidden_any, forbidden_flat).

    ``rho_state`` is (NE, Ny, Nx), zero outside the mask and in gapped-out
    bins.  Indices are flat over (NE, Ny·Nx) and exact in float64.
    """
    rho_mask = rho_state > _RHO_PRESENT
    rho_safe = torch.clamp(rho_state, min=_RHO_PRESENT)

    def stats(q: torch.Tensor) -> torch.Tensor:
        f_flat = torch.where(rho_mask, q / rho_safe, 0.0).reshape(-1)
        argmax = torch.argmax(f_flat)
        forbidden = ((~rho_mask) & (q > density_floor)).reshape(-1)
        return torch.stack(
            [
                # take, not f_flat[argmax]: indexing with a device scalar
                # would read it back to the host and stall every step
                torch.take(f_flat, argmax).double(),
                argmax.double(),
                forbidden.any().double(),
                torch.argmax(forbidden.to(torch.uint8)).double(),
            ]
        )

    return stats


@dataclass
class PauliEnforcer:
    """Host-side policy: raise or warn when occupation limits are crossed."""

    E_bins: np.ndarray
    grid_shape: tuple[int, int]
    enforce: bool = True
    warn_threshold: float | None = 0.5
    error_threshold: float | None = 1.0
    warned: bool = False

    def _locate(self, flat_idx: int) -> tuple[int, int, int]:
        ny, nx = self.grid_shape
        ie, rem = divmod(int(flat_idx), ny * nx)
        row, col = divmod(rem, nx)
        return ie, row, col

    def check(
        self,
        step_idx: int,
        time_ns: float,
        max_occ: float,
        argmax_flat: int,
        forbidden_any: bool,
        forbidden_flat: int,
    ) -> None:
        if forbidden_any:
            ie, row, col = self._locate(forbidden_flat)
            msg = (
                "Detected non-zero quasiparticle density in forbidden state "
                f"(rho≈0): step={step_idx}, t={time_ns:.6g} ns, "
                f"E={self.E_bins[ie]:.6g} μeV, pixel=({row},{col})."
            )
            if self.enforce:
                raise ValueError(msg)
            if not self.warned:
                warnings.warn(msg, stacklevel=2)
                self.warned = True

        if self.error_threshold is not None and max_occ > self.error_threshold:
            ie, row, col = self._locate(argmax_flat)
            msg = (
                f"Pauli occupation exceeded limit: f={max_occ:.6g} > "
                f"{self.error_threshold:.6g} at step={step_idx}, t={time_ns:.6g} ns, "
                f"E={self.E_bins[ie]:.6g} μeV, pixel=({row},{col})."
            )
            if self.enforce:
                raise ValueError(msg)
            if not self.warned:
                warnings.warn(msg, stacklevel=2)
                self.warned = True

        if (
            self.warn_threshold is not None
            and max_occ > self.warn_threshold
            and not self.warned
        ):
            ie, row, col = self._locate(argmax_flat)
            warnings.warn(
                "High occupation detected (Pauli blocking regime): "
                f"max f={max_occ:.6g} at step={step_idx}, t={time_ns:.6g} ns, "
                f"E={self.E_bins[ie]:.6g} μeV, pixel=({row},{col}).",
                stacklevel=2,
            )
            self.warned = True

    def check_row(self, step_idx: int, time_ns: float, row: np.ndarray) -> None:
        """:meth:`check` on one row of the device stats (see make_pauli_stats_fn)."""
        self.check(step_idx, time_ns, float(row[0]), int(row[1]), bool(row[2]), int(row[3]))
