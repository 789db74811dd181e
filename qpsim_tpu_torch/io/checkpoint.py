"""Mid-run checkpoint / resume, one ``torch.save`` file per stored snapshot.

The contract of ``qpsim_tpu.io.checkpoint.SimulationCheckpointer`` (which
stores through orbax): every stored snapshot is a resume point, because
the dense state (q, and the phonon field when present) at each stored step
*is* the snapshot data.  A resumed run rebuilds the host-side history
(times, frames, energy frames, mass, phonon history) from the checkpoints
and continues the time loop from the latest aligned one, giving results
identical to an uninterrupted run.

Storage: ``<dir>/step_<index>.pt`` holds plain CPU tensors and Python
scalars — ``{"step", "time_ns", "q", "ph"?}`` — readable with
``torch.load(weights_only=True)``.  The state keeps its own dtype (a
float32 run stores float32: the float32 → float64 → float32 round trip is
exact, so nothing is lost).  Each file is written under a temporary name
and renamed, so a killed run never leaves a half-written index.
:meth:`SimulationCheckpointer.restore` returns numpy arrays, as the JAX
package's does, so a payload restored there can be saved here unchanged.
"""

from __future__ import annotations

import os
import re
from pathlib import Path
from typing import Any

import numpy as np
import torch

__all__ = ["SimulationCheckpointer"]

_STEP_FILE = re.compile(r"^step_(\d+)\.pt$")


def _as_cpu_tensor(value) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value.detach().to("cpu").contiguous()
    return torch.from_numpy(np.ascontiguousarray(np.asarray(value)))


class SimulationCheckpointer:
    """One ``step_<index>.pt`` file per stored snapshot: {q, ph?, step, time_ns}."""

    def __init__(self, directory: str | Path):
        self.directory = Path(directory).resolve()
        self.directory.mkdir(parents=True, exist_ok=True)

    def _path(self, stored_idx: int) -> Path:
        return self.directory / f"step_{int(stored_idx):06d}.pt"

    def save_step(
        self,
        stored_idx: int,
        *,
        step: int,
        time_ns: float,
        q,
        ph=None,
    ) -> None:
        """Store one snapshot; ``q``/``ph`` are numpy arrays or tensors (any device)."""
        payload: dict[str, Any] = {
            "step": int(step),
            "time_ns": float(time_ns),
            "q": _as_cpu_tensor(q),
        }
        if ph is not None:
            payload["ph"] = _as_cpu_tensor(ph)
        dest = self._path(stored_idx)
        tmp = dest.with_name(dest.name + ".tmp")
        torch.save(payload, tmp)
        os.replace(tmp, dest)  # atomic: a killed run never leaves a torn index

    def finalize(self) -> None:
        """Nothing to wait for: every save has completed when it returns."""

    def all_steps(self) -> list[int]:
        steps = []
        for path in self.directory.iterdir():
            match = _STEP_FILE.match(path.name)
            if match:
                steps.append(int(match.group(1)))
        return sorted(steps)

    def restore(self, stored_idx: int) -> dict[str, Any]:
        raw = torch.load(self._path(stored_idx), map_location="cpu", weights_only=True)
        payload: dict[str, Any] = {
            "stored_idx": int(stored_idx),
            "step": int(raw["step"]),
            "time_ns": float(raw["time_ns"]),
            "q": raw["q"].numpy(),
        }
        if "ph" in raw:
            payload["ph"] = raw["ph"].numpy()
        return payload

    def latest(self) -> dict[str, Any] | None:
        steps = self.all_steps()
        if not steps:
            return None
        return self.restore(steps[-1])

    def discard_from(self, stored_idx: int) -> None:
        """Delete checkpoints at indices >= stored_idx.

        Used on resume to drop snapshots the current segment plan will
        store differently (e.g. a shorter interrupted horizon's forced
        final-step store) — the continuing run re-saves those indices.
        """
        for s in self.all_steps():
            if s >= int(stored_idx):
                self._path(s).unlink(missing_ok=True)

    def load_through(self, stored_idx: int) -> list[dict[str, Any]]:
        return [self.restore(i) for i in self.all_steps() if i <= stored_idx]
