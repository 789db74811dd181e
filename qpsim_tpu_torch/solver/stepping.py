"""Shared time-stepping plumbing: segment plans and host-side helpers.

Carried over from ``qpsim_tpu.solver.stepping``.  The engine runs the
per-step loop over whole snapshot *segments* (one segment per stored
frame, plus an optional remainder step with its own dt — reference
``qpsim/solver.py:1085-1089``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

__all__ = [
    "default_dtype",
    "widen_color_limits",
    "_split_time",
    "_Segment",
    "_plan_segments",
    "_notify",
    "_color_limits",
]


def default_dtype(device: torch.device) -> torch.dtype:
    """float32 on the card, float64 on the CPU (where the parity tests run)."""
    return torch.float32 if torch.device(device).type == "cuda" else torch.float64


def widen_color_limits(vmin: float, vmax: float) -> list[float]:
    """[vmin, vmax] with degenerate (constant-field) ranges nudged open.

    Copied from ``qpsim_tpu.io.stream`` (the viewer color-limit contract).
    """
    if abs(vmax - vmin) < 1e-12:
        vmax = vmin + 1e-9
    return [float(vmin), float(vmax)]


def _split_time(total_time: float, dt: float) -> tuple[int, float, int]:
    full_steps = int(np.floor(total_time / dt + 1e-12))
    remainder_dt = float(total_time - full_steps * dt)
    if remainder_dt < 1e-12:
        remainder_dt = 0.0
    total_steps = full_steps + (1 if remainder_dt > 0.0 else 0)
    return full_steps, remainder_dt, total_steps


@dataclass
class _Segment:
    length: int
    dt: float
    stored: bool


def _plan_segments(full_steps: int, remainder_dt: float, dt: float, store_every: int):
    segments: list[_Segment] = []
    whole, tail = divmod(full_steps, store_every)
    segments += [_Segment(store_every, dt, True)] * whole
    if tail:
        # tail is stored only when it ends the run (no remainder step follows)
        segments.append(_Segment(tail, dt, remainder_dt == 0.0))
    if remainder_dt > 0.0:
        segments.append(_Segment(1, remainder_dt, True))
    return segments


def _notify(progress_callback, t: float, frame: np.ndarray) -> None:
    if progress_callback is None:
        return
    try:
        progress_callback(float(t), np.array(frame, copy=True))
    except Exception:
        pass


def _color_limits(frames: list[np.ndarray]) -> list[float]:
    return widen_color_limits(
        float(np.nanmin(np.stack(frames))), float(np.nanmax(np.stack(frames)))
    )
