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

from ..io.stream import widen_color_limits
from ..utils.profiling import span

__all__ = [
    "default_dtype",
    "_split_time",
    "_Segment",
    "_plan_segments",
    "_notify",
    "_color_limits",
    "_limits_from_running",
    "_usable_resume_prefix",
]


def default_dtype(device: torch.device) -> torch.dtype:
    """float32 on the card, float64 on the CPU (where the parity tests run)."""
    return torch.float32 if torch.device(device).type == "cuda" else torch.float64


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
        frame = np.array(frame, copy=True)
        with span("qpsim.callback"):
            progress_callback(float(t), frame)
    except Exception:
        pass


def _color_limits(frames: list[np.ndarray]) -> list[float]:
    return widen_color_limits(
        float(np.nanmin(np.stack(frames))), float(np.nanmax(np.stack(frames)))
    )


def _limits_from_running(limits: list[float]) -> list[float]:
    """Color limits from a streaming-mode running [vmin, vmax] pair."""
    return widen_color_limits(limits[0], limits[1])


def _usable_resume_prefix(checkpointer, segments) -> list[dict]:
    """Checkpoints this run's segment plan can replay: the aligned prefix.

    A run interrupted at a horizon that is not a store_every multiple wrote
    a forced final-step snapshot (the always-store-the-final-step contract)
    at a step the longer-horizon resume would never store.  Replaying it
    would desynchronize the segment skip logic — snapshots land off their
    boundaries and part of a segment is integrated twice.  Only the prefix
    whose steps match this plan's stored boundaries is usable; everything
    past it is discarded (and recomputed by the continuing run).
    """
    steps = checkpointer.all_steps()
    if not steps:
        return []
    boundaries = [0]
    cum = 0
    for seg in segments:
        cum += seg.length
        if seg.stored:
            boundaries.append(cum)
    # restore lazily, stopping at the first misalignment: checkpoints past
    # the break (possibly dozens of full device states) are discarded
    # without ever being read
    usable: list[dict] = []
    for i, s in enumerate(steps):
        if s != i or i >= len(boundaries):
            break
        payload = checkpointer.restore(s)
        if payload["step"] != boundaries[i]:
            break
        usable.append(payload)
    checkpointer.discard_from(len(usable))
    return usable
