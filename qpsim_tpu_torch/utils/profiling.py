"""Profiling and observability helpers.

Port of ``qpsim_tpu.utils.profiling`` on ``torch.profiler``:

* :func:`trace` — context manager around ``torch.profiler.profile`` (CPU
  and, where a card is present, CUDA activities) that writes a Chrome
  trace (``trace.json``, open in ``chrome://tracing`` or Perfetto) and a
  table of the top operations by time (``key_averages.txt``) into a
  directory;
* :func:`annotate` — named regions (``torch.profiler.record_function``)
  that show up inside the trace;
* :class:`PhaseTimer` — lightweight host-side wall-clock accounting per
  phase, for quick CLI-level "where did the time go" summaries without a
  trace viewer.  Pass ``block_on=`` the phase's output to make the timing
  honest on the card: the timer then synchronises the output's device, so
  the phase covers its kernels; without it a phase of asynchronous
  launches records host time only.
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager
from pathlib import Path

import torch

__all__ = ["trace", "annotate", "PhaseTimer"]


@contextmanager
def trace(log_dir: str | Path):
    """Capture a trace of the block into ``log_dir``: ``trace.json`` (Chrome
    trace) and ``key_averages.txt`` (operations and kernels by time).  CUDA
    activity is recorded when a card is present."""
    from torch.profiler import ProfilerActivity, profile

    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(out / "trace.json"))
    key = "cuda_time_total" if torch.cuda.is_available() else "cpu_time_total"
    (out / "key_averages.txt").write_text(prof.key_averages().table(sort_by=key, row_limit=40))


def annotate(name: str):
    """Named region annotation inside an active trace."""
    return torch.profiler.record_function(name)


def _force_sync(outputs) -> None:
    """Wait for the card to finish the work that produced ``outputs`` (a
    tensor or a nested tuple/list/dict of them); nothing on the CPU."""
    stack = [outputs]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            if x.device.type == "cuda":
                torch.cuda.synchronize(x.device)
            return
        if isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(x)


class PhaseTimer:
    """Accumulate wall-clock per named phase.

    Usage::

        timer = PhaseTimer()
        with timer.phase("collisions", block_on=lambda: (q, ph)):
            q, ph = collision_step(q, ph)
        ...
        print(timer.report())

    ``block_on`` may be the tensor(s) the phase produces or a zero-argument
    callable returning them (use a callable when the value is assigned
    inside the block); the timer synchronises their device so the recorded
    time covers the device work.  Without it, a phase of asynchronous
    launches records host time only.
    """

    def __init__(self) -> None:
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextmanager
    def phase(self, name: str, *, block_on=None):
        start = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None:
                _force_sync(block_on() if callable(block_on) else block_on)
            self.totals[name] += time.perf_counter() - start
            self.counts[name] += 1

    def report(self) -> str:
        if not self.totals:
            return "(no phases timed)"
        grand = sum(self.totals.values())
        lines = []
        for name, total in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(
                f"{name:24s} {total * 1e3:10.2f} ms total  "
                f"{total / max(1, n) * 1e3:8.3f} ms/call  x{n:<6d} "
                f"{100 * total / max(grand, 1e-12):5.1f}%"
            )
        lines.append(f"{'TOTAL':24s} {grand * 1e3:10.2f} ms")
        return "\n".join(lines)

    def as_dict(self) -> dict[str, dict[str, float]]:
        return {
            name: {"total_s": self.totals[name], "calls": self.counts[name]}
            for name in self.totals
        }
