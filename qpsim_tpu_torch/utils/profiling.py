"""Profiling and observability helpers.

* :func:`trace` — context manager around ``torch.profiler.profile`` (CPU
  and, where a card is present, CUDA activities) that writes a Chrome
  trace (``trace.json``, open in ``chrome://tracing`` or Perfetto) and a
  table of the top operations by time (``key_averages.txt``) into a
  directory;
* :func:`span` — a named region of the engine (``qpsim.run``,
  ``qpsim.build``, ``qpsim.first_frame``, ``qpsim.drain`` …): under an
  active profiler a ``torch.profiler.record_function``, so it lies in the
  same timeline as the card's kernels and copies; with none, one shared
  no-op.  A span belongs to its job by nesting in time inside that job's
  ``qpsim.run``;
* :func:`counters` — one flat snapshot of the program's counters: the
  kernel wrappers' ``LAUNCHES`` tables and the coupled runner's ``COPIES``
  (bytes copied to the host, and the part of them copied before a call's
  first segment) and ``FIRST_FRAMES`` (first frames reduced on the card
  and on the host).  The counters are always on; a difference of two
  snapshots is what the code between them did.
"""

from __future__ import annotations

from contextlib import contextmanager, nullcontext
from pathlib import Path

import torch

__all__ = ["trace", "span", "counters"]

#: what :func:`span` returns while no profiler records (a ``record_function``
#: costs microseconds even then; the check costs a fraction of one)
_NO_SPAN = nullcontext()


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


def span(name: str):
    """The region ``name`` as a host event of an active profiler, else a no-op."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


def counters() -> dict[str, int]:
    """Every counter of the program, by name, as it stands now."""
    from ..ops import launch_tables
    from ..solver.spectral_runner import COPIES, FIRST_FRAMES

    out: dict[str, int] = {}
    for table in (*launch_tables(), COPIES, FIRST_FRAMES):
        out.update(table)
    return out
