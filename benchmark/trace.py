"""The device trace of a ``--trace 1`` window, reduced to what the metric readers read.

``torch.profiler`` records the host's operations and the card's kernels,
copies and sets (CUPTI) over the window.  The harness marks each engine
call (``bench.call``) and each frame the call delivers (``bench.frame``)
with user annotations, so the host's phases are found in the trace's own
clock.  :func:`summarize` keeps:

* every device operation as (name, kind, start ns, duration ns);
* ``busy_s``: the length of the union of the device operations;
* ``idle_gaps``: the device's idle time between operations, summed by
  what the host was doing then (its phase and its innermost operation);
* ``device_ops``: the device operations that took most time, by name.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass, field

CALL, FRAME = "bench.call", "bench.frame"
#: idle gaps shorter than this are summed by phase alone, not named by a host operation
SHORT_GAP_NS = 10_000


@dataclass
class DeviceOp:
    name: str
    kind: str  # "kernel", "memcpy", "memset"
    start: int  # ns
    dur: int  # ns


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    ops: list[DeviceOp]
    device_ops: list[list] = field(default_factory=list)
    idle_gaps: list[list] = field(default_factory=list)

    def kernels(self) -> list[DeviceOp]:
        return [op for op in self.ops if op.kind == "kernel"]


def profiler():
    """A profiler of the host and the card; enter it to start the window."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    return torch.profiler.profile(activities=acts, record_shapes=False, with_stack=False)


def mark(name: str):
    """A user annotation in the trace (a no-op outside a profiled window)."""
    import torch

    return torch.profiler.record_function(name)


def _kind(event) -> str | None:
    """'kernel', 'memcpy' or 'memset' for an operation on the device, else None
    (a host event, or an annotation the profiler mirrors onto the device's timeline)."""
    if "CUDA" not in str(event.device_type()):
        return None
    name = event.name()
    annotation = getattr(event, "is_user_annotation", None)
    activity = getattr(event, "activity_type", None)
    act = str(activity()).lower() if activity is not None else ""
    if name.startswith("bench.") or (annotation is not None and annotation()) or "annotation" in act:
        return None
    if "memcpy" in act or name.startswith("Memcpy"):
        return "memcpy"
    if "memset" in act or name.startswith("Memset"):
        return "memset"
    return "kernel"


def _union(intervals: list[tuple[int, int]]) -> list[tuple[int, int]]:
    out: list[list[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def summarize(prof, window_s: float, top: int = 10) -> TraceSummary:
    """Reduce a finished profile of a window of ``window_s`` host seconds."""
    events = prof.profiler.kineto_results.events()
    ops: list[DeviceOp] = []
    host: list[tuple[int, int, str]] = []  # (start, end, name) of the host's operations
    calls: list[tuple[int, int]] = []
    frames: list[int] = []
    for ev in events:
        kind = _kind(ev)
        start, dur = int(ev.start_ns()), int(ev.duration_ns())
        if kind is not None:
            ops.append(DeviceOp(ev.name(), kind, start, dur))
            continue
        name = ev.name()
        if name == CALL:
            calls.append((start, start + dur))
        elif name == FRAME:
            frames.append(start)
        else:
            host.append((start, start + dur, name))
    busy = _union([(op.start, op.start + op.dur) for op in ops])
    busy_s = sum(e - s for s, e in busy) * 1e-9

    by_name: dict[str, int] = defaultdict(int)
    for op in ops:
        by_name[op.name] += op.dur
    device_ops = [[n, t * 1e-9] for n, t in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]]

    # idle gaps: between device operations, and from the window's first call
    # to the first operation and from the last operation to the last call's end
    calls.sort()
    frames.sort()
    edges = [(calls[0][0], calls[0][0])] if calls else []
    edges += busy + ([(calls[-1][1], calls[-1][1])] if calls else [])
    host.sort()
    host_starts = [h[0] for h in host]
    idle: dict[str, int] = defaultdict(int)
    for (s0, e0), (s1, _) in zip(edges, edges[1:]):
        if s1 <= e0:
            continue
        mid = (e0 + s1) // 2
        if s1 - e0 < SHORT_GAP_NS:
            idle[f"{_phase(mid, calls, frames)}: gaps under {SHORT_GAP_NS // 1000} us"] += s1 - e0
        else:
            idle[f"{_phase(mid, calls, frames)}: {_innermost(mid, host, host_starts)}"] += s1 - e0
    idle_gaps = [[n, t * 1e-9] for n, t in sorted(idle.items(), key=lambda kv: -kv[1])[:top]]
    return TraceSummary(window_s=window_s, busy_s=busy_s, ops=ops, device_ops=device_ops, idle_gaps=idle_gaps)


def _phase(t: int, calls: list[tuple[int, int]], frames: list[int]) -> str:
    """The harness's phase at ``t``: a call's set-up (to its first frame), its
    segments (between frames), its end (after its last frame), or between calls."""
    i = bisect.bisect_right(calls, (t, float("inf"))) - 1
    if i < 0 or t > calls[i][1]:
        return "between calls"
    lo, hi = calls[i]
    j = bisect.bisect_left(frames, lo)
    if j == len(frames) or frames[j] > t:
        return "call set-up"
    k = bisect.bisect_right(frames, t)
    return "segments" if k < len(frames) and frames[k] <= hi else "after the last frame"


def _innermost(t: int, host: list[tuple[int, int, str]], starts: list[int]) -> str:
    """The shortest host operation running at ``t`` (its name), or 'python' where none is."""
    best = None
    i = bisect.bisect_right(starts, t) - 1
    # host operations nest, and the innermost one covering t began shortly
    # before it: look back a bounded way
    for j in range(i, max(-1, i - 64), -1):
        s, e, name = host[j]
        if e >= t and (best is None or e - s < best[0]):
            best = (e - s, name)
    return "python" if best is None else best[1]
