"""frame_gap_ms.p50: the median of the host time between consecutive frames
delivered to ``progress_callback`` (the gap from a job's start to its t = 0 frame
included): a stored segment of the coupled runner and its snapshot."""

import statistics


def read(run):
    gaps = []
    for c in run.completed():
        stamps = [c.start, *c.frames]
        gaps += [1e3 * (b - a) for a, b in zip(stamps, stamps[1:])]
    return statistics.median(gaps) if gaps else None
