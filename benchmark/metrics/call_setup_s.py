"""call_setup_s: the mean over the window's jobs of the host time from the call to
its t = 0 frame (the engine's entry, the program build, the initial state and the
first snapshot)."""


def read(run):
    starts = [c.frames[0] - c.start for c in run.completed() if c.frames]
    return sum(starts) / len(starts) if starts else None
