"""Device time of the kernels of a layer, found by name in the trace."""

import re


def layer_seconds(run, names: tuple[str, ...]) -> float:
    """Seconds of the traced kernels whose name holds one of ``names`` as a whole word."""
    pattern = re.compile(r"(?<![A-Za-z0-9_])(" + "|".join(map(re.escape, names)) + r")(?![A-Za-z0-9_])")
    return 1e-9 * sum(k.dur for k in run.trace.kernels() if pattern.search(k.name))


def steps(run) -> int:
    return sum(c.steps for c in run.completed())
