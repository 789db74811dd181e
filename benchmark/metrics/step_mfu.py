"""step_mfu: the whole step's share of the card's peak: the traced window's steps
times the least time the card could take for a simulated step (``benchmark.roofline``:
q and n_ph read and written once) over the window's wall time on the host clock.
It bounds the step where a later program merges or renames the kernels that the
two roofline metrics find by name."""

from benchmark.metrics._layers import steps
from benchmark.roofline import bound_s, state_bytes


def read(run):
    if run.trace is None or run.window_s <= 0 or not steps(run):
        return None
    return 100.0 * steps(run) * bound_s(state_bytes(run.ne + run.nw, run.cells, run.elem_bytes)) / run.window_s
