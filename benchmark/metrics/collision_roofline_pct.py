"""collision_roofline_pct: the traced window's steps times the least time the card
could take for one collision substep of dt (``benchmark.roofline``: q and n_ph read
and written once), over the device time of the kernels of the collision substep."""

from benchmark.metrics._layers import layer_seconds, steps
from benchmark.roofline import bound_s, state_bytes

#: the collision substep's kernels (csrc/collisions.cu: K3/K4 up to 16 bins;
#: csrc/offset_walk.cu: the column walk of K3 at 17–64 bins and K5/K6 beyond)
KERNELS = ("collision_step_kernel", "column_walk_kernel")


def read(run):
    if run.trace is None:
        return None
    seconds = layer_seconds(run, KERNELS)
    if seconds <= 0 or not steps(run):
        return None
    return 100.0 * steps(run) * bound_s(state_bytes(run.ne + run.nw, run.cells, run.elem_bytes)) / seconds
