"""adi_roofline_pct: the traced window's steps times the least time the card could
take for one ADI diffusion step (``benchmark.roofline``: q read and written once),
over the device time of the kernels of the diffusion step."""

from benchmark.metrics._layers import layer_seconds, steps
from benchmark.roofline import bound_s, state_bytes

#: the diffusion step's kernels (csrc/adi.cu: K2, the fused step; csrc/adi_sep.cu:
#: K1, the separable step; csrc/adi_lines.cu: K7, the line solve of a sharded step)
KERNELS = ("adi_kernel", "adi_sep_kernel", "adi_lines_kernel")


def read(run):
    if run.trace is None:
        return None
    seconds = layer_seconds(run, KERNELS)
    if seconds <= 0 or not steps(run):
        return None
    return 100.0 * steps(run) * bound_s(state_bytes(run.ne, run.cells, run.elem_bytes)) / seconds
