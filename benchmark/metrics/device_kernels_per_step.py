"""device_kernels_per_step: the kernels the profiler saw on the card (the program's
own and the torch glue) over the steps the traced window simulated."""


def read(run):
    steps = sum(c.steps for c in run.completed())
    if run.trace is None or not steps:
        return None
    return len(run.trace.kernels()) / steps
