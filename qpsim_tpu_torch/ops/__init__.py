"""The physics operators and the wrappers of the CUDA kernels."""


def launch_tables() -> tuple[dict, ...]:
    """The kernel wrappers' launch counters, one ``LAUNCHES`` dict a module: a
    wrapper adds one where it launches its kernel, and nowhere else."""
    from . import adi_cuda, adi_sep_cuda, collisions_cuda, column_walk, tridiag_cuda

    return (collisions_cuda.LAUNCHES, adi_cuda.LAUNCHES, adi_sep_cuda.LAUNCHES, tridiag_cuda.LAUNCHES,
            column_walk.LAUNCHES)
