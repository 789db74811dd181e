"""setup_s: from the process's start to the first timed job (imports, the CUDA
context, loading the kernels, the warm-up job), on the host clock."""


def read(run):
    return run.setup_s
