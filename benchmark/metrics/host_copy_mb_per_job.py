"""host_copy_mb_per_job: MB (1e6 bytes) the program copied from the card to the host in
one job of the window, from its counters (``qpsim_tpu_torch.utils.profiling.counters``).

The counters run over the whole process, the set-up's warm-up job included: one job of
one stored segment (``store_every`` steps), which copies the t = 0 state as a window job
does but one segment's snapshot and statistics where a window job copies all of its
segments'.  So the reader splits the bytes as the runner counts them: the part a job
copies before its first segment (``initial_copy_bytes``), the same for every job, over
the jobs; the rest, the same for every segment, over the segments; and gives the first
plus a window job's segments times the second.  The reading is a window job's own, and
does not move with the number of jobs the window holds.  None where the program has no
such counters or the window completed no job."""


def read(run):
    try:
        from qpsim_tpu_torch.utils.profiling import counters
    except ImportError:
        return None
    c = counters()
    done = run.completed()
    if "initial_copy_bytes" not in c or not done:
        return None
    every = int(run.traffic["store_every"])
    segments = [r.steps // every for r in done]
    initial = c["initial_copy_bytes"] / (len(done) + 1)
    per_segment = (c["host_copy_bytes"] - c["initial_copy_bytes"]) / (sum(segments) + 1)
    return (initial + per_segment * sum(segments) / len(done)) / 1e6
