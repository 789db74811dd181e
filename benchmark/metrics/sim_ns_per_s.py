"""sim_ns_per_s: the simulated time of every job the window completed over the
window's wall time (each job's own set-up, steps, Pauli drains and snapshots inside)."""


def read(run):
    done = run.completed()
    return sum(c.sim_ns for c in done) / run.window_s if done else None
