"""program_launches_per_step: the program's own kernel launches a simulated step, from
its counters (``qpsim_tpu_torch.utils.profiling.counters``): the launch keys of the
kernel wrappers' ``LAUNCHES`` tables (:data:`LAUNCH_KEYS`; not :data:`SUBCOUNT_KEYS`,
which count a kind of launch a second time), over the steps the process ran: the
window's completed jobs and the set-up's warm-up job of one stored segment
(``store_every`` steps).  Every job is whole segments of one length, so the ratio is a
window job's.  Against ``device_kernels_per_step`` it splits the program's kernels from
the torch glue.  A key in neither set is not counted (the tier-1 test
``tests/test_torch_tracing.py`` fails until it is classified here).  None where the
program has no such counters or the window completed no job."""

#: keys that count a kernel launch
LAUNCH_KEYS = frozenset({
    "collision_step", "collision_step_analytic", "collision_step_blocked", "collision_step_blocked_analytic",
    "collision_step_blocked_gid", "collision_step_gid", "collision_step_loop", "collision_step_loop_gid",
    "collision_step_rows", "adi_lines", "adi_x_half", "adi_y_half", "adi_sep_x", "adi_sep_y", "thomas",
})
#: keys that count, again, launches already counted under one of :data:`LAUNCH_KEYS`:
#: those with a generation plane, the Thomas solve's column and relayout forms and its
#: backward pass, the column walk's device-memory form
SUBCOUNT_KEYS = frozenset({
    "collision_step_with_gen", "collision_step_analytic_with_gen", "collision_step_blocked_with_gen",
    "collision_step_blocked_analytic_with_gen", "collision_step_blocked_gid_with_gen",
    "collision_step_gid_with_gen", "thomas_cols", "thomas_relayout", "thomas_backward", "column_walk_device",
})


def read(run):
    try:
        from qpsim_tpu_torch.utils.profiling import counters
    except ImportError:
        return None
    c = counters()
    done = run.completed()
    if not done:
        return None
    steps = sum(r.steps for r in done) + int(run.traffic["store_every"])
    return sum(n for k, n in c.items() if k in LAUNCH_KEYS) / steps
