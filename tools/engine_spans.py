#!/usr/bin/env python3
"""The engine's spans and counters over a traced window of a benchmark cell, on one CUDA GPU.

Run from the root of a checkout:
    python3 tools/engine_spans.py --workload film16.pulse --seed 7 --seconds 45 [--out FILE]

Sets up the cell's driver as ``benchmark/run.py`` does (one warm-up job),
then runs its closed loop of jobs for ``--seconds`` under ``torch.profiler``
(``benchmark.trace.profiler``), with the program's counters
(``qpsim_tpu_torch.utils.profiling.counters``) read around every job.
It prints one JSON object (also written to ``--out``):

* ``spans``: for each ``qpsim.*`` span, its count, mean and self time
  (its duration less the part its child spans cover), in ms;
* ``jobs``: each job's set-up as the host clock sees it (call to the t = 0
  frame, what ``call_setup_s`` reads) beside its ``qpsim.build``,
  ``qpsim.initial_state`` and ``qpsim.first_frame`` less that frame's
  ``qpsim.callback``;
* ``metrics``: ``build_s``, ``first_frame_s``, ``frame_host_ms`` (the
  ``qpsim.store`` of frames after t = 0, less their ``qpsim.copy_wait`` and
  ``qpsim.callback``), ``host_copy_mb_per_job`` (per job, from the counters'
  change over each job) and ``program_launches_per_step`` (the counters'
  launch keys over the window's steps), beside ``port_kernels_per_step``
  (the port's kernels in the trace over the same steps);
* ``idle_gaps`` and ``device_ops``: ``benchmark.trace.summarize``'s breakdown.

Needs one CUDA GPU; imports nothing of JAX.  The cell's files, the launch
keys and the port's kernel names are the benchmark's own (``benchmark/run.py``,
``benchmark/metrics/``).  The tool stands in for the harness until it reads the
``qpsim.*`` spans itself; then it goes.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmark import trace  # noqa: E402
from benchmark.run import BENCH, load_json  # noqa: E402


def metric_module(name: str):
    """The module of metric ``name`` (``benchmark/metrics/<name>.py``)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("benchmark_metric_" + name, BENCH / "metrics" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


#: the keys of the launch tables that count a launch
LAUNCH_KEYS = metric_module("program_launches_per_step").LAUNCH_KEYS
#: the port's kernels, by the names their CUDA sources give them: the rooflines' and K7's
PORT_KERNELS = (*metric_module("collision_roofline_pct").KERNELS, *metric_module("adi_roofline_pct").KERNELS,
                "thomas_kernel")


def host_spans(prof) -> list[tuple[str, int, int]]:
    """(name, start ns, end ns) of the host's ``qpsim.*`` and ``bench.*`` events, by start."""
    out = []
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        if (name.startswith("qpsim.") or name.startswith("bench.")) and "CUDA" not in str(ev.device_type()):
            out.append((name, int(ev.start_ns()), int(ev.start_ns() + ev.duration_ns())))
    return sorted(out, key=lambda s: (s[1], -s[2]))


def tree(spans):
    """Each span's children: {index: [child index, ...]} by interval nesting."""
    children: dict[int, list[int]] = defaultdict(list)
    stack: list[int] = []
    for i, (_, start, _) in enumerate(spans):
        while stack and spans[stack[-1]][2] < start:
            stack.pop()
        if stack:
            children[stack[-1]].append(i)
        stack.append(i)
    return children


def dur(span) -> float:
    return (span[2] - span[1]) * 1e-9


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--seconds", type=float, default=45.0)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)

    import importlib

    spec = load_json(ROOT / "BENCHMARK.json")
    cell = next(w for w in spec["workloads"] if w["name"] == args.workload)
    config = load_json(ROOT / next(c["file"] for c in spec["configs"] if c["name"] == cell["config"]))
    traffic = load_json(BENCH / "traffic" / f"{cell['traffic']}.json")
    driver = importlib.import_module(f"benchmark.drivers.{traffic['driver']}").Driver(config, traffic, args.seed)
    out = {"workload": args.workload, "seed": args.seed, **measure(driver, args.seconds)}
    text = json.dumps(out, indent=1)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text)
    print(text)
    return 0


def measure(driver, seconds: float) -> dict:
    """Set ``driver`` up, run its window under the profiler and read the spans and counters."""
    import torch

    from qpsim_tpu_torch.utils.profiling import counters

    cuda = torch.device(driver.device).type == "cuda"
    t0 = time.perf_counter()
    driver.setup()
    setup_s = time.perf_counter() - t0

    deltas = []
    call = driver.call

    def counted(k):
        before = counters()
        rec = call(k)
        after = counters()
        deltas.append({key: after[key] - before[key] for key in after})
        return rec

    driver.call = counted
    prof = trace.profiler()
    with prof:
        calls, window_s = driver.window(seconds)
        if cuda:
            torch.cuda.synchronize()
    summary = trace.summarize(prof, window_s)
    spans = host_spans(prof)
    children = tree(spans)

    per_name: dict[str, list[tuple[float, float]]] = defaultdict(list)
    for i, s in enumerate(spans):
        if s[0].startswith("qpsim."):
            inner = sum(dur(spans[j]) for j in children.get(i, []))
            per_name[s[0]].append((dur(s), dur(s) - inner))
    runs = [i for i, s in enumerate(spans) if s[0] == "qpsim.run"]
    jobs, stores = [], []
    for n, i in enumerate(runs):
        kids = {spans[j][0]: j for j in children.get(i, [])}
        ff = kids["qpsim.first_frame"]
        ff_store = next(j for j in children[ff] if spans[j][0] == "qpsim.store")
        callback = sum(dur(spans[j]) for j in children[ff_store] if spans[j][0] == "qpsim.callback")
        rec = calls[n]
        jobs.append({"call_setup_s": rec.frames[0] - rec.start if rec.frames else None,
                     "build_s": dur(spans[kids["qpsim.build"]]),
                     "initial_state_s": dur(spans[kids["qpsim.initial_state"]]),
                     "first_frame_s": dur(spans[ff]) - callback,
                     "run_s": dur(spans[i])})
        for d in (j for j in children[i] if spans[j][0] == "qpsim.drain"):
            for st in (j for j in children[d] if spans[j][0] == "qpsim.store"):
                waits = sum(dur(spans[j]) for j in children.get(st, [])
                            if spans[j][0] in ("qpsim.copy_wait", "qpsim.callback"))
                stores.append(dur(spans[st]) - waits)
    steps = sum(c.steps for c in calls if c.error is None)
    done = [d for d, c in zip(deltas, calls) if c.error is None]
    port = sum(1 for k in summary.kernels() if any(name in k.name for name in PORT_KERNELS))
    mean = statistics.fmean
    metrics = {
        "build_s": mean(j["build_s"] for j in jobs),
        "first_frame_s": mean(j["first_frame_s"] for j in jobs),
        "initial_state_s": mean(j["initial_state_s"] for j in jobs),
        "call_setup_s": mean(j["call_setup_s"] for j in jobs if j["call_setup_s"] is not None),
        "frame_host_ms": 1e3 * mean(stores) if stores else None,
        "host_copy_mb_per_job": mean(d["host_copy_bytes"] for d in done) / 1e6,
        "program_launches_per_step": sum(n for d in deltas for k, n in d.items() if k in LAUNCH_KEYS) / steps,
        "port_kernels_per_step": port / steps,
        "device_kernels_per_step": len(summary.kernels()) / steps,
        "device_idle_pct": 100.0 * (1.0 - summary.busy_s / window_s),
    }
    return {
        "setup_s": setup_s, "window_s": window_s, "jobs_in_window": len(calls), "steps": steps,
        "per_job_s": window_s / len(calls),
        "spans_per_job": sum(len(v) for v in per_name.values()) / max(1, len(runs)),
        "card": torch.cuda.get_device_name(0) if cuda else "cpu",
        "metrics": metrics,
        "spans": {name: {"count": len(v), "mean_ms": 1e3 * mean(d for d, _ in v),
                         "self_ms": 1e3 * mean(x for _, x in v)} for name, v in sorted(per_name.items())},
        "jobs": jobs, "idle_gaps": summary.idle_gaps, "device_ops": summary.device_ops,
    }


if __name__ == "__main__":
    sys.exit(main())
