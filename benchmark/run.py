"""One run of one cell of the benchmark of ``qpsim_tpu_torch`` on NVIDIA GPUs.

    python3 benchmark/run.py --workload film16.pulse --seed 7 --seconds 45 --trace 0

The cell (``BENCHMARK.json``'s ``workloads``) names a configuration
(``benchmark/configs/<config>.json``) and a traffic mix
(``benchmark/traffic/<traffic>.json``), whose ``driver``
(``benchmark/drivers/<driver>.py``) drives the program.  The run:

1. exits with code 3 and prints no result without as many CUDA cards as
   the cell asks for;
2. set-up: imports, the CUDA context, the program's kernels (built on a
   checkout's first run into ``build/qpsim_tpu_torch/``, loaded from there
   after), and one warm-up job at the cell's shapes; ``setup_s`` is the
   time from the process's start to the first timed job;
3. the window: jobs one after another until the first that ends after
   ``--seconds``; with ``--trace 1`` under ``torch.profiler``;
4. the metrics, each read by ``benchmark/metrics/<name>.py`` from the
   window's record: the cell's ``end_to_end`` metrics with ``--trace 0``,
   its ``per_layer`` metrics with ``--trace 1``;
5. the check: one job of the window, drawn from the seed, against the
   plain reference of its configuration, each number held to its limit
   (``benchmark/limits/<cell>.json``);
6. exits with code 4 and prints no result if the process holds JAX or the
   JAX package; else prints the numbers compared and their limits as the
   last lines of standard error and the result as the last line of
   standard output.
"""

from __future__ import annotations

import time

_STARTED = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import compare, trace  # noqa: E402
from benchmark.reference import physics  # noqa: E402

#: top-level modules that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "qpsim_tpu")
BENCH = ROOT / "benchmark"


def _process_age() -> float:
    """Seconds since this process started (from /proc), 0 where that cannot be read."""
    try:
        fields = Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()
        started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return max(0.0, time.clock_gettime(time.CLOCK_BOOTTIME) - started)
    except (OSError, ValueError, IndexError):
        return 0.0


def _process_start() -> float:
    """The host clock (``perf_counter``) at this process's start."""
    age = _process_age()
    return min(_STARTED, time.perf_counter() - age) if age > 0 else _STARTED


_STARTED = _process_start()


@dataclass
class Run:
    """What a metric reader reads: the cell, its files, the window's record and its trace."""

    cell: dict
    config: dict
    traffic: dict
    setup_s: float
    calls: list
    window_s: float
    trace: trace.TraceSummary | None
    cells: int  # film cells
    ne: int
    nw: int
    elem_bytes: int

    def completed(self) -> list:
        return [c for c in self.calls if c.error is None]


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def read_metric(name: str):
    """The reader of metric ``name``: ``read(run) -> float | None`` in ``benchmark/metrics/<name>.py``."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location("benchmark_metric_" + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def metrics_of(run: Run, entries: list[dict]) -> dict:
    """The value of each metric of ``entries`` that applies to the cell and finds something to read."""
    out = {}
    for m in entries:
        if "workloads" in m and run.cell["name"] not in m["workloads"]:
            continue
        value = read_metric(m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def forbidden_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def parse(argv):
    ap = argparse.ArgumentParser(prog="benchmark/run.py", description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, *, device: str = "cuda", spec: dict | None = None, data: Path = BENCH) -> int:
    """One run; ``device``, ``spec`` (BENCHMARK.json's content) and ``data`` (the folder
    of ``traffic/`` and ``limits/``) are for the CPU tests, which run a tiny cell."""
    args = parse(argv)
    spec = spec if spec is not None else load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if args.workload not in cells:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    cell = cells[args.workload]
    config = load_json(ROOT / next(c["file"] for c in spec["configs"] if c["name"] == cell["config"]))
    traffic = load_json(data / "traffic" / f"{cell['traffic']}.json")
    limits = load_json(data / "limits" / f"{cell['name']}.json")

    import torch

    if device == "cuda" and (not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"])):
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    driver = importlib.import_module(f"benchmark.drivers.{traffic['driver']}").Driver(
        config, traffic, args.seed, device=device)
    driver.setup()
    setup_s = time.perf_counter() - _STARTED

    summary = None
    if args.trace:
        prof = trace.profiler()
        with prof:
            calls, window_s = driver.window(args.seconds)
            if device == "cuda":
                torch.cuda.synchronize()
        t_trace = time.perf_counter()
        summary = trace.summarize(prof, window_s)
        kinds = {kind: sum(op.kind == kind for op in summary.ops) for kind in ("kernel", "memcpy", "memset")}
        print(f"trace: {kinds}, busy {summary.busy_s:.3f} of {window_s:.3f} s, "
              f"read in {time.perf_counter() - t_trace:.3f} s", file=sys.stderr)
    else:
        calls, window_s = driver.window(args.seconds)
    cuda = device == "cuda"
    memory_peak = max(torch.cuda.max_memory_allocated(d) for d in range(int(cell["chips"]))) if cuda else 0

    p = config["physics"]
    e, _ = physics.energy_grid(p["energy_gap"], p["energy_min_factor"], p["energy_max_factor"],
                               p["num_energy_bins"])
    run = Run(cell=cell, config=config, traffic=traffic, setup_s=setup_s, calls=calls, window_s=window_s,
              trace=summary, cells=int(driver.mask.sum()), ne=e.size, nw=physics.phonon_grid(e)[0].size,
              elem_bytes=torch.empty((), dtype=getattr(torch, config["dtype"])).element_size())
    metrics = metrics_of(run, spec["per_layer"] if args.trace else spec["end_to_end"])
    failed = sum(c.error is not None for c in calls)

    # the check, once the program's state is gone and its peak is read
    if cuda:
        torch.cuda.empty_cache()
    numbers = {name: math.inf for name in compare.NAMES}
    if driver.kept is not None:
        k, out = driver.kept
        t_ref = time.perf_counter()
        numbers = compare.compare(out, driver.reference(k, torch.float64), driver.mask)
        print(f"job {k} of {len(calls)} checked; its reference took {time.perf_counter() - t_ref:.3f} s",
              file=sys.stderr)
    checks = {name: {"value": numbers[name], "limit": limits[name]} for name in compare.NAMES}
    correct = failed == 0 and all(c["value"] <= c["limit"] for c in checks.values())

    found = forbidden_modules()
    if found:
        print(f"this process holds {', '.join(found)}: no result", file=sys.stderr)
        return 4
    device_rec = {"platform": "gpu" if cuda else "cpu",
                  "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                  "count": int(cell["chips"]), "memory_peak_bytes": int(memory_peak)}
    line = {"correct": correct, "attempted": len(calls), "failed": failed, "metrics": metrics,
            "device": device_rec}
    if summary is not None:
        device_rec.update(busy_s=summary.busy_s, window_s=summary.window_s)
        line["breakdown"] = {"device_ops": summary.device_ops, "idle_gaps": summary.idle_gaps}
    if cuda:
        from benchmark.roofline import card

        line["card"] = card(0)
    for c in calls:
        if c.error is not None:
            print(f"job {c.index} failed: {c.error}", file=sys.stderr)
    line["checks"] = {name: {"value": _num(c["value"]), "limit": c["limit"]} for name, c in checks.items()}
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


def _num(v: float):
    """A number as JSON can hold it (infinity as a string)."""
    return v if math.isfinite(v) else "inf"


if __name__ == "__main__":
    sys.exit(main())
