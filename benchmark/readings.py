"""The readings a cell's limits are set from, on the card: the program against the
plain reference over many seeds, and the control against the reference.

    python3 benchmark/readings.py --workload film16.pulse --seeds 101-112 --control 101-103 \\
        --out chiprun_out/readings_film16.pulse.json

In one process (one set-up): for each seed, the job a run of that seed
would draw first (its job 0) through the program, and its plain reference
(float64, as a run checks it); for each control seed, the same reference
computed one precision below the configuration's (bfloat16 below
float32), in the program's place.  Each reading is ``benchmark.compare``'s numbers.  The
benchmark's runs do not run this.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import compare  # noqa: E402

#: the precision one step below each configuration's
LOWER = {"float64": "float32", "float32": "bfloat16"}


def seeds(text: str) -> list[int]:
    out = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out += list(range(int(lo), int(hi) + 1)) if hi else [int(lo)]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, type=seeds)
    ap.add_argument("--control", default="", type=lambda s: seeds(s) if s else [])
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    import torch

    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next(w for w in spec["workloads"] if w["name"] == args.workload)
    config = json.loads((ROOT / next(c["file"] for c in spec["configs"] if c["name"] == cell["config"])).read_text())
    traffic = json.loads((ROOT / "benchmark" / "traffic" / f"{cell['traffic']}.json").read_text())
    driver = importlib.import_module(f"benchmark.drivers.{traffic['driver']}").Driver(
        config, traffic, args.seeds[0])
    t0 = time.perf_counter()
    driver.setup()
    print(f"set-up {time.perf_counter() - t0:.3f} s", file=sys.stderr, flush=True)
    lower = getattr(torch, LOWER[config["dtype"]])
    rec: dict = {"workload": args.workload, "program": {}, "control": {}, "seconds": {}}
    for s in sorted(set(args.seeds) | set(args.control)):
        driver.reseed(s)
        t = time.perf_counter()
        out = driver._engine(driver.initial_field(0), driver.steps, lambda t, f: None)
        t_prog = time.perf_counter() - t
        torch.cuda.empty_cache()
        t = time.perf_counter()
        ref = driver.reference(0, torch.float64)
        t_ref = time.perf_counter() - t
        if s in args.seeds:
            rec["program"][s] = compare.compare(out, ref, driver.mask)
        del out
        if s in args.control:
            t = time.perf_counter()
            rec["control"][s] = compare.compare(driver.reference(0, lower), ref, driver.mask)
            rec["seconds"].setdefault("control", []).append(time.perf_counter() - t)
        rec["seconds"].setdefault("program", []).append(t_prog)
        rec["seconds"].setdefault("reference", []).append(t_ref)
        print(f"seed {s}: program {rec['program'].get(s)} control {rec['control'].get(s)} "
              f"(job {t_prog:.2f} s, reference {t_ref:.2f} s)", file=sys.stderr, flush=True)
    for side in ("program", "control"):
        for name in compare.NAMES:
            vals = [r[name] for r in rec[side].values()]
            if vals:
                print(f"{side} {name}: max {max(vals)!r} min {min(vals)!r}", file=sys.stderr)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(rec, indent=1))
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
