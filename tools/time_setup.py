#!/usr/bin/env python3
"""Time the set-up of the coupled path's calls for one or more checkouts, in turns, on one NVIDIA GPU.

Run from the root of a checkout:  python3 tools/time_setup.py TREE [TREE ...]

Each TREE is the root of a checkout (its ``chip_smoke.py`` and
``qpsim_tpu_torch``), timed in a process of its own that builds that
tree's kernels, so two versions are compared on one card in one call
(give them as parent, change, change, parent).  Each process runs, after
one warm-up call, two calls of ``run_2d_crank_nicolson`` (float32, the
default merged stepping) at the shapes of ``chip_smoke.py`` phases 4 and
4c — the 1024² rectangle at 16 bins and at 100 bins (NW 299), two steps
stored at the start and the end — and reads each call's set-up: the host
seconds from the call to its first stored frame (the program build, the
initial state and the first frame).  It prints one line per tree and
shape and a closing table with the card's name and power limit.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

SHAPES = (("1024² × 16", 16), ("1024² × 100", 100))


def child(tree: str) -> None:
    sys.path.insert(0, tree)
    import torch

    import chip_smoke as cs
    import qpsim_tpu_torch

    assert Path(cs.__file__).resolve().parent == Path(tree).resolve(), cs.__file__
    out = {}
    for label, ne in SHAPES:
        kw = dict(cs.main_path_kwargs(1024), num_energy_bins=ne, dt=0.05, total_time=0.1,
                  store_every=2)
        qpsim_tpu_torch.run_2d_crank_nicolson(**kw)  # warm-up: builds the kernels
        torch.cuda.synchronize()
        setups = []
        for _ in range(2):
            stamps: list[float] = []
            t0 = time.perf_counter()
            qpsim_tpu_torch.run_2d_crank_nicolson(
                **kw, progress_callback=lambda t, f: stamps.append(time.perf_counter()))
            torch.cuda.synchronize()
            setups.append(stamps[0] - t0)
        out[label] = setups
        print(f"  {tree}: {label} set-up {setups[0]:.3f}, {setups[1]:.3f} s", flush=True)
    print("RESULT " + json.dumps(out), flush=True)


def main(trees: list[str]) -> int:
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    results = []
    for tree in trees:
        proc = subprocess.run([sys.executable, __file__, "--child", tree], capture_output=True,
                              text=True, timeout=900)
        sys.stdout.write(proc.stdout[-4000:])
        if proc.returncode != 0:
            sys.stdout.write(proc.stderr[-4000:])
            raise SystemExit(f"{tree}: exit {proc.returncode}")
        line = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")][-1]
        results.append((tree, json.loads(line[len("RESULT "):])))
    print(f"== set-up s (call to first stored frame), two calls each, in the order run — {card}")
    for tree, res in results:
        print(f"  {tree:>20}: " + "; ".join(f"{k} {v[0]:.3f}, {v[1]:.3f}" for k, v in res.items()))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--child":
        child(sys.argv[2])
    else:
        sys.exit(main(sys.argv[1:]))
