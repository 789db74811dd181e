#!/usr/bin/env python3
"""Time the collision kernels beyond 64 bins of one or more checkouts, in turns, on one NVIDIA GPU.

Run from the root of a checkout:  python3 tools/time_blocked.py TREE [TREE ...]

Each TREE is the root of a checkout (its ``chip_smoke.py`` and
``qpsim_tpu_torch``).  The trees are timed one after the other, each in a
process of its own that builds that tree's kernels, so two versions are
compared on one card in one call (give them as parent, change, change,
parent).  Each process takes ``chip_smoke.collision_setup``'s inputs
(float32, with the dt·g plane): K5, K5 with random G = 3 gap ids and K6 at
1024² × 100 (NW 299), and K5 at 1024² × 256 (NW 767), checks each against
its plain version at 1024² × 100 and times it with CUDA events after a
warm-up.  It prints one line per tree and kernel and a closing table with
the card's name and power limit.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

KERNELS = (("K5", 100, "uniform", 5), ("K5 gap ids", 100, "gid", 5), ("K6", 100, "analytic", 5),
           ("K5", 256, "uniform", 3))


def child(tree: str) -> None:
    sys.path.insert(0, tree)
    import torch

    import chip_smoke as cs

    assert Path(cs.__file__).resolve().parent == Path(tree).resolve(), cs.__file__
    cs.phase_build()
    out = {}
    for name, ne, kind, reps in KERNELS:
        kern, plain, _, _, q, ph, gen = cs.collision_setup(ne, 1024, torch.float32, kind=kind,
                                                            blocked=True)
        got = kern(q, ph, 0.05, gen)
        if ne == 100:
            ref = plain(q, ph, 0.05, gen)
            torch.cuda.synchronize()
            cs.check(f"{name} NE={ne} 1024² float32", max(cs.scaled_err(got[0], ref[0]),
                                                           cs.scaled_err(got[1], ref[1])),
                     cs.blocked_tol(torch.float32, ne))
            del ref
        out[f"{name} NE={ne}"] = cs.time_ms(lambda: kern(q, ph, 0.05, gen), reps)
        print(f"  {tree}: {name} NE={ne} 1024² float32 {out[f'{name} NE={ne}']:.4f} ms", flush=True)
        del kern, plain, q, ph, gen, got
        torch.cuda.empty_cache()
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
    print(f"== kernel ms, in the order run — {card}")
    for tree, res in results:
        print(f"  {tree:>20}: " + ", ".join(f"{k} {v:.4f}" for k, v in res.items()))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--child":
        child(sys.argv[2])
    else:
        sys.exit(main(sys.argv[1:]))
