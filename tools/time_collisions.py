#!/usr/bin/env python3
"""Time the collision kernels up to 64 bins (K3, K4) of one or more checkouts, in turns, on one NVIDIA GPU.

Run from the root of a checkout:  python3 tools/time_collisions.py TREE [TREE ...]

Each TREE is the root of a checkout (its ``chip_smoke.py`` and
``qpsim_tpu_torch``).  The trees are timed one after the other, each in a
process of its own that builds that tree's kernels, so two versions are
compared on one card in one call (give them as parent, change, change,
parent).  Each process takes ``chip_smoke.collision_setup``'s inputs
(float32, with the dt·g plane) at 1024²: K3 at 16 bins (NW 47), with
random G = 3 gap ids and with the trap disc's coherent ids, K4 on a random
Δ plane (γ = 0), and K3 at 17, 24, 32 and 50 bins; then the column walk (K5's
kernel, ``collision_step_blocked``) on the same inputs.  It checks each
against its plain version once and times it with CUDA events after a
warm-up and, for the 16-bin forms, in a CUDA graph of the calls.  It
prints one line per tree and kernel and a closing table with the card's
name and power limit.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

#: (label, bins, chip_smoke.collision_setup kind)
FORMS = (("K3", 16, "uniform"), ("K3 gap ids G=3", 16, "gid"), ("K3 trap ids", 16, "trap"),
         ("K4", 16, "analytic"), ("K3", 17, "uniform"), ("K3", 24, "uniform"), ("K3", 32, "uniform"),
         ("K3", 50, "uniform"))


def child(tree: str) -> None:
    sys.path.insert(0, tree)
    import torch

    import chip_smoke as cs

    assert Path(cs.__file__).resolve().parent == Path(tree).resolve(), cs.__file__
    cs.phase_build()
    out = {}
    for name, ne, kind in FORMS:
        for walk, blocked in (("", False), (" column walk", True)):
            key = f"{name}{walk} NE={ne}"
            kern, plain, _, _, q, ph, gen = cs.collision_setup(ne, 1024, torch.float32, kind=kind,
                                                                blocked=blocked)
            got = kern(q, ph, 0.05, gen)
            ref = plain(q, ph, 0.05, gen)
            torch.cuda.synchronize()
            err = max(cs.scaled_err(got[0], ref[0]), cs.scaled_err(got[1], ref[1]))
            tol = cs.blocked_tol(torch.float32, ne) if blocked else cs.TOL[(cs.COLLISION_KINDS[
                "gid" if kind == "trap" else kind], torch.float32)]
            cs.check(f"{tree}: {key} 1024² float32", err, tol)
            del ref, got
            reps = 20 if ne == 16 else 5
            out[key] = {"events": cs.time_ms(lambda: kern(q, ph, 0.05, gen), reps), "err": err}
            if ne == 16:
                out[key]["graph"] = cs.graph_ms(lambda: kern(q, ph, 0.05, gen), reps)
            print(f"  {tree}: {key} 1024² float32 " + ", ".join(
                f"{k} {v:.4f} ms" for k, v in out[key].items() if k != "err"), flush=True)
            del kern, plain, q, ph, gen
            torch.cuda.empty_cache()
    print("RESULT " + json.dumps(out), flush=True)


def main(trees: list[str]) -> int:
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    results = []
    for tree in trees:
        proc = subprocess.run([sys.executable, __file__, "--child", tree], capture_output=True,
                              text=True, timeout=900)
        sys.stdout.write(proc.stdout[-6000:])
        if proc.returncode != 0:
            sys.stdout.write(proc.stderr[-4000:])
            raise SystemExit(f"{tree}: exit {proc.returncode}")
        line = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")][-1]
        results.append((tree, json.loads(line[len("RESULT "):])))
    print(f"== kernel ms (events; graph), in the order run — {card}")
    for key in results[0][1]:
        print(f"  {key}:")
        for tree, res in results:
            r = res[key]
            graph = f"; {r['graph']:.4f}" if "graph" in r else ""
            print(f"    {tree:>20}: {r['events']:.4f}{graph} (max scaled err {r['err']:.2e})")
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--child":
        child(sys.argv[2])
    else:
        sys.exit(main(sys.argv[1:]))
