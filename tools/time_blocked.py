#!/usr/bin/env python3
"""Time the column walk's kernels of one or more checkouts, in turns, on one NVIDIA GPU.

Run from the root of a checkout:  python3 tools/time_blocked.py TREE [TREE ...]

Each TREE is the root of a checkout (its ``chip_smoke.py`` and
``qpsim_tpu_torch``).  The trees are timed one after the other, each in a
process of its own that builds that tree's kernels, so two versions are
compared on one card in one call (give them as parent, change, change,
parent).  Each process times every kernel row of PERF.md §6 that
``csrc/offset_walk.cu`` serves, at the row's shape, on ``chip_smoke``'s
inputs (``collision_setup`` with the dt·g plane, ``walk_step`` without),
with CUDA events after a warm-up: K5, K5 with random G = 3 gap ids, with
the trap disc's ids and K6 at 1024² × 100 (NW 299), K5 there in float64
too, K5 at 1024² × 256 (float32 and float64) and × 512 (staged), the
device-memory form at 128² × 512 in float64 and 128² × 1024, K5 with the
trap's ids and K6 at 512² × 300, K6 on one shard's 128 × 512 × 100, K8
(uniform, gap ids) at 1024² × 100 and × 256, K9 at 1024² × 72 and × 16,
K3's column walk on the 1 × 16 strip at 24 bins and the 1 × 4096 film at
64, and K5 with the 32 member ids of a film ensemble (32 × 64² × 8).  K5
at 1024² × 100 is checked against its plain version first.  It prints one
line per tree and kernel and a closing table with the card's name and
power limit.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np


def rows(cs, torch):
    """(label, reps, make): ``make()`` returns a no-argument call of the kernel."""
    F32, F64 = torch.float32, torch.float64

    def blocked(ne, n, dtype, kind="uniform"):
        def make():
            kern, *_, q, ph, gen = cs.collision_setup(ne, n, dtype, kind=kind, blocked=True)
            return lambda: kern(q, ph, 0.05, gen)
        return make

    def k3(ne, n):
        def make():
            kern, *_, q, ph, _ = cs.collision_setup(ne, n, F32)
            return lambda: kern(q, ph, 0.05, None)
        return make

    def walk(form, ne, kind="uniform"):
        def make():
            *_, q, ph, _ = cs.collision_setup(ne, 1024, F32, kind=kind if kind != "gid9" else "uniform")
            step = cs.walk_step(form, ne, 1024, kind=kind)
            return lambda: step(q, ph)
        return make

    def ensemble():
        from qpsim_tpu_torch.parallel import build_film_ensemble

        ens = build_film_ensemble(n_members=32, member_shape=(64, 64), num_energy_bins=8,
                                  tau_r=np.linspace(200.0, 700.0, 32), tau_s=np.linspace(300.0, 600.0, 32))
        q, ph = ens.to_device(*cs.ensemble_state(ens))
        step = ens.collision_half
        return lambda: step(q, ph)

    return [
        ("K5 1024²×100", 5, blocked(100, 1024, F32)),
        ("K5 gap ids 1024²×100", 5, blocked(100, 1024, F32, "gid")),
        ("K5 gap ids trap 1024²×100", 5, blocked(100, 1024, F32, "trap")),
        ("K6 1024²×100", 5, blocked(100, 1024, F32, "analytic")),
        ("K5 f64 1024²×100", 3, blocked(100, 1024, F64)),
        ("K6 f64 1024²×100", 3, blocked(100, 1024, F64, "analytic")),
        ("K5 1024²×256", 2, blocked(256, 1024, F32)),
        ("K5 f64 1024²×256", 1, blocked(256, 1024, F64)),
        ("K5 1024²×512 staged", 1, blocked(512, 1024, F32)),
        ("K5 device f64 128²×512", 2, blocked(512, 128, F64)),
        ("K5 device 128²×1024", 2, blocked(1024, 128, F32)),
        ("K5 gap ids trap 512²×300", 2, blocked(300, 512, F32, "trap")),
        ("K6 512²×300", 2, blocked(300, 512, F32, "analytic")),
        ("K6 shard 128×512×100", 10, blocked(100, (128, 512), F32, "analytic")),
        ("K8 1024²×100", 5, walk("loop", 100)),
        ("K8 gap ids 1024²×100", 5, walk("loop", 100, "gid")),
        ("K8 1024²×256", 2, walk("loop", 256)),
        ("K9 1024²×72", 5, walk("rows", 72)),
        ("K9 1024²×16", 10, walk("rows", 16)),
        ("K3 column walk 1×16×24", 50, k3(24, (1, 16))),
        ("K3 column walk 1×4096×64", 50, k3(64, (1, 4096))),
        ("K5 gap ids ensemble 32 ids", 20, ensemble),
    ]


def child(tree: str) -> None:
    sys.path.insert(0, tree)
    import torch

    import chip_smoke as cs

    assert Path(cs.__file__).resolve().parent == Path(tree).resolve(), cs.__file__
    cs.phase_build()
    kern, plain, _, _, q, ph, gen = cs.collision_setup(100, 1024, torch.float32, blocked=True)
    got, ref = kern(q, ph, 0.05, gen), plain(q, ph, 0.05, gen)
    torch.cuda.synchronize()
    cs.check("K5 NE=100 1024² float32 against its plain version",
             max(cs.scaled_err(got[0], ref[0]), cs.scaled_err(got[1], ref[1])),
             cs.blocked_tol(torch.float32, 100))
    del kern, plain, q, ph, gen, got, ref
    out = {}
    for label, reps, make in rows(cs, torch):
        call = make()
        out[label] = cs.time_ms(call, reps)
        print(f"  {tree}: {label} {out[label]:.4f} ms", flush=True)
        del call
        torch.cuda.empty_cache()
    print("RESULT " + json.dumps(out), flush=True)


def main(trees: list[str]) -> int:
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    results = []
    for tree in trees:
        proc = subprocess.run([sys.executable, __file__, "--child", tree], capture_output=True,
                              text=True, timeout=1500)
        sys.stdout.write(proc.stdout[-6000:])
        if proc.returncode != 0:
            sys.stdout.write(proc.stderr[-4000:])
            raise SystemExit(f"{tree}: exit {proc.returncode}")
        line = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")][-1]
        results.append((tree, json.loads(line[len("RESULT "):])))
    print(f"== kernel ms, in the order run — {card}")
    for tree, res in results:
        print(f"  {tree:>20}: " + ", ".join(f"{k} {v:.4f}" for k, v in res.items()))
    print("RESULTS " + json.dumps(dict(card=card, results=results)))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--child":
        child(sys.argv[2])
    else:
        sys.exit(main(sys.argv[1:]))
