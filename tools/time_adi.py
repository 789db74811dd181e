#!/usr/bin/env python3
"""Time the ADI kernels (K1, K2) of one or more checkouts, in turns, on one NVIDIA GPU.

Run from the root of a checkout:
    python3 tools/time_adi.py TREE [TREE ...]

Each TREE is the root of a checkout (its ``chip_smoke.py`` and
``qpsim_tpu_torch``).  The trees are timed one after the other, each in a
process of its own that builds that tree's kernels, so two versions are
compared on one card in one call (give them as parent, change, change,
parent).  Each process takes ``chip_smoke.py``'s inputs, float32: the
separable halves K1 x and y on the full 1024² film with mixed faces at
NB = 1 and 16, and on 1022² at NB = 1 (K = 2 chunks of 511); the fused
halves K2 x and y on the 1024² rectangle at 16 bins with one plane and
with NB per-pixel planes, and at 100 bins with one plane, on the 1023²
rectangle at 16 bins (lines of an odd length, which the TPU kernel's chunk
choice leaves at K = 1) and on the 1022² rectangle at one bin (the film
K1 takes at K = 2); and K2's whole step beside ``build_adi_step`` (K7) on
the 16-bin operator.  It checks each kernel against its plain version once and times
it three ways: CUDA events around back-to-back calls launched from the
host (the mean of ``reps``), the same calls captured in one CUDA graph
(``chip_smoke.graph_ms`` of this checkout: the card's own time), and the
host's µs per call while it does not wait for the card.  It prints one
line per tree and kernel and a closing table with the card's name and
power limit.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
from pathlib import Path


def own_graph_ms():
    """``graph_ms`` of this checkout's ``chip_smoke.py`` (a parent tree's may lack it)."""
    spec = importlib.util.spec_from_file_location(
        "own_chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.graph_ms


def host_us(torch, fn, calls: int = 200) -> float:
    """Host µs per call of ``calls`` calls issued without waiting for the card."""
    import time

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def k1_cases(cs, torch):
    from qpsim_tpu_torch.ops import adi_sep_cuda as k1

    for n, nb in ((1024, 1), (1024, 16), (1022, 1)):
        f, u = cs.sep_factors(cs.film(n, n, cs.MIXED_FACES), nb, torch.float32)
        yield f"K1 x {n}²×{nb}", k1.adi_sep_x, k1.adi_sep_x_half_plain, (u, f), 400 if nb == 1 else 50
        yield f"K1 y {n}²×{nb}", k1.adi_sep_y, k1.adi_sep_y_half_plain, (u, f), 400 if nb == 1 else 50


def k2_cases(cs, torch):
    from qpsim_tpu_torch.ops import adi_cuda as k2

    alpha = 0.025
    for n, nb, per_pixel, tag in ((1024, 16, False, "one plane"), (1024, 16, True, "NB planes"),
                                  (1024, 100, False, "one plane"), (1023, 16, False, "one plane"),
                                  (1022, 1, False, "one plane")):
        planes, u = cs.adi_planes(cs.rectangle(n), torch.float32, nb=nb, per_pixel=per_pixel)
        reps = {1: 200, 16: 20, 100: 5}[nb]
        yield f"K2 x {n}²×{nb} {tag}", k2.adi_x_half, k2.adi_x_half_plain, (u, planes, alpha), reps
        yield f"K2 y {n}²×{nb} {tag}", k2.adi_y_half, k2.adi_y_half_plain, (u, planes, alpha), reps


def child(tree: str) -> None:
    sys.path.insert(0, tree)
    import torch

    import chip_smoke as cs

    assert Path(cs.__file__).resolve().parent == Path(tree).resolve(), cs.__file__
    cs.phase_build()
    graph_ms = own_graph_ms()
    out = {}
    for cases in (k1_cases, k2_cases):
        for name, kern, plain, args, reps in cases(cs, torch):
            got, ref = kern(*args), plain(*args)
            torch.cuda.synchronize()
            cs.check(f"{name} float32", cs.scaled_err(got, ref), cs.TOL[("adi", torch.float32)])
            del got, ref
            out[name] = cs.time_ms(lambda: kern(*args), reps)
            out[f"{name} graph"] = graph_ms(lambda: kern(*args), reps)
            out[f"{name} host µs"] = host_us(torch, lambda: kern(*args))
            print(f"  {tree}: {name} float32 {out[name]:.4f} ms (in a graph {out[f'{name} graph']:.4f}; "
                  f"host {out[f'{name} host µs']:.1f} µs per call)", flush=True)
            del args
            torch.cuda.empty_cache()
    from qpsim_tpu_torch.ops.adi_cuda import adi_step, build_adi_step

    op = cs.adi_operator(cs.rectangle(1024))
    planes, u = cs.adi_planes(cs.rectangle(1024), torch.float32)
    k7_step = build_adi_step(op, 0.05, torch.float32, device="cuda")
    out["K2 step 1024²×16"] = cs.time_ms(lambda: adi_step(u, planes, 0.025), 20)
    out["K7 step 1024²×16"] = cs.time_ms(lambda: k7_step(u), 20)
    print(f"  {tree}: K2 step {out['K2 step 1024²×16']:.4f} ms, build_adi_step (K7) "
          f"{out['K7 step 1024²×16']:.4f} ms", flush=True)
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
