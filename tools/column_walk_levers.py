#!/usr/bin/env python3
"""Time the column walk's launch forms (K5, K5 with gap ids, K6) on one NVIDIA GPU.

Run from the root of a checkout:  python3 tools/column_walk_levers.py [--out FILE]

The collision kernels beyond 64 bins (``csrc/offset_walk.cu``) launch
with P = 1 or 2 pixels per lane (``column_pixels`` picks one) and B bins
per register block (``column_bins`` picks one).  This script times every
(P, B) form the kernel is built for where it fits the block's shared
memory (P = 2 and B = 8 in float32 only), with CUDA events after a warm-up, on
``chip_smoke.py``'s inputs (``collision_setup``, with the dt·g plane): K5,
K5 with random G = 3 gap ids, K5 with the trap disc's coherent ids and K6
at 1024² × 100 (NW 299) in float32, K5 at 1024² × 256 (NW 767) in float32
and float64 and at 1024² × 100 in float64, the device-memory form at
128² × 512 in float64 and 128² × 1024 in float32, and, timed in a CUDA
graph (the card's time, not the host's launch rate), K5 on a film
ensemble's 32 member ids (32 × 64² × 8 bins), K5 with random and with the
trap's ids and K6 at 512² × 24, and K5 with random ids at 512² × 64 in
float32.  Each form's result is
held against the rules' form at ``chip_smoke.blocked_tol``.  It prints
one line per form, with the shared memory per block, the blocks per SM
that leaves, the rules' choice, and the card's name and power limit; with
``--out`` the numbers also go to FILE as JSON.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from qpsim_tpu_torch.ops import collisions_cuda  # noqa: E402
from qpsim_tpu_torch.ops import column_walk as cl  # noqa: E402

F32, F64 = torch.float32, torch.float64

#: the (pixels, bins, float32 only) forms csrc/offset_walk.cu is built for:
#: staged, and the device-memory form
STAGED = [(1, 4, False), (1, 8, True), (2, 4, True)]
DEVICE = [(1, 4, False)]


def ensemble():
    """K5's column walk on a film ensemble's 32 member ids: 32 × 64² × 8 bins."""
    from qpsim_tpu_torch.parallel import build_film_ensemble

    ens = build_film_ensemble(n_members=32, member_shape=(64, 64), num_energy_bins=8,
                              tau_r=np.linspace(200.0, 700.0, 32), tau_s=np.linspace(300.0, 600.0, 32))
    q, ph = ens.to_device(*cs.ensemble_state(ens))
    step = ens.collision_half
    return lambda: step(q, ph), q


def time_forms(label, ne, n, dtype, kind, reps, card, results, form="staged", timer=cs.time_ms):
    if kind == "ensemble":
        call, q = ensemble()
    else:
        kern, _, _, _, q, ph, gen = cs.collision_setup(ne, n, dtype, kind=kind, blocked=True)
        call = lambda: kern(q, ph, 0.05, gen)  # noqa: E731
    n_pix = q[0].numel()
    uniform = kind == "uniform"
    default_p = 1 if form == "device" else cl.column_pixels(dtype, ne, n_pix, uniform=uniform)
    default = (default_p, cl.column_bins(dtype, ne, default_p, form))
    real = cl.column_pixels, cl.column_bins, collisions_cuda.launch_column_walk
    collisions_cuda.launch_column_walk = lambda *a: real[2](*a, form=form)
    try:
        ref = call()  # the rules' form
        torch.cuda.synchronize()
        for pixels, bins, wide in STAGED if form == "staged" else DEVICE:
            smem = 0 if form == "device" else 2 * ne * 32 * pixels * q.element_size()
            if smem > cl.MAX_SHARED_BYTES or (wide and dtype != F32) or (pixels == 2 and n_pix % 2):
                continue
            cl.column_pixels = lambda *_, p=pixels, **__: p
            cl.column_bins = lambda *_, b=bins: b
            got = call()
            torch.cuda.synchronize()
            err = max(cs.scaled_err(got[0], ref[0]), cs.scaled_err(got[1], ref[1]))
            cs.check(f"{label} {form} P={pixels} B={bins} against the rules' form", err,
                     cs.blocked_tol(dtype, ne))
            ms = timer(call, reps)
            row = dict(kernel=label, ne=ne, n=n, dtype=str(dtype)[6:], form=form, pixels=pixels,
                       bins=bins, smem_bytes=smem, blocks_per_sm=cl.blocks_per_sm(smem), ms=ms,
                       default=(pixels, bins) == default)
            results.append(row)
            grid = f"{n}²" if isinstance(n, int) else f"{n[0]}×{n[1]}"
            print(f"  {label} NE={ne} {grid} {row['dtype']} {form} P={pixels} B={bins}: {ms:.4f} ms "
                  f"({smem} B per block, {row['blocks_per_sm']} block(s) per SM)"
                  f"{' [default]' if row['default'] else ''} — {card}", flush=True)
            del got
    finally:
        cl.column_pixels, cl.column_bins, collisions_cuda.launch_column_walk = real
    del call, q, ref
    torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="file for the numbers as JSON")
    args = ap.parse_args()
    card = cs.phase_environment()
    cs.phase_build()
    results: list[dict] = []
    for label, kind in (("K5", "uniform"), ("K5 gap ids (random, G=3)", "gid"),
                        ("K5 gap ids (trap disc)", "trap"), ("K6", "analytic")):
        time_forms(label, 100, 1024, F32, kind, 5, card, results)
    time_forms("K5", 256, 1024, F32, "uniform", 3, card, results)
    time_forms("K5", 100, 1024, F64, "uniform", 3, card, results)
    time_forms("K5", 256, 1024, F64, "uniform", 2, card, results)
    time_forms("K5", 512, 128, F64, "uniform", 2, card, results, form="device")
    time_forms("K5", 1024, 128, F32, "uniform", 2, card, results, form="device")
    # gap ids and Δ planes at few bins, where a launch is tens of µs: the
    # card's time in a CUDA graph, not the host's launch rate
    time_forms("K5 gap ids (32 member ids)", 8, (2079, 64), F32, "ensemble", 200, card, results,
               timer=cs.graph_ms)
    for label, kind in (("K5 gap ids (random, G=3)", "gid"), ("K5 gap ids (trap disc)", "trap"),
                        ("K6", "analytic")):
        time_forms(label, 24, 512, F32, kind, 100, card, results, timer=cs.graph_ms)
    time_forms("K5 gap ids (random, G=3)", 64, 512, F32, "gid", 50, card, results, timer=cs.graph_ms)
    if args.out:
        Path(args.out).write_text(json.dumps(dict(card=card, results=results), indent=1))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
