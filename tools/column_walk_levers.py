#!/usr/bin/env python3
"""Time the column walk's launch forms (K5, K5 with gap ids, K6) on one NVIDIA GPU.

Run from the root of a checkout:  python3 tools/column_walk_levers.py [--out FILE]

The collision kernels beyond 64 bins (``csrc/offset_walk.cu``) launch
with P = 1 or 2 pixels per lane (``column_pixels`` picks one).  This
script times both where they fit the block's shared memory, with CUDA
events after a warm-up, on ``chip_smoke.py``'s inputs
(``collision_setup``, float32, with the dt·g plane): K5, K5 with random
G = 3 gap ids, K5 with the trap disc's coherent ids and K6 at 1024² × 100
(NW 299), K5 at 1024² × 256 (NW 767) in float32 and float64.  Each form's
result is held against the default's (``column_pixels``) at
``chip_smoke.blocked_tol``.  It prints one line per form, with the shared
memory per block and the blocks per SM that leaves, and the card's name
and power limit; with ``--out`` the numbers also go to FILE as JSON.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from qpsim_tpu_torch.ops import column_walk as cl  # noqa: E402

F32, F64 = torch.float32, torch.float64


def time_forms(label, ne, dtype, kind, reps, card, results):
    kern, _, _, _, q, ph, gen = cs.collision_setup(ne, 1024, dtype, kind=kind, blocked=True)
    default = cl.column_pixels(dtype, ne, 1024 * 1024)
    ref = kern(q, ph, 0.05, gen)
    torch.cuda.synchronize()
    real = cl.column_pixels
    try:
        for pixels in (1, 2):
            smem = 2 * ne * 32 * pixels * q.element_size()
            if smem > cl.MAX_SHARED_BYTES:
                continue
            cl.column_pixels = lambda *_, p=pixels: p
            got = kern(q, ph, 0.05, gen)
            torch.cuda.synchronize()
            err = max(cs.scaled_err(got[0], ref[0]), cs.scaled_err(got[1], ref[1]))
            cs.check(f"{label} P={pixels} against the default form", err, cs.blocked_tol(dtype, ne))
            ms = cs.time_ms(lambda: kern(q, ph, 0.05, gen), reps)
            row = dict(kernel=label, ne=ne, dtype=str(dtype)[6:], pixels=pixels, smem_bytes=smem,
                       blocks_per_sm=cl.blocks_per_sm(smem), ms=ms, default=pixels == default)
            results.append(row)
            print(f"  {label} NE={ne} {row['dtype']} P={pixels}: {ms:.4f} ms ({smem} B per block, "
                  f"{row['blocks_per_sm']} block(s) per SM){' [default]' if row['default'] else ''}"
                  f" — {card}", flush=True)
    finally:
        cl.column_pixels = real
    del kern, q, ph, gen, ref
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
        time_forms(label, 100, F32, kind, 5, card, results)
    time_forms("K5", 256, F32, "uniform", 3, card, results)
    time_forms("K5", 100, F64, "uniform", 3, card, results)
    time_forms("K5", 256, F64, "uniform", 2, card, results)
    if args.out:
        Path(args.out).write_text(json.dumps(dict(card=card, results=results), indent=1))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
