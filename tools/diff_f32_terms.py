#!/usr/bin/env python3
"""Where the float32 gradient of the differentiable simulation parts from float64.

Run from the root of a checkout:
    python3 tools/diff_f32_terms.py [--device cuda|cpu] [--n 64] [--steps 400]

Builds ``chip_smoke.py`` phase 10a's film (n² × 16 bins, a burst on a
uniform floor, ``remat_chunk=20``) and takes p·∂L/∂p (D0, τ_s, τ_r, Δ) of
each of the three terms of its loss without the MKID traces — the last
frame's spread, the total trace's end over its start, the phonon spectrum —
one backward each, for: float64 and float32 through the tridiagonal kernel
(K10, on CUDA), and float64 and float32 through the plain Thomas solve
(``ThomasSolve`` on its plain version).  On the CPU only the plain solve
runs.  It prints each term's entries, the float32 error of each against
float64 on the same solve, and the float32 kernel against the float32 plain
solve, then the card's name and power limit where there is one.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

PARAMS = {"D0": 6.0, "tau_s": 440.0, "tau_r": 440.0, "gap": 180.0}


def terms_grads(n: int, steps: int, dtype, device: str, plain: bool) -> np.ndarray:
    """(3, 4) array: p·∂(term)/∂p for each loss term and parameter."""
    from qpsim_tpu_torch import diff as td
    from qpsim_tpu_torch.ops import tridiag_cuda as k10

    yy, xx = np.mgrid[0:n, 0:n]
    cx, cy, r2 = 20.0 * n / 64, 40.0 * n / 64, 60.0 * (n / 64) ** 2
    field = 1e-5 * (1.0 + 4.0 * np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / r2))
    field = field * np.random.default_rng(10).uniform(0.9, 1.1, (n, n))
    w = torch.as_tensor(((xx - cx) ** 2 + (yy - cy) ** 2) / n**2, dtype=dtype, device=device)
    sim = td.make_differentiable_sim(
        mask=np.ones((n, n), dtype=bool), num_energy_bins=16, energy_max_factor=4.0, dt=0.05, n_steps=steps,
        initial_field=field, dtype=dtype, observables=("total", "spatial", "phonon_spectrum"), store_every=50,
        remat=True, remat_chunk=20, device=device)
    real = k10._solve
    if plain:
        k10._solve = lambda sub, diag, sup, rhs, backward=False: k10.thomas_plain(sub, diag, sup, rhs)
    try:
        p = {k: torch.tensor(v, dtype=dtype, device=device, requires_grad=True) for k, v in PARAMS.items()}
        out = sim(p)
        s = out["spatial"]
        terms = ((s[-1] * w).sum() / s[0].sum(), out["total"][-1] / out["total"][0],
                 out["phonon_spectrum"].sum() / 1e3)
        rows = []
        for i, term in enumerate(terms):
            g = torch.autograd.grad(term, list(p.values()), retain_graph=i < len(terms) - 1)
            rows.append([PARAMS[k] * float(x) for k, x in zip(PARAMS, g)])
    finally:
        k10._solve = real
    return np.array(rows)


def report(label: str, got: np.ndarray, ref: np.ndarray) -> None:
    np.set_printoptions(precision=4, linewidth=140)
    print(f"{label}: per term and entry (rows: spread, total, phonons; columns: {', '.join(PARAMS)})")
    print(np.abs(got - ref) / np.abs(ref))
    total, total_ref = got.sum(0), ref.sum(0)
    print(f"  the loss's entries {np.abs(total - total_ref) / np.abs(total_ref)}, scaled "
          f"{np.max(np.abs(total - total_ref)) / np.max(np.abs(total_ref)):.3e}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--steps", type=int, default=400)
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device; pass --device cpu", file=sys.stderr)
        return 1
    runs = {}
    forms = [(torch.float64, True), (torch.float32, True)]
    if args.device == "cuda":
        forms = [(torch.float64, False), (torch.float32, False)] + forms
    for dtype, plain in forms:
        t0 = time.perf_counter()
        runs[dtype, plain] = terms_grads(args.n, args.steps, dtype, args.device, plain)
        print(f"{str(dtype)[6:]} {'plain solve' if plain else 'K10'}: {time.perf_counter() - t0:.2f} s; "
              f"p·dL/dp per term\n{runs[dtype, plain]}", flush=True)
    print(f"{args.n}² × 16 bins, {args.steps} steps, on {args.device}")
    report("float32 against float64, plain solve", runs[torch.float32, True], runs[torch.float64, True])
    if args.device == "cuda":
        report("float32 against float64, K10", runs[torch.float32, False], runs[torch.float64, False])
        report("float32 K10 against the float32 plain solve", runs[torch.float32, False], runs[torch.float32, True])
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
