#!/usr/bin/env python3
"""Time the tridiagonal solve (K10) of one or more checkouts, in turns, on one NVIDIA GPU.

Run from the root of a checkout:
    python3 tools/time_tridiag.py TREE [TREE ...]

Each TREE is the root of a checkout (its ``chip_smoke.py`` and
``qpsim_tpu_torch``).  The trees are timed one after the other, each in a
process of its own that builds that tree's kernels, so two versions are
compared on one card in one call (give them as parent, change, change,
parent).  Each process times the whole ``tridiag_cuda.thomas`` call (CUDA
events around back-to-back calls after a warm-up, wrapper included) on
diagonally dominant lines made from a seed, float32 unless marked:
  rows (contiguous lines): 1024, 16 K and 100 K lines of 1024, 16 K of
    1023, 64 of 16385, and 16 K of 1024 in float64;
  cols (the movedim(-2, -1) view of a contiguous (lead, n, lines) tensor,
    as ``tridiag_solve_along(-2, ...)`` hands it down): 1 × 1024, 16 ×
    1024 and 100 × 1024 lines of 1024, 16 × 1024 of 1023, and 16 × 1024
    of 1024 in float64;
  K7's ``solve_lines`` (chunks as its default) on 16 × 1024 Crank–Nicolson
    lines of 1024 at α·s = 10 (one shared plane set), beside K10 on the
    same lines in the cols layout;
the 'adi' backend's diffusion step (``ADIDiffusion``: the rhs stencils
and coefficients in torch, two solves) on the 1024² film × 16 bins under
``set_default_solver("pallas")`` (and once under "auto", the torch Thomas
loop); and, end to end, the diffusion-only 1024² × 16 film of
``chip_smoke.py`` phase 7 (d) on that backend, 20 steps, float32:
steady-state ms/step (host clock, first to last stored frame, the last
frame's host work included) and whole-call ms/step (CUDA events, set-up
included) of two calls after a warm-up.  It checks each case against its plain version once (float32 ≤
5e-6, float64 ≤ 1e-10 scaled error) and prints one line per tree and case
and a closing table with the card's name and power limit.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

#: (name, form, lead, lines, n, float64)
CASES = (
    ("rows 1024×1024", "rows", 1, 1024, 1024, False),
    ("rows 16K×1024", "rows", 1, 16 * 1024, 1024, False),
    ("rows 100K×1024", "rows", 1, 100 * 1024, 1024, False),
    ("rows 16K×1023", "rows", 1, 16 * 1024, 1023, False),
    ("rows 64×16385", "rows", 1, 64, 16385, False),
    ("rows 16K×1024 f64", "rows", 1, 16 * 1024, 1024, True),
    ("cols 1×1024×1024", "cols", 1, 1024, 1024, False),
    ("cols 16×1024×1024", "cols", 16, 1024, 1024, False),
    ("cols 100×1024×1024", "cols", 100, 1024, 1024, False),
    ("cols 16×1024×1023", "cols", 16, 1024, 1023, False),
    ("cols 16×1024×1024 f64", "cols", 16, 1024, 1024, True),
)


def system(torch, form, lead, lines, n, dtype, seed=3):
    """Dominant lines (b in [2, 3], a and c in [-0.3, -0.1]) in the layout of ``form``."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    shape = (lead, n, lines) if form == "cols" else (lead, lines, n)
    uniform = lambda lo, hi: lo + (hi - lo) * torch.rand(shape, generator=gen, device="cuda", dtype=dtype)
    view = (lambda t: t.movedim(-2, -1)) if form == "cols" else (lambda t: t)
    return tuple(view(t) for t in (uniform(-0.3, -0.1), uniform(2.0, 3.0), uniform(-0.3, -0.1),
                                   uniform(-1.0, 1.0)))


def film_kwargs(cs, np, steps=20):
    """``chip_smoke.py`` phase 7 (d): the diffusion-only 1024² × 16 film from a random field."""
    mask, edges, bcs = cs.film(1024, 1024)
    return dict(
        mask=mask, edges=edges, edge_conditions=bcs,
        initial_field=np.random.default_rng(5).uniform(0.5e-5, 1.5e-5, mask.shape),
        diffusion_coefficient=6.0, dt=0.05, total_time=0.05 * steps, dx=1.0, store_every=steps,
        energy_gap=180.0, energy_max_factor=4.0, num_energy_bins=16, bath_temperature=0.1,
        diffusion_backend="adi",
    )


def child(tree: str) -> None:
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    import chip_smoke as cs

    assert Path(cs.__file__).resolve().parent == Path(tree).resolve(), cs.__file__
    from qpsim_tpu_torch.ops import tridiag_cuda as k10
    from qpsim_tpu_torch.ops.adi_cuda import solve_lines
    from qpsim_tpu_torch.ops.tridiag import set_default_solver

    cs.phase_build()
    out = {}

    def timed(name, fn, reps, ref=None, tol=None):
        if ref is not None:
            got = fn()
            torch.cuda.synchronize()
            cs.check(name, cs.scaled_err(got, ref), tol)
            del got
        out[name] = cs.time_ms(fn, reps)
        print(f"  {tree}: {name} {out[name]:.4f} ms", flush=True)

    for name, form, lead, lines, n, f64 in CASES:
        dtype = torch.float64 if f64 else torch.float32
        args = system(torch, form, lead, lines, n, dtype)
        reps = 3 if n > 4096 else (5 if lead * lines > 20_000 else 20)
        timed(name, lambda: k10.thomas(*args), reps, k10.thomas_plain(*args), 1e-10 if f64 else 5e-6)
        del args
        torch.cuda.empty_cache()

    # the same Crank–Nicolson lines through K7 (planes lo = hi = 1, di = -2,
    # open ends) and through K10 in the cols layout
    nb, n, b, alpha_s = 16, 1024, 1024, 10.0
    gen = torch.Generator(device="cuda").manual_seed(4)
    rhs = 2 * torch.rand((nb, n, b), generator=gen, device="cuda") - 1
    lo, hi = torch.ones((1, n, b), device="cuda"), torch.ones((1, n, b), device="cuda")
    lo[:, 0] = 0.0
    hi[:, -1] = 0.0
    di = torch.full((1, n, b), -2.0, device="cuda")
    scale = torch.ones(nb, device="cuda")
    move = lambda t: t.expand(nb, n, b).contiguous().movedim(-2, -1)
    cols = (move(-alpha_s * lo), move(1.0 - alpha_s * di), move(-alpha_s * hi), rhs.movedim(-2, -1))
    ref = k10.thomas_plain(*cols)
    timed("CN cols 16×1024×1024 K10", lambda: k10.thomas(*cols), 20, ref, 5e-6)
    timed("CN 16×1024×1024 K7 solve_lines", lambda: solve_lines(rhs, lo, di, hi, scale, alpha=alpha_s), 20,
          ref.movedim(-1, -2), 5e-6)
    del cols, ref, rhs
    torch.cuda.empty_cache()

    from qpsim_tpu_torch.solver.diffusion_backends import ADIDiffusion

    step = ADIDiffusion(cs.adi_operator(cs.film(1024, 1024)), "cuda", torch.float32).make_step(0.05)
    u = torch.rand((16, 1024, 1024), generator=gen, device="cuda")
    steps = 20
    kw = film_kwargs(cs, np, steps)
    try:
        set_default_solver("auto")
        timed("adi step 1024²×16 auto", lambda: step(u), 2)
        set_default_solver("pallas")
        timed("adi step 1024²×16 pallas", lambda: step(u), 20)
        cs.timed_run(kw, steps)  # warm-up
        for i in range(2):
            _, (steady, _, whole) = cs.timed_run(kw, steps)
            out[f"film steady ms/step run {i + 1}"] = steady
            out[f"film whole-call ms/step run {i + 1}"] = whole / steps
            print(f"  {tree}: film 1024²×16 'adi' + 'pallas' run {i + 1}: steady {steady:.4f} ms/step, whole "
                  f"call {whole / steps:.4f} ms/step", flush=True)
    finally:
        set_default_solver("auto")
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
    print(f"== whole-call ms, in the order run — {card}")
    for tree, res in results:
        print(f"  {tree:>20}: " + ", ".join(f"{k} {v:.4f}" for k, v in res.items()))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--child":
        child(sys.argv[2])
    else:
        sys.exit(main(sys.argv[1:]))
