#!/usr/bin/env python3
"""Where K3's and K4's time goes: the pair-walk kernel with one part of its work changed at a time.

Run from the root of a checkout, on one NVIDIA GPU:
    python3 tools/collisions_ablate.py

Each variant is this checkout's ``csrc/collisions.cu`` (its float32 entry,
with ``csrc/collision_math.cuh``) with one textual change, built by its own
``nvcc`` (all at once) into ``build/collisions_ablate/<variant>/`` and
loaded in place of the port's library for the wrappers of
``ops/collisions_cuda.py``:

- ``as built``: no change (it must agree with the plain version);
- ``general walk only``: the simple form never taken, so the main path's
  16 bins run the general walk (groups and constant indices read at run
  time);
- ``5 blocks per SM``: ``__launch_bounds__(128, 5)``, fewer registers a
  thread for more warps;
- ``no row update``: each ω row written as n + a − b, without the
  frozen-coefficient solve (its exp, expm1 and division);
- ``no QP update``: the bins written as q + p·gain − loss, without the
  relaxation (its exp, expm1 and division);
- ``approximate division``: the two divisions of the update rules by
  ``__fdividef`` (2 ulp, no slow path);
- ``expm1 as exp − 1``: the update rules' expm1 by exp − 1.

Every variant but the first three computes another function: none is a
candidate, each says what its part costs.
Each variant is timed with CUDA events (``chip_smoke.time_ms``) on
``chip_smoke.py``'s inputs at 1024² × 16, float32, with the dt·g plane:
K3 on a uniform gap, with random G = 3 gap ids and with the trap disc's
ids, and K4 on a random Δ plane.  It prints, per variant and form, the
time and the scaled error against the plain version, then the card's name
and power limit.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

#: variant -> [(file, old text, new text)]
VARIANTS = {
    "as built": [],
    "general walk only": [("collisions.cu", "if (simple != 0) {", "if (false) {")],
    "5 blocks per SM": [("collisions.cu", "__launch_bounds__(kBlock) collision_step_kernel",
                         "__launch_bounds__(kBlock, 5) collision_step_kernel")],
    "no row update": [("collisions.cu", "affine(__ldg(ph_in + w * n_pix + p), acc[2 * w * cs],\n"
                       "                                     acc[(2 * w + 1) * cs], dt);",
                       "__ldg(ph_in + w * n_pix + p) + acc[2 * w * cs] - acc[(2 * w + 1) * cs];")],
    "no QP update": [("collisions.cu", "relax(acc[i * cs], acc[(kBins + i) * cs], acc[(2 * kBins + i) * cs], dt)",
                      "acc[i * cs] + acc[(kBins + i) * cs] - acc[(2 * kBins + i) * cs]")],
    "approximate division": [
        ("collision_math.cuh", "-dexpm1(-mu * dt) / (mu < floor ? floor : mu)",
         "__fdividef(-dexpm1(-mu * dt), mu < floor ? floor : mu)"),
        ("collision_math.cuh", "dexpm1(x) / b", "__fdividef(dexpm1(x), b)")],
    "expm1 as exp − 1": [
        ("collision_math.cuh", "-dexpm1(-mu * dt)", "-(dexp(-mu * dt) - T(1))"),
        ("collision_math.cuh", "tiny ? dt : dexpm1(x) / b", "tiny ? dt : (dexp(x) - T(1)) / b")],
}

#: (label, chip_smoke.collision_setup kind)
FORMS = (("K3", "uniform"), ("K3 gap ids G=3", "gid"), ("K3 trap ids", "trap"), ("K4", "analytic"))


def build(name: str, edits) -> Path:
    """Write the variant's sources and build its float32 entry into a library."""
    from qpsim_tpu_torch.utils.cuda_build import _NVCC_FLAGS, _nvcc

    csrc = ROOT / "qpsim_tpu_torch" / "csrc"
    out = ROOT / "build" / "collisions_ablate" / name.replace(" ", "_")
    out.mkdir(parents=True, exist_ok=True)
    texts = {f: (csrc / f).read_text() for f in ("collisions.cu", "collision_math.cuh")}
    for f, old, new in edits:
        if texts[f].count(old) != 1:
            raise SystemExit(f"{name}: the text to change is not found once in {f}")
        texts[f] = texts[f].replace(old, new)
    for f, text in texts.items():
        (out / f).write_text(text)
    lib = out / "libcollisions.so"
    proc = subprocess.run([_nvcc(), *_NVCC_FLAGS, "-shared", "-o", str(lib), str(out / "collisions.cu")],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"{name}: nvcc failed\n{proc.stdout}\n{proc.stderr}")
    report = [ln for ln in proc.stdout.splitlines() + proc.stderr.splitlines() if "Used" in ln or "spill" in ln]
    print(f"  {name}: ptxas {' | '.join(r.split(':', 1)[-1].strip() for r in report[:12])}", flush=True)
    return lib


def load(path: Path) -> ctypes.CDLL:
    from qpsim_tpu_torch.utils import cuda_build

    lib = ctypes.CDLL(str(path))
    full = cuda_build.load_kernels()  # its declarations: the argument types of the entry
    fn = lib.qp_collision_step_f32
    fn.argtypes, fn.restype = full.qp_collision_step_f32.argtypes, full.qp_collision_step_f32.restype
    return lib


def main() -> int:
    import torch

    import chip_smoke as cs
    from qpsim_tpu_torch.ops import collisions_cuda

    card = cs.phase_environment()
    with ThreadPoolExecutor(max_workers=len(VARIANTS)) as pool:
        libs = dict(zip(VARIANTS, pool.map(lambda kv: build(*kv), VARIANTS.items())))
    results = {}
    for label, kind in FORMS:
        kern, plain, _, _, q, ph, gen = cs.collision_setup(16, 1024, torch.float32, kind=kind)
        ref = plain(q, ph, 0.05, gen)
        for name, path in libs.items():
            lib = load(path)
            collisions_cuda.load_kernels = lambda lib=lib: lib
            got = kern(q, ph, 0.05, gen)
            torch.cuda.synchronize()
            err = max(cs.scaled_err(got[0], ref[0]), cs.scaled_err(got[1], ref[1]))
            if name in ("as built", "general walk only", "5 blocks per SM"):  # the candidates
                cs.check(f"{label} 1024²×16 {name}", err, cs.TOL[(cs.COLLISION_KINDS[
                    "gid" if kind == "trap" else kind], torch.float32)])
            results[(name, label)] = cs.time_ms(lambda: kern(q, ph, 0.05, gen), 20)
            print(f"  {label} 1024²×16 {name}: {results[(name, label)]:.4f} ms (events), scaled error "
                  f"against the plain version {err:.3e}", flush=True)
        del kern, plain, q, ph, gen, ref
        torch.cuda.empty_cache()
    print(f"== K3/K4 ablations at 1024² × 16, float32, ms (events) — {card}")
    for name in VARIANTS:
        print(f"  {name:>24}: " + ", ".join(f"{label} {results[(name, label)]:.4f}" for label, _ in FORMS))
    return 0


if __name__ == "__main__":
    sys.exit(main())
