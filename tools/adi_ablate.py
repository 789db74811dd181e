#!/usr/bin/env python3
"""Where K2's time goes: the fused ADI kernel with one part of its work taken out at a time.

Run from the root of a checkout, on one NVIDIA GPU:
    python3 tools/adi_ablate.py

Each variant is this checkout's ``csrc/adi.cu`` (with ``csrc/adi_staged.cuh``)
with one textual change, built by its own ``nvcc`` (all at once) into
``build/adi_ablate/<variant>/`` and loaded in place of the port's library
for the K2 wrappers of ``ops/adi_cuda.py``:

- ``as built``: no change (it must agree with the plain version);
- ``no plane loads``: the seven geometry-plane loads of a cell (explicit
  lo, hi, diag, the source, solve lo, hi, diag) replaced by constants;
- ``no explicit-plane loads``: the four of the rhs (lo, hi, diag, source);
- ``no solve-plane loads``: the three of the coefficients a, b, c;
- ``no neighbour loads``: the rhs takes the cell's own state for both
  neighbours, so the y half reads one state value a cell and not three
  (the x half carries its neighbours in registers and keeps its loads);
- ``no interface``: the one-thread-per-line interface recurrence skipped.

Every variant but the first computes another function: none is a
candidate, each says what its part costs.  Each is timed in a CUDA graph
(``chip_smoke.graph_ms``) on ``chip_smoke.py``'s inputs, float32: the x
and y halves on the 1024² rectangle at 16 and 100 bins, one plane.  It
prints, per variant and half, the time and the scaled error against the
plain version, then the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

_FETCH = ("    v[2] = uc + as * (__ldg(elo + q) * up + __ldg(ehi + q) * dn + __ldg(ediag + q) * uc +\n"
          "                      __ldg(src + q));\n"
          "    v[0] = p > 0 ? -as * __ldg(slo + q) : T(0);\n"
          "    v[1] = p + 1 < n ? -as * __ldg(shi + q) : T(0);\n"
          "    v[3] = T(1) - as * __ldg(sdiag + q);\n")
_RHS_CONST = ("    v[2] = uc + as * (T(0.25) * up + T(0.25) * dn + T(-0.5) * uc +\n"
              "                      T(0));\n")
_COEF_CONST = ("    v[0] = p > 0 ? -as * T(0.25) : T(0);\n"
               "    v[1] = p + 1 < n ? -as * T(0.25) : T(0);\n"
               "    v[3] = T(1) - as * T(-0.5);\n")
_RHS = _FETCH.split("    v[0]")[0]
_COEF = "    v[0]" + _FETCH.split("    v[0]", 1)[1]

#: variant -> [(file, old text, new text)]
VARIANTS = {
    "as built": [],
    "no plane loads": [("adi.cu", _FETCH, _RHS_CONST + _COEF_CONST)],
    "no explicit-plane loads": [("adi.cu", _RHS, _RHS_CONST)],
    "no solve-plane loads": [("adi.cu", _COEF, _COEF_CONST)],
    "no neighbour loads": [("adi.cu", "__ldg(elo + q) * up + __ldg(ehi + q) * dn",
                            "__ldg(elo + q) * uc + __ldg(ehi + q) * uc")],
    "no interface": [("adi_staged.cuh", "  if (g.k > 1 && cw == 0) pol.interface(slots, table, l);\n", "")],
}


def build(name: str, edits) -> Path:
    """Write the variant's sources and build them into one library."""
    from qpsim_tpu_torch.utils.cuda_build import _NVCC_FLAGS, _nvcc

    csrc = ROOT / "qpsim_tpu_torch" / "csrc"
    out = ROOT / "build" / "adi_ablate" / name.replace(" ", "_")
    out.mkdir(parents=True, exist_ok=True)
    texts = {f: (csrc / f).read_text() for f in ("adi.cu", "adi_staged.cuh")}
    for f, old, new in edits:
        if texts[f].count(old) != 1:
            raise SystemExit(f"{name}: the text to change is not found once in {f}")
        texts[f] = texts[f].replace(old, new)
    for f, text in texts.items():
        (out / f).write_text(text)
    lib = out / "libadi.so"
    proc = subprocess.run([_nvcc(), *_NVCC_FLAGS, "-shared", "-o", str(lib), str(out / "adi.cu")],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"{name}: nvcc failed\n{proc.stdout}\n{proc.stderr}")
    return lib


def load(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    for half in ("x", "y"):
        for suffix in ("f32", "f64"):
            fn = getattr(lib, f"qp_adi_{half}_{suffix}")
            fn.argtypes = [P] * 10 + [I, I, I, I, I, D, P]
            fn.restype = I
    return lib


def main() -> int:
    import torch

    import chip_smoke as cs
    from qpsim_tpu_torch.ops import adi_cuda

    card = cs.phase_environment()
    with ThreadPoolExecutor(max_workers=len(VARIANTS)) as pool:
        libs = dict(zip(VARIANTS, pool.map(lambda kv: build(*kv), VARIANTS.items())))
    alpha = 0.025
    results = {}
    for nb in (16, 100):
        planes, u = cs.adi_planes(cs.rectangle(1024), torch.float32, nb=nb)
        refs = {"x": adi_cuda.adi_x_half_plain(u, planes, alpha), "y": adi_cuda.adi_y_half_plain(u, planes, alpha)}
        for name, path in libs.items():
            lib = load(path)
            adi_cuda.load_kernels = lambda lib=lib: lib
            for half, kern in (("x", adi_cuda.adi_x_half), ("y", adi_cuda.adi_y_half)):
                err = cs.scaled_err(kern(u, planes, alpha), refs[half])
                if name == "as built":
                    cs.check(f"K2 {half} 1024²×{nb} as built", err, cs.TOL[("adi", torch.float32)])
                ms = cs.graph_ms(lambda: kern(u, planes, alpha), 20 if nb == 16 else 5)
                results[(name, half, nb)] = ms
                print(f"  K2 {half} 1024²×{nb} {name}: {ms:.4f} ms in a CUDA graph, scaled error "
                      f"against the plain version {err:.3e}", flush=True)
        del planes, u, refs
        torch.cuda.empty_cache()
    print(f"== K2 ablations, ms in a CUDA graph — {card}")
    for name in VARIANTS:
        print(f"  {name:>24}: " + ", ".join(
            f"{h} ×{nb} {results[(name, h, nb)]:.4f}" for nb in (16, 100) for h in "xy"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
