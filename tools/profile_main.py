#!/usr/bin/env python3
"""Where a path's time goes, on one CUDA GPU.

Run from the root of a checkout:
    python3 tools/profile_main.py [--path coupled|scalar] [--out DIR]

``--path coupled`` (the default) drives the configuration of
``chip_smoke.py`` phase 4 (1024² intrinsic rectangle × 16 energy bins,
100 steps, float32, merged stepping, pulse generation); ``--path scalar``
the scalar path of phase 6 (full 1024² film, energy_gap=0, float32), here
2000 steps stored every 500.  Both go through
``qpsim_tpu_torch.run_2d_crank_nicolson``, and the script prints:

1. whole-call ms/step at two ``store_every`` values (host clock), so the
   cost of the stored frames shows as the difference;
2. a cProfile of one call, by cumulative host time;
3. a torch.profiler table of one call by device self time, and the
   device's busy share: the summed self time of the device's own events
   over the call's wall time (the profiler's own host overhead is inside
   that wall time).

With ``--out DIR`` the profiler's Chrome trace goes to
``DIR/profile_<path>_trace.json``.  Kernels build at first use, as in
``chip_smoke.py``.  Needs one CUDA GPU; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import cProfile
import os
import pstats
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import film, main_path_kwargs, scalar_kwargs  # noqa: E402

#: per path: steps, the two store_every values, and the run's keyword arguments
PATHS = {
    "coupled": (100, (25, 100), lambda: dict(main_path_kwargs(1024), dt=0.05, total_time=5.0)),
    "scalar": (2000, (500, 2000), lambda: scalar_kwargs(film(1024, 1024), dt=0.1, steps=2000,
                                                        store_every=500)),
}


def run(kw: dict, store_every: int):
    import qpsim_tpu_torch

    out = qpsim_tpu_torch.run_2d_crank_nicolson(**dict(kw, store_every=store_every))
    torch.cuda.synchronize()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--path", choices=sorted(PATHS), default="coupled")
    ap.add_argument("--out", help="directory for the Chrome trace")
    args = ap.parse_args()
    steps, store_values, make_kwargs = PATHS[args.path]
    kw = make_kwargs()
    if not torch.cuda.is_available():
        raise SystemExit("profile_main: needs a CUDA GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    print(f"path: {args.path}, {steps} steps", flush=True)
    run(kw, store_values[0])  # warm-up: builds the kernels, first allocations
    for store_every in store_values:
        t0 = time.perf_counter()
        run(kw, store_every)
        ms = 1e3 * (time.perf_counter() - t0) / steps
        print(f"store_every={store_every}: whole call {ms:.4f} ms/step (host clock)", flush=True)

    prof = cProfile.Profile()
    prof.enable()
    run(kw, store_values[0])
    prof.disable()
    pstats.Stats(prof, stream=sys.stdout).sort_stats("cumulative").print_stats(35)

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as tprof:
        t0 = time.perf_counter()
        run(kw, store_values[0])
        wall_ms = 1e3 * (time.perf_counter() - t0)
    averages = tprof.key_averages()
    print(averages.table(sort_by="self_device_time_total", row_limit=25))
    # only the device's own rows (kernels, copies): an aten op's row repeats
    # the device time of the kernels it launched
    device_ms = 1e-3 * sum(
        e.self_device_time_total for e in averages if e.device_type == DeviceType.CUDA
    )
    print(f"profiled call: wall {wall_ms:.1f} ms, device self time {device_ms:.1f} ms, "
          f"busy share {device_ms / wall_ms:.3f} — {card}", flush=True)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        tprof.export_chrome_trace(os.path.join(args.out, f"profile_{args.path}_trace.json"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
