#!/usr/bin/env python3
"""Where the main path's time goes, on one CUDA GPU.

Run from the root of a checkout:  python3 tools/profile_main.py [--out DIR]

Drives the configuration of ``chip_smoke.py`` phase 4 (1024² intrinsic
rectangle × 16 energy bins, 100 steps, float32, merged stepping, pulse
generation) through ``qpsim_tpu_torch.run_2d_crank_nicolson`` and prints:

1. whole-call ms/step at ``store_every`` 25 and 100 (host clock), so the
   cost of the stored frames shows as the difference;
2. a cProfile of one call, by cumulative host time;
3. a torch.profiler table of one call by device self time, and the
   device's busy share: the summed self time of the device's own events
   over the call's wall time (the profiler's own host overhead is inside
   that wall time).

With ``--out DIR`` the profiler's Chrome trace goes to
``DIR/profile_main_trace.json``.  Kernels build at first use, as in
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

from chip_smoke import main_path_kwargs  # noqa: E402

DT, TOTAL = 0.05, 5.0
STEPS = 100


def run(store_every: int):
    import qpsim_tpu_torch

    kw = dict(main_path_kwargs(1024), dt=DT, total_time=TOTAL, store_every=store_every)
    out = qpsim_tpu_torch.run_2d_crank_nicolson(**kw)
    torch.cuda.synchronize()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="directory for the Chrome trace")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_main: needs a CUDA GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    run(25)  # warm-up: builds the kernels, first allocations
    for store_every in (25, 100):
        t0 = time.perf_counter()
        run(store_every)
        ms = 1e3 * (time.perf_counter() - t0) / STEPS
        print(f"store_every={store_every}: whole call {ms:.3f} ms/step (host clock)", flush=True)

    prof = cProfile.Profile()
    prof.enable()
    run(25)
    prof.disable()
    pstats.Stats(prof, stream=sys.stdout).sort_stats("cumulative").print_stats(35)

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as tprof:
        t0 = time.perf_counter()
        run(25)
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
        tprof.export_chrome_trace(os.path.join(args.out, "profile_main_trace.json"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
