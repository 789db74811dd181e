#!/usr/bin/env python3
"""Where a path's time goes, on one CUDA GPU.

Run from the root of a checkout:
    python3 tools/profile_main.py [--path coupled|gapmap|ne100|scalar] [--out DIR]

``--path coupled`` (the default) drives the configuration of
``chip_smoke.py`` phase 4 (1024² intrinsic rectangle × 16 energy bins,
100 steps, float32, merged stepping, pulse generation); ``--path gapmap``
the same configuration with each gap map of phase 4b in turn (the trap,
through K3 with gap ids, and the gradient, through K4); ``--path ne100``
the uniform run of phase 4c (the same film at 100 energy bins, NW = 299,
through K5: 40 steps stored at the start and the end, and every 20 for
the second timing); ``--path scalar``
the scalar path of phase 6 (full 1024² film, energy_gap=0, float32), here
2000 steps stored every 500.  All go through
``qpsim_tpu_torch.run_2d_crank_nicolson``, and the script prints, for
each configuration:

1. whole-call ms/step at two ``store_every`` values (host clock), so the
   cost of the stored frames shows as the difference, and the host
   set-up (call to the first stored frame);
2. a cProfile of one call, by cumulative host time;
3. a torch.profiler table of one call by device self time, and the
   device's busy share: the summed self time of the device's own events
   over the call's wall time (the profiler's own host overhead is inside
   that wall time).

With ``--out DIR`` the profiler's Chrome trace goes to
``DIR/profile_<configuration>_trace.json``.  Kernels build at first use, as in
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

from chip_smoke import GAP_MAPS, film, main_path_kwargs, scalar_kwargs  # noqa: E402


def _coupled(total_time=5.0, **extra):
    return lambda: dict(main_path_kwargs(1024), dt=0.05, total_time=total_time, **extra)


#: per path, its configurations: (name, steps, the two store_every values,
#: the run's keyword arguments)
PATHS = {
    "coupled": [("coupled", 100, (25, 100), _coupled())],
    "gapmap": [(f"gapmap_{name}", 100, (25, 100), _coupled(gap_expression=expr))
               for name, expr in GAP_MAPS.items()],
    "ne100": [("ne100", 40, (40, 20), _coupled(2.0, num_energy_bins=100))],
    "scalar": [("scalar", 2000, (500, 2000), lambda: scalar_kwargs(
        film(1024, 1024), dt=0.1, steps=2000, store_every=500))],
}


def run(kw: dict, store_every: int) -> float:
    """One call; returns its set-up in seconds (call to the first stored frame)."""
    import qpsim_tpu_torch

    stamps: list[float] = []
    t0 = time.perf_counter()
    qpsim_tpu_torch.run_2d_crank_nicolson(
        **dict(kw, store_every=store_every),
        progress_callback=lambda t, f: stamps.append(time.perf_counter()),
    )
    torch.cuda.synchronize()
    return stamps[0] - t0


def profile(name: str, steps: int, store_values, kw: dict, card: str, out_dir: str | None) -> None:
    print(f"configuration: {name}, {steps} steps", flush=True)
    run(kw, store_values[0])  # warm-up: builds the kernels, first allocations
    for store_every in store_values:
        t0 = time.perf_counter()
        setup = run(kw, store_every)
        ms = 1e3 * (time.perf_counter() - t0) / steps
        print(f"store_every={store_every}: whole call {ms:.4f} ms/step (host clock), set-up "
              f"{setup:.3f} s", flush=True)

    prof = cProfile.Profile()
    prof.enable()
    run(kw, store_values[0])
    prof.disable()
    pstats.Stats(prof, stream=sys.stdout).sort_stats("cumulative").print_stats(35)

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as tprof:
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
    print(f"{name}: profiled call: wall {wall_ms:.1f} ms, device self time {device_ms:.1f} ms, "
          f"busy share {device_ms / wall_ms:.3f} — {card}", flush=True)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        tprof.export_chrome_trace(os.path.join(out_dir, f"profile_{name}_trace.json"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--path", choices=sorted(PATHS), default="coupled")
    ap.add_argument("--out", help="directory for the Chrome traces")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_main: needs a CUDA GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    for name, steps, store_values, make_kwargs in PATHS[args.path]:
        profile(name, steps, store_values, make_kwargs(), card, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
