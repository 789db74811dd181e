#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``qpsim_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, one line (or a few) each; any failure is an uncaught exception and
a non-zero exit:

1. environment — the card, torch/CUDA versions, the TF32 flags;
2. build — compiles ``qpsim_tpu_torch/csrc/*.cu`` with nvcc (first use);
3. each kernel against its plain PyTorch version on the card, float64 and
   float32, at the shapes listed below;
4. the main path: ``run_2d_crank_nicolson`` on the 1024² intrinsic
   rectangle × 16 energy bins, 100 steps, float32, default (merged)
   stepping, with launch counters proving it ran through both kernels,
   timed over three calls (steady-state ms/step and set-up apart); then
   each kernel checked against its plain version at those shapes, and
   both timed;
5. the same physics on a 128² grid in float64 for 20 steps, kernels
   against the plain path end to end;
6. a JSON line with the kernels' numbers, the card line, and a last JSON
   line ``{"ok": true, "device": {...}}``.

Errors are "scaled max errors": max|kernel − plain| / max|plain| over the
compared arrays.  Kernel timings use CUDA events after a warm-up.  The
script imports nothing of JAX; it exits non-zero without CUDA.  For where
the main path's time goes, run ``tools/profile_main.py``.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

F32, F64 = torch.float32, torch.float64
TOL = {("collision_step", F64): 1e-10, ("collision_step", F32): 5e-7,
       ("adi", F64): 1e-10, ("adi", F32): 5e-6}


def scaled_err(got, ref) -> float:
    got, ref = (t.detach().double().cpu().numpy() for t in (got, ref))
    return float(np.max(np.abs(got - ref))) / max(1e-300, float(np.max(np.abs(ref))))


def abs_err(got, ref) -> float:
    return float((got.double() - ref.double()).abs().max())


def check(label: str, err: float, tol: float) -> None:
    ok = err <= tol
    print(f"  {label}: max rel err {err:.3e} (tol {tol:.0e}) {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"{label}: {err:.3e} > {tol:.0e}")


def time_ms(fn, reps: int) -> float:
    """Mean ms per call on the card (CUDA events, after one warm-up call)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------- helpers


def collision_setup(ne, n, dtype, *, phonons=True, seed=0):
    """Plan, kernel tables and a random state at NE bins on an n×n grid."""
    from qpsim_tpu_torch.ops.collisions import build_collision_plan_arrays
    from qpsim_tpu_torch.ops.collisions_cuda import build_kernel_tables
    from qpsim_tpu_torch.ops.dos import dynes_density_of_states, thermal_phonon_occupation
    from qpsim_tpu_torch.ops.energy_grid import build_energy_grid
    from qpsim_tpu_torch.ops.kernels import recombination_kernel_base, scattering_kernel_base
    from qpsim_tpu_torch.ops.phonon_map import build_phonon_frequency_map

    E, dE = build_energy_grid(180.0, 1.0, 4.0, ne)
    pm = build_phonon_frequency_map(E)
    rho = dynes_density_of_states(E, 180.0, 0.0)
    plan = build_collision_plan_arrays(
        dE=dE, rho=rho, K_r0=recombination_kernel_base(E, 180.0, 440.0, 1.2),
        K_s0=scattering_kernel_base(E, 180.0, 440.0, 1.2), pmap=pm,
        enable_recombination=True, enable_scattering=True, update_phonons=phonons,
        device="cuda", dtype=dtype,
    )
    rng = np.random.default_rng(seed)
    q = rng.uniform(0.0, 2e-3, (ne, n, n)) * rho[:, None, None]
    ph = thermal_phonon_occupation(pm.omega_bins, 0.25)[:, None, None] * rng.uniform(
        0.5, 2.0, (pm.num_omega, n, n)
    )
    gen = rng.uniform(0.0, 1e-6, (n, n))
    as_t = lambda a: torch.as_tensor(a, dtype=dtype, device="cuda")
    return plan, build_kernel_tables(plan), as_t(q), as_t(ph), as_t(gen)


def rectangle(n):
    from qpsim_tpu_torch.geometry.mask import create_intrinsic_geometry, mask_from_lists
    from qpsim_tpu_torch.models.params import BoundaryCondition

    geo = create_intrinsic_geometry(width=n, height=n)
    mask = mask_from_lists(geo.mask)
    return mask, geo.edges, {e.edge_id: BoundaryCondition(kind="reflective") for e in geo.edges}


def donut(n):
    from qpsim_tpu_torch.geometry.mask import extract_edge_segments
    from qpsim_tpu_torch.models.params import BoundaryCondition

    yy, xx = np.mgrid[0:n, 0:n] - (n - 1) / 2.0
    r = np.hypot(yy, xx)
    mask = (r < 0.45 * n) & (r > 0.2 * n)
    edges = extract_edge_segments(mask)
    kinds = [("absorbing", None, None), ("reflective", None, None), ("robin", 0.3, 0.1)]
    bcs = {}
    for i, e in enumerate(edges):
        kind, value, aux = kinds[i % 3]
        bcs[e.edge_id] = BoundaryCondition(kind=kind, value=value, aux_value=aux)
    return mask, edges, bcs


def adi_planes(geometry, dtype, nb=16, seed=1):
    from qpsim_tpu_torch.ops.adi_cuda import AdiPlanes
    from qpsim_tpu_torch.ops.diffusion import build_directional_stencils, fold_diffusion
    from qpsim_tpu_torch.ops.dos import diffusion_coefficient_of_energy
    from qpsim_tpu_torch.ops.energy_grid import build_energy_grid

    mask, edges, bcs = geometry
    E, _ = build_energy_grid(180.0, 1.0, 4.0, nb)
    D = diffusion_coefficient_of_energy(6.0, E, 180.0)  # per-bin D(E)
    op = fold_diffusion(*build_directional_stencils(mask, edges, bcs, 1.0), mask, 1.0, D)
    planes = AdiPlanes.from_operator(op, "cuda", dtype)
    u = np.random.default_rng(seed).uniform(0.0, 1e-5, (nb, *mask.shape)) * mask[None]
    return planes, torch.as_tensor(u, dtype=dtype, device="cuda")


def reset_counts():
    from qpsim_tpu_torch.ops import adi_cuda, collisions_cuda

    for table in (adi_cuda.LAUNCHES, collisions_cuda.LAUNCHES):
        for k in table:
            table[k] = 0


def main_path_kwargs(n):
    from qpsim_tpu_torch.models.params import ExternalGenerationSpec

    mask, edges, bcs = rectangle(n)
    init = np.zeros(mask.shape)
    init[mask] = 1e-5
    return dict(
        mask=mask, edges=edges, edge_conditions=bcs, initial_field=init,
        diffusion_coefficient=6.0, dx=1.0, energy_gap=180.0, energy_max_factor=4.0,
        num_energy_bins=16, enable_recombination=True, enable_scattering=True,
        bath_temperature=0.1,
        external_generation=ExternalGenerationSpec(
            mode="pulse", pulse_start=0.5, pulse_duration=1.0, pulse_rate=1e-5
        ),
    )


# ---------------------------------------------------------------- phases


def phase_environment() -> str:
    print("== 1 environment", flush=True)
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False — needs a CUDA GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"  card: {card}")
    print(f"  python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    print(f"  torch.backends.cuda.matmul.allow_tf32 = {torch.backends.cuda.matmul.allow_tf32}, "
          f"torch.backends.cudnn.allow_tf32 = {torch.backends.cudnn.allow_tf32}, "
          f"float32 matmul precision = {torch.get_float32_matmul_precision()}", flush=True)
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("float32 matmuls must run in full precision (allow_tf32 is True)")
    torch.cuda.set_device(0)
    return card


def phase_build() -> None:
    print("== 2 build", flush=True)
    from qpsim_tpu_torch.utils.cuda_build import build_dir, load_kernels, ptxas_report

    t0 = time.perf_counter()
    load_kernels()
    print(f"  kernels built and loaded in {time.perf_counter() - t0:.1f} s ({build_dir()})")
    # registers, stack and spills per kernel, from nvcc -Xptxas -v
    name = None
    for line in ptxas_report().splitlines():
        m = re.search(r"Compiling entry function '.*?(adi_[xy]_kernel|collision_step_kernel)I([fd])E", line)
        if m:
            name = f"{m.group(1)}<{'float' if m.group(2) == 'f' else 'double'}>"
        elif name and ("stack frame" in line or "Used" in line):
            print(f"  ptxas {name}: {line.split(':', 1)[-1].strip()}")
    sys.stdout.flush()


def phase_kernels_vs_plain() -> None:
    print("== 3 kernels against their plain versions on the card", flush=True)
    from qpsim_tpu_torch.ops import adi_cuda
    from qpsim_tpu_torch.ops.collisions_cuda import collision_step, collision_step_plain

    for ne, n in ((16, 256), (50, 128)):
        for dtype in (F64, F32):
            for phonons in (True, False):
                plan, tables, q, ph, gen = collision_setup(ne, n, dtype, phonons=phonons)
                for g in (None, gen):
                    ref = collision_step_plain(plan, q, ph, 0.025, g)
                    got = collision_step(plan, tables, q, ph, 0.025, g)
                    torch.cuda.synchronize()
                    err = max(scaled_err(got[0], ref[0]), scaled_err(got[1], ref[1]))
                    check(f"collision_step NE={ne} {n}² {str(dtype)[6:]} gen={g is not None} "
                          f"phonons={phonons}", err, TOL[("collision_step", dtype)])
    for name, geometry in (("rectangle 1024²", rectangle(1024)), ("donut 256²", donut(256))):
        for dtype in (F64, F32):
            planes, u = adi_planes(geometry, dtype)
            alpha = 0.025
            ux_ref = adi_cuda.adi_x_half_plain(u, planes, alpha)
            ux = adi_cuda.adi_x_half(u, planes, alpha)
            uy_ref = adi_cuda.adi_y_half_plain(ux_ref, planes, alpha)
            uy = adi_cuda.adi_y_half(ux_ref, planes, alpha)
            step = adi_cuda.adi_step(u, planes, alpha)
            torch.cuda.synchronize()
            tol = TOL[("adi", dtype)]
            check(f"adi_x_half {name}×16 {str(dtype)[6:]}", scaled_err(ux, ux_ref), tol)
            check(f"adi_y_half {name}×16 {str(dtype)[6:]}", scaled_err(uy, uy_ref), tol)
            check(f"adi_step   {name}×16 {str(dtype)[6:]}", scaled_err(step, uy_ref), tol)


def phase_main_path(card: str) -> list[dict]:
    print("== 4 main path: 1024² × 16 bins, 100 steps, float32, merged stepping", flush=True)
    import qpsim_tpu_torch
    from qpsim_tpu_torch.ops import adi_cuda, collisions_cuda
    from qpsim_tpu_torch.solver.stepping import _plan_segments, _split_time

    dt, total, store_every = 0.05, 5.0, 25
    kw = dict(main_path_kwargs(1024), dt=dt, total_time=total, store_every=store_every)
    t0 = time.perf_counter()
    qpsim_tpu_torch.run_2d_crank_nicolson(**kw)  # warm-up
    torch.cuda.synchronize()
    print(f"  warm-up run {time.perf_counter() - t0:.2f} s", flush=True)

    full, rem, _ = _split_time(total, dt)
    segments = _plan_segments(full, rem, dt, store_every)
    steps = sum(s.length for s in segments)
    expect = {
        "collision_step": sum(s.length + 1 if s.length > 1 else 2 for s in segments),
        "collision_step_with_gen": steps,
        "adi_x_half": steps,
        "adi_y_half": steps,
    }
    def timed_run():
        """One call: its result and (steady ms/step, set-up s, whole-call ms).

        Set-up runs from the call to the first stored frame (t = 0); the
        steady state from the first to the last stored frame (host clock),
        which holds every step and the other stored frames.
        """
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        stamps: list[float] = []
        t_call = time.perf_counter()
        start.record()
        out = qpsim_tpu_torch.run_2d_crank_nicolson(
            **kw, progress_callback=lambda t, f: stamps.append(time.perf_counter())
        )
        end.record()
        end.synchronize()
        return out, (1e3 * (stamps[-1] - stamps[0]) / steps, stamps[0] - t_call,
                     start.elapsed_time(end))

    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    (times, frames, mass, clim, ef, _), first = timed_run()
    counts = {**collisions_cuda.LAUNCHES, **adi_cuda.LAUNCHES}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    print(f"  launches {counts} (expected {expect})")
    if counts != expect:
        raise AssertionError(f"launch counts {counts} != {expect}")
    mask = kw["mask"]
    for f in frames:
        if not (np.all(np.isfinite(f[mask])) and np.all(np.isnan(f[~mask]))):
            raise AssertionError("frames must be finite inside the mask and NaN outside")
    print(f"  stored times {times}")
    print(f"  mass {mass}")
    if not (len(times) == len(segments) + 1 and abs(times[-1] - total) < 1e-9):
        raise AssertionError(f"unexpected stored times {times}")
    if not (mass[1] > mass[0] and mass[2] > mass[0]):
        raise AssertionError("mass must rise during the pulse")
    runs = [first] + [timed_run()[1] for _ in range(2)]
    for i, (st, su, wh) in enumerate(runs):
        print(f"  run {i + 1}: steady state {st:.3f} ms/step (host clock, first to last stored "
              f"frame, {steps} steps); set-up {su:.3f} s (call to first stored frame); whole "
              f"call {wh / steps:.3f} ms/step (CUDA events)")
    med = sorted(r[0] for r in runs)[1]
    print(f"  end to end: steady state median {med:.3f} ms/step over {len(runs)} runs "
          f"(range {min(r[0] for r in runs):.3f}–{max(r[0] for r in runs):.3f}); "
          f"peak device memory {peak_gib:.2f} GiB — {card}", flush=True)

    # each kernel against its plain version at the main path's shapes, then their times
    from qpsim_tpu_torch.ops.collisions_cuda import collision_step, collision_step_plain

    plan, tables, q, ph, gen = collision_setup(16, 1024, F32)
    ref = collision_step_plain(plan, q, ph, dt, gen)
    got = collision_step(plan, tables, q, ph, dt, gen)
    torch.cuda.synchronize()
    tol = TOL[("collision_step", F32)]
    check("collision_step NE=16 1024² float32 gen=True phonons=True, q", scaled_err(got[0], ref[0]), tol)
    check("collision_step NE=16 1024² float32 gen=True phonons=True, ph", scaled_err(got[1], ref[1]), tol)
    rows = []
    k3 = dict(
        name="collision_step", route="cuda", source="qpsim_tpu_torch/csrc/collisions.cu",
        replaces="qpsim_tpu/ops/pallas_collisions.py:169",
        launches=counts["collision_step"],
        max_abs_err=max(abs_err(got[0], ref[0]), abs_err(got[1], ref[1])),
        ms=time_ms(lambda: collision_step(plan, tables, q, ph, dt, gen), 20),
        plain_ms=time_ms(lambda: collision_step_plain(plan, q, ph, dt, gen), 3),
    )
    rows.append(k3)
    planes, u = adi_planes(rectangle(1024), F32)
    alpha = 0.5 * dt
    ux_ref = adi_cuda.adi_x_half_plain(u, planes, alpha)
    ux = adi_cuda.adi_x_half(u, planes, alpha)
    uy_ref = adi_cuda.adi_y_half_plain(ux_ref, planes, alpha)
    uy = adi_cuda.adi_y_half(ux_ref, planes, alpha)
    torch.cuda.synchronize()
    check("adi_x_half rectangle 1024²×16 float32", scaled_err(ux, ux_ref), TOL[("adi", F32)])
    check("adi_y_half rectangle 1024²×16 float32", scaled_err(uy, uy_ref), TOL[("adi", F32)])
    for name, line, err, kern, plain in (
        ("adi_x_half", 225, abs_err(ux, ux_ref), adi_cuda.adi_x_half, adi_cuda.adi_x_half_plain),
        ("adi_y_half", 275, abs_err(uy, uy_ref), adi_cuda.adi_y_half, adi_cuda.adi_y_half_plain),
    ):
        rows.append(dict(
            name=name, route="cuda", source="qpsim_tpu_torch/csrc/adi.cu",
            replaces=f"qpsim_tpu/ops/pallas_adi.py:{line}", launches=counts[name],
            max_abs_err=err,
            ms=time_ms(lambda: kern(u, planes, alpha), 20),
            plain_ms=time_ms(lambda: plain(u, planes, alpha), 3),
        ))
    for r in rows:
        print(f"  {r['name']}: kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, "
              f"max abs err {r['max_abs_err']:.3e} (1024² × 16, float32) — {card}")
    sys.stdout.flush()
    return rows


def phase_end_to_end_f64() -> None:
    print("== 5 end to end, float64, 128² × 16 bins, 20 steps: kernels against plain", flush=True)
    import qpsim_tpu_torch

    kw = dict(main_path_kwargs(128), dt=0.05, total_time=1.0,
              store_every=5, dtype=F64)
    a = qpsim_tpu_torch.run_2d_crank_nicolson(**kw)
    b = qpsim_tpu_torch.run_2d_crank_nicolson(
        **kw, collision_backend="plain", diffusion_backend="adi"
    )
    if a[0] != b[0]:
        raise AssertionError("stored times differ")
    np.testing.assert_allclose(a[2], b[2], rtol=1e-12, atol=0)
    for fa, fb in zip(a[1], b[1]):
        np.testing.assert_allclose(np.nan_to_num(fa), np.nan_to_num(fb), rtol=1e-10, atol=0)
    frame_err = max(
        float(np.nanmax(np.abs(fa - fb)) / np.nanmax(np.abs(fb))) for fa, fb in zip(a[1], b[1])
    )
    mass_err = float(np.max(np.abs(np.subtract(a[2], b[2])) / np.abs(b[2])))
    print(f"  frames max rel err {frame_err:.3e} (rtol 1e-10), mass max rel err "
          f"{mass_err:.3e} (rtol 1e-12) ok", flush=True)


def main() -> int:
    card = phase_environment()
    phase_build()
    phase_kernels_vs_plain()
    rows = phase_main_path(card)
    phase_end_to_end_f64()
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
