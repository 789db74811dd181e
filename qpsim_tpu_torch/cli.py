"""Command-line interface: ``python -m qpsim_tpu_torch <command>``.

Port of ``qpsim_tpu.cli``: the same subcommands, with the same options,
outputs and exit codes — run a setup, sweep it, precompute caches,
validate physics, generate and view the analytic benchmark suite, inspect
and export GDS layouts, compare and render saved simulations, profile a
run, sweep the qubit junction model, benchmark (``bench``: the port's
``qpsim_tpu_torch.bench``, one JSON line) — plus ``--device {cuda,cpu}``
(default ``cuda``) on every command that computes.  A command asked to
run on ``cuda`` without a card exits with code 2 and names ``--device
cpu``; nothing falls back quietly.  ``view``,
``view-tests`` and ``compare`` import matplotlib (``view --gif`` also
Pillow) when they run.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path


def _cmd_info(args: argparse.Namespace) -> int:
    import subprocess

    import torch

    from . import __version__
    from .geometry.gds import native_raster_available
    from .utils.cuda_build import library_path, nvcc_version

    print(f"qpsim_tpu_torch {__version__}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda or 'none (CPU build)'}")
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            print(f"  device: cuda:{i} {torch.cuda.get_device_name(i)}")
        try:
            card = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                capture_output=True, text=True, timeout=60,
            ).stdout.strip()
        except (OSError, subprocess.TimeoutExpired):
            card = ""
        print(f"card (name, power limit): {card or 'nvidia-smi unavailable'}")
    else:
        print("device: no CUDA device (commands take --device cpu)")
    print(f"nvcc: {nvcc_version() or 'not found'}")
    lib = library_path()
    source_hash = lib.stem.rsplit("_", 1)[-1]
    print(f"kernel library: {'built' if lib.is_file() else 'not built'} (source hash {source_hash}, {lib})")
    print(f"native GDS rasterizer: {'yes' if native_raster_available() else 'no (numpy fallback)'}")
    return 0


def _ensure_device(device: str) -> None:
    """Fail fast when ``cuda`` is asked for and no card is present."""
    import torch

    if device == "cuda" and not torch.cuda.is_available():
        raise ValueError(
            "no CUDA device is available (torch.cuda.is_available() is False); "
            "pass --device cpu to run the plain PyTorch path on the CPU"
        )


def _cmd_validate(args: argparse.Namespace) -> int:
    from .validation import run_fast_validation_suite

    _ensure_device(args.device)
    report = run_fast_validation_suite(device=args.device)
    payload = report.as_dict()
    if args.json:
        print(json.dumps(payload, indent=2, default=float))
    else:
        for name, section in payload.items():
            if isinstance(section, dict):
                status = "PASS" if section.get("passed") else "FAIL"
                detail = {
                    k: v for k, v in section.items() if k not in ("passed",)
                }
                print(f"{status}  {name}: {detail}")
        print("overall:", "PASS" if payload["overall_passed"] else "FAIL")
    return 0 if payload["overall_passed"] else 1


def _cmd_run(args: argparse.Namespace) -> int:
    from .io.storage import load_setup
    from .runner import run_setup

    _ensure_device(args.device)
    setup_path = Path(args.setup)
    setup = load_setup(setup_path)
    print(f"setup '{setup.name}' ({setup.setup_id}): "
          f"{len(setup.geometry.edges)} edges, gap={setup.parameters.energy_gap} ueV")

    p = setup.parameters
    if not args.stream_dir:
        from .io.stream import estimate_history_memory

        est = estimate_history_memory(
            grid_shape=(len(setup.geometry.mask), len(setup.geometry.mask[0])),
            dt=p.dt,
            total_time=p.total_time,
            store_every=p.store_every,
            num_energy_bins=p.num_energy_bins if p.energy_gap > 0 else 0,
            record_phonons=bool(p.export_phonon_history)
            or (p.energy_gap > 0 and (p.enable_recombination or p.enable_scattering)),
        )
        warn_gb = float(os.environ.get("QPSIM_STREAM_WARN_GB", "4"))
        if est > warn_gb * 2**30:
            print(
                f"warning: stored history needs ~{est / 2**30:.1f} GB of host RAM "
                f"(> {warn_gb:g} GB); consider --stream-dir DIR to stream frames "
                "to disk instead",
                file=sys.stderr,
            )

    def progress(t, frame):
        print(f"  t = {t:.6g} ns", file=sys.stderr)

    mesh = None
    if args.space_shards is not None:
        from .parallel.mesh import local_devices, make_mesh

        if args.space_shards < 1:
            print(
                f"error: --space-shards must be >= 1, got {args.space_shards}",
                file=sys.stderr,
            )
            return 2
        devices = local_devices(args.device)
        if args.space_shards > len(devices):
            print(
                f"error: --space-shards {args.space_shards} exceeds the "
                f"{len(devices)} available device(s)",
                file=sys.stderr,
            )
            return 2
        mesh = make_mesh(n_space=args.space_shards, devices=devices[: args.space_shards])
        print(f"space-sharded over {args.space_shards} device(s)")

    result, saved = run_setup(
        setup,
        setup_path=setup_path,
        progress_callback=progress if args.verbose else None,
        save=not args.no_save,
        save_path=Path(args.output) if args.output else None,
        diffusion_backend=args.backend,
        collision_backend=args.collision_backend,
        strang_mode=args.strang_mode,
        checkpoint_dir=args.checkpoint_dir,
        stream_dir=args.stream_dir,
        snapshot_detail=args.snapshot_detail,
        freeze_phonon_dynamics=args.freeze_phonons,
        mesh=mesh,
        device=args.device,
    )
    meta = result.metadata
    print(f"done: {len(result.times)} stored frames, final t = {result.times[-1]:.6g} ns")
    if args.stream_dir:
        print(f"frames streamed to: {meta['streamed_frames_dir']}")
    print(f"mass: {result.mass_over_time[0]:.6g} -> {result.mass_over_time[-1]:.6g}")
    print(f"energy diagnostics ({meta['diagnostics_mode']}): "
          f"residual range [{min(meta['energy_exchange_residual']):.3g}, "
          f"{max(meta['energy_exchange_residual']):.3g}]")
    if saved:
        print(f"saved: {saved}")
    elif "save_error" in meta:
        print(f"save failed: {meta['save_error']}", file=sys.stderr)
        return 1
    return 0


def _cmd_sweep(args: argparse.Namespace) -> int:
    from .io.storage import load_setup
    from .sweep import build_variants, parse_vary, run_sweep

    setup_path = Path(args.setup)
    setup = load_setup(setup_path)
    try:
        axes = [parse_vary(spec) for spec in args.vary]
        variants = build_variants(setup, axes, args.mode)
    except ValueError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2
    print(
        f"setup '{setup.name}': {len(variants)} variant(s) over "
        + " x ".join(f"{f}[{len(v)}]" for f, v in axes)
    )
    if args.dry_run:
        for i, (overrides, _) in enumerate(variants):
            print(f"  {i:03d}: " + ", ".join(f"{k}={v}" for k, v in overrides.items()))
        return 0

    _ensure_device(args.device)
    summary = run_sweep(
        setup,
        axes,
        mode=args.mode,
        out_dir=args.out_dir,
        setup_path=setup_path,
        save_results=not args.no_save,
        resume=args.resume,
        progress=lambda msg: print(f"  {msg}", file=sys.stderr),
        diffusion_backend=args.backend,
        collision_backend=args.collision_backend,
        strang_mode=args.strang_mode,
        freeze_phonon_dynamics=args.freeze_phonons,
        device=args.device,
    )
    for rec in summary["variants"]:
        label = ", ".join(f"{k}={v}" for k, v in rec["overrides"].items())
        if "error" in rec:
            print(f"  {rec['index']:03d} [{label}]: FAILED {rec['error']}")
        else:
            print(
                f"  {rec['index']:03d} [{label}]: mass {rec['mass_initial']:.4g} -> "
                f"{rec['mass_final']:.4g} (peak {rec['mass_peak']:.4g})"
                + (" [resumed]" if rec.get("resumed") else "")
            )
    print(f"summary: {summary['summary_path']}")
    return 1 if summary["n_failed"] else 0


def _cmd_precompute(args: argparse.Namespace) -> int:
    import numpy as np

    from .geometry.mask import mask_from_lists
    from .io.precompute import estimate_precompute_memory, precompute_arrays
    from .io.storage import load_setup, save_precomputed

    setup_path = Path(args.setup)
    setup = load_setup(setup_path)
    mask = mask_from_lists(setup.geometry.mask)
    arrays = precompute_arrays(
        mask,
        setup.geometry.edges,
        setup.boundary_conditions,
        setup.parameters,
        progress_callback=lambda msg: print(f"  {msg}", file=sys.stderr),
        include_collision_kernels=args.kernels,
    )
    est = estimate_precompute_memory(
        int(mask.sum()),
        setup.parameters.num_energy_bins,
        bool(np.asarray(arrays["is_uniform"]).reshape(-1)[0]),
        args.kernels,
    )
    path = save_precomputed(setup_path, arrays)
    print(f"saved {path} (~{est / 1e6:.1f} MB payload)")
    return 0


def _cmd_gen_tests(args: argparse.Namespace) -> int:
    from .testcases.generator import generate_test_suite
    from .io.storage import save_test_suite

    _ensure_device(args.device)
    suite = generate_test_suite(
        nx=args.nx, total_time=args.total_time, store_every=args.store_every,
        device=args.device,
    )
    path = save_test_suite(suite, Path(args.output) if args.output else None)
    n = sum(len(g.cases) for g in suite.geometry_groups)
    print(f"generated {n} cases in {len(suite.geometry_groups)} groups -> {path}")
    return 0


def _cmd_gds_info(args: argparse.Namespace) -> int:
    from collections import Counter

    from .geometry.gds import read_gds_library, read_gds_polygons

    lib = read_gds_library(args.file)
    print(f"library '{lib.name}': {len(lib.cells)} cells, "
          f"unit {lib.unit_user} user / {lib.unit_meters} m")
    for cell in lib.cells.values():
        print(f"  cell '{cell.name}': {len(cell.polygons)} polygons, "
              f"{len(cell.references)} references")
    polys = read_gds_polygons(args.file)
    per_layer = Counter(p.layer for p in polys)
    for layer in sorted(per_layer):
        print(f"  layer {layer}: {per_layer[layer]} flattened polygons")
    return 0


def _cmd_export_gds(args: argparse.Namespace) -> int:
    import numpy as np

    from .geometry.gds import write_gds
    from .geometry.mask import mask_from_lists, mask_to_polygons
    from .io.storage import load_setup

    setup = load_setup(args.setup)
    mask = mask_from_lists(setup.geometry.mask)
    dx = float(setup.geometry.mesh_size)
    polys = mask_to_polygons(mask, dx=dx)
    out = write_gds(args.output, {"MASK": [(args.layer, p) for p in polys]})
    filled = int(np.asarray(mask, dtype=bool).sum())
    print(f"exported {len(polys)} polygons ({filled} cells, dx={dx}) -> {out}")
    return 0


def _cmd_compare(args: argparse.Namespace) -> int:
    import numpy as np

    from .io.storage import load_simulation
    from .ui.playback import result_frames

    a = load_simulation(args.a)
    b = load_simulation(args.b)
    failures = []

    def check(name, xs, ys, *, rtol):
        xs, ys = np.asarray(xs, dtype=np.float64), np.asarray(ys, dtype=np.float64)
        if xs.shape != ys.shape:
            failures.append(name)
            print(f"  {name}: SHAPE {xs.shape} vs {ys.shape}")
            return
        if (np.isnan(xs) != np.isnan(ys)).any():
            failures.append(name)
            print(f"  {name}: NaN masks differ")
            return
        xs, ys = np.nan_to_num(xs), np.nan_to_num(ys)
        scale = max(np.abs(xs).max(), np.abs(ys).max(), 1e-300)
        err = float(np.abs(xs - ys).max() / scale)
        status = "ok" if err <= rtol else "DIFF"
        if err > rtol:
            failures.append(name)
        print(f"  {name}: max rel err {err:.3e} ({status})")

    print(f"A: '{a.setup_name}' ({a.simulation_id}), {len(a.frames)} frames")
    print(f"B: '{b.setup_name}' ({b.simulation_id}), {len(b.frames)} frames")
    # times are producer arithmetic (t += dt vs k·dt), not physics: compare
    # at --rtol, not exactly, so cross-producer runs don't fail on the ulp
    check("times", a.times, b.times, rtol=args.rtol)
    check("mass_over_time", a.mass_over_time, b.mass_over_time, rtol=args.rtol)
    if len(a.frames) == len(b.frames):
        fa, fb = result_frames(a), result_frames(b)
        check("frames", fa, fb, rtol=args.rtol)
    else:
        failures.append("frames")
        print(f"  frames: COUNT {len(a.frames)} vs {len(b.frames)}")
    for attr in ("energy_frames", "phonon_frames"):
        va, vb = getattr(a, attr), getattr(b, attr)
        if (va is None) != (vb is None):
            failures.append(attr)
            print(f"  {attr}: present in only one result")
        elif va is not None:
            # None encodes NaN in stored frames; float64 coercion restores it
            check(attr, va, vb, rtol=args.rtol)
    if failures:
        print(f"DIFFER beyond rtol={args.rtol}: {', '.join(failures)}")
        return 1
    print(f"MATCH within rtol={args.rtol}")
    return 0


def _cmd_profile(args: argparse.Namespace) -> int:
    import time as _time

    from .io.storage import load_setup
    from .runner import run_setup

    _ensure_device(args.device)
    setup = load_setup(args.setup)
    if args.steps is not None:
        if args.steps < 1:
            raise ValueError("--steps must be >= 1")
        setup.parameters.total_time = setup.parameters.dt * args.steps
    n_steps = max(1, round(setup.parameters.total_time / setup.parameters.dt))

    def timed_run():
        t0 = _time.time()
        run_setup(setup, save=False, device=args.device)
        return _time.time() - t0

    first = timed_run()
    if args.trace_dir:
        from .utils.profiling import trace

        with trace(args.trace_dir):
            steady = timed_run()
    else:
        steady = timed_run()

    print(f"profiled '{setup.name}': {n_steps} steps of dt={setup.parameters.dt} ns")
    # the port compiles no program per run: its kernels are built once per
    # checkout (build/qpsim_tpu_torch), so --fresh-cache has nothing to clear
    cache_note = " (the kernel library is built once per checkout; --fresh-cache changes nothing)" \
        if args.fresh_cache else " (includes loading, or first building, the kernel library)"
    print(f"first run (incl. warm-up): {first:.3f} s{cache_note}")
    print(
        f"second run: {steady:.3f} s "
        f"({steady / n_steps * 1e3:.3f} ms/step); warm-up ~{first - steady:.3f} s"
    )
    if args.trace_dir:
        print(f"trace -> {args.trace_dir} (trace.json: chrome://tracing or Perfetto; "
              "key_averages.txt: time by operation and kernel)")
    return 0


def _cmd_view(args: argparse.Namespace) -> int:
    from .io.storage import load_simulation
    from .ui.playback import export_simulation_images

    sim_path = Path(args.simulation)
    # a sweep summary (or its directory): render calibration curves
    summary_path = None
    if sim_path.is_file() and sim_path.name == "sweep_summary.json":
        summary_path = sim_path
    elif sim_path.is_dir() and (sim_path / "sweep_summary.json").is_file() and not (
        sim_path / "manifest.json"
    ).is_file():
        summary_path = sim_path / "sweep_summary.json"
    if summary_path is not None:
        from .ui.playback import export_sweep_curves

        summary = json.loads(summary_path.read_text())
        out_dir = Path(args.out) if args.out else summary_path.parent / "curves"
        written = export_sweep_curves(summary, out_dir, dpi=args.dpi)
        print(
            f"sweep '{summary.get('setup_name', '?')}': "
            f"{summary.get('n_variants', 0)} variants "
            f"({summary.get('n_failed', 0)} failed)"
        )
        print(f"wrote {len(written)} curve images -> {out_dir}")
        return 0
    render_kw = dict(
        frames=args.frames,
        phonons=args.phonons,
        energy_bin=args.bin,
        mass=not args.no_mass,
        cmap=args.cmap,
        dpi=args.dpi,
    )
    if sim_path.is_dir():
        # a streamed-frames directory (see 'run --stream-dir'): render one
        # shard at a time — streams exist because the full history does NOT
        # fit in host RAM, so never round-trip through SimulationResultData
        from .io.stream import load_frame_stream
        from .ui.playback import export_stream_images

        reader = load_frame_stream(sim_path)
        out_dir = Path(args.out) if args.out else sim_path.parent / (sim_path.name + "_frames")
        written = export_stream_images(reader, out_dir, **render_kw)
        name = str(reader.metadata.get("setup_name", sim_path.name))
        sim_id = str(reader.metadata.get("simulation_id", f"stream-{sim_path.name}"))
        n_frames, times = reader.count, reader.times
    else:
        result = load_simulation(sim_path)
        out_dir = Path(args.out) if args.out else sim_path.parent / (sim_path.stem + "_frames")
        written = export_simulation_images(result, out_dir, **render_kw)
        name, sim_id = result.setup_name, result.simulation_id
        n_frames, times = len(result.frames), result.times
    if args.mkid is not None:
        import numpy as np

        from .observables import mkid_response_trace
        from .ui.playback import export_mkid_response

        if sim_path.is_dir():
            if not reader.has_energy_frames:
                print("error: this stream carries no per-bin spectral frames "
                      "(needed for --mkid)", file=sys.stderr)
                return 2
            gap = float(reader.metadata.get("energy_gap") or 0.0)
            gamma = float(reader.metadata.get("dynes_gamma") or 0.0)
            ef_iter = (reader.energy_frames(i) for i in range(reader.count))
            eb = reader.energy_bins
        else:
            if not result.energy_frames:
                print("error: this simulation stores no per-bin spectral "
                      "frames (needed for --mkid)", file=sys.stderr)
                return 2
            gap = float(result.metadata.get("energy_gap") or 0.0)
            gamma = float(result.metadata.get("dynes_gamma") or 0.0)
            from .io.storage import frame_from_jsonable

            ef_iter = (
                [frame_from_jsonable(fr) for fr in frames_k]
                for frames_k in result.energy_frames
            )
            eb = result.energy_bins
        if gap <= 0.0:
            # older results may not record the gap; infer from the grid
            gap = float(eb[0]) - 0.5 * (float(eb[1]) - float(eb[0]))
        try:
            resp = mkid_response_trace(
                ef_iter, np.asarray(eb, float), gap,
                readout_ghz=args.mkid, alpha=args.mkid_alpha,
                dynes_gamma=gamma,
            )
        except ValueError as exc:
            print(f"error: {exc}", file=sys.stderr)
            return 2
        written.append(
            export_mkid_response(times, resp, out_dir, dpi=args.dpi)
        )
    if args.gif:
        from .ui.playback import write_gif

        frame_pngs = sorted(p for p in written if p.name.startswith("frame_"))
        gif = write_gif(frame_pngs, out_dir / "movie.gif", fps=args.fps)
        written.append(gif)
    print(
        f"simulation '{name}' ({sim_id}): "
        f"{n_frames} stored frames, t = {times[0]:.6g}"
        f"..{times[-1]:.6g} ns"
    )
    print(f"wrote {len(written)} images -> {out_dir}")
    return 0


def _cmd_view_tests(args: argparse.Namespace) -> int:
    from .io.storage import load_test_geometry_group, load_test_suite
    from .ui.playback import export_case_images

    manifest = Path(args.manifest)
    suite = load_test_suite(manifest, load_group_cases=False)
    out_root = Path(args.out) if args.out else manifest.parent / (manifest.stem + "_images")
    total = 0
    for group in suite.geometry_groups:
        if args.group and group.geometry_id != args.group:
            continue
        cases = group.cases or load_test_geometry_group(manifest, group.geometry_id).cases
        for case in cases:
            if args.case and args.case.lower() not in case.title.lower() \
                    and args.case != case.case_id:
                continue
            dest = out_root / group.geometry_id / case.case_id
            written = export_case_images(case, dest, frames=args.frames, dpi=args.dpi)
            total += len(written)
            print(f"  {group.geometry_id}/{case.case_id}: {len(written)} images")
    if not total:
        raise ValueError(
            f"no cases matched (group={args.group!r}, case={args.case!r}); "
            f"groups: {[g.geometry_id for g in suite.geometry_groups]}"
        )
    print(f"wrote {total} images -> {out_root}")
    return 0


def _cmd_qubit_sweep(args: argparse.Namespace) -> int:
    """Gap-asymmetric junction temperature sweep (Marchegiani 2025)."""
    import numpy as np

    from .qubit import JunctionParams, temperature_sweep

    _ensure_device(args.device)
    params = JunctionParams(
        gap_L=args.gap_l,
        gap_R=args.gap_r,
        omega_10=args.omega10,
        gamma_ph=args.gamma_ph_hz * 1e-9,
        cooper_pairs_L=args.cooper_pairs,
        tau_R=args.tau_r_ns,
    )
    params.validate()
    lo, hi, n = args.temps
    out = temperature_sweep(
        params,
        np.linspace(float(lo), float(hi), int(n)),
        photons_on=not args.photons_off,
        l_rates=dict(
            l_00=args.l00, l_11=args.l11, l_10=args.l10, l_01=args.l01
        ),
        device=args.device,
    )
    rows = [
        dict(
            T_K=float(T),
            x_L=float(out["states"][k, 0]),
            x_Rgt=float(out["states"][k, 1]),
            x_Rlt=float(out["states"][k, 2]),
            p1=float(out["p1"][k]),
            mu_ueV=[float(v) for v in out["mu_ueV"][k]],
            parity_hz=float(out["parity_rate_per_ns"][k]) * 1e9,
            regime=out["regimes"][k],
        )
        for k, T in enumerate(out["temperatures_K"])
    ]
    if args.json:
        print(json.dumps(rows, indent=1))
    else:
        print(f"{'T (K)':>7} {'x_L':>10} {'mu_L':>8} {'mu_R>':>8} "
              f"{'mu_R<':>8} {'parity (Hz)':>12}  regime")
        for r in rows:
            mu = r["mu_ueV"]
            print(f"{r['T_K']:7.3f} {r['x_L']:10.3e} {mu[0]:8.2f} "
                  f"{mu[1]:8.2f} {mu[2]:8.2f} {r['parity_hz']:12.1f}  "
                  f"{r['regime']}")
    return 0


def _cmd_bench(args: argparse.Namespace) -> int:
    from .bench import main as bench_main

    return bench_main(["--device", args.device])


#: the subcommands that compute, each with ``--device``
COMPUTES = ("validate", "run", "sweep", "gen-tests", "profile", "qubit-sweep", "bench")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="qpsim_tpu_torch",
        description="Quasiparticle & phonon kinetics simulator on PyTorch and CUDA.",
    )
    sub = parser.add_subparsers(dest="command", required=True)

    sub.add_parser("info", help="show versions, the card, the kernel library, native components").set_defaults(
        fn=_cmd_info
    )

    v = sub.add_parser("validate", help="run the fast physics validation suite")
    v.add_argument("--json", action="store_true", help="machine-readable output")
    v.set_defaults(fn=_cmd_validate)

    r = sub.add_parser("run", help="run a setup JSON file")
    r.add_argument("setup", help="path to a setup .json")
    r.add_argument("--output", help="explicit output path for the simulation JSON")
    r.add_argument("--no-save", action="store_true", help="don't persist the result")
    r.add_argument(
        "--backend", default="auto", choices=("auto", "dense", "adi", "cg", "wang", "pallas")
    )
    r.add_argument(
        "--collision-backend",
        dest="collision_backend",
        default="auto",
        choices=("auto", "kernel", "plain", "xla", "pallas"),
        help="collision integrator: 'auto' (the CUDA kernels on the card, "
        "their plain versions on the CPU), 'kernel', 'plain'; 'pallas' and "
        "'xla' are aliases of the last two",
    )
    r.add_argument(
        "--strang-mode",
        dest="strang_mode",
        default="auto",
        choices=("auto", "exact", "merged"),
        help="'auto' (default) fuses adjacent collision half-steps between "
        "stored frames wherever that applies (~40%% faster coupled steps, "
        "same splitting order; generation injected at the seams); 'exact' "
        "pins the reference's per-step C(dt/2) D C(dt/2) composition",
    )
    r.add_argument("--verbose", action="store_true", help="print stored-step progress")
    r.add_argument(
        "--stream-dir",
        dest="stream_dir",
        help="stream stored frames to this directory as NPZ shards instead of "
        "holding them in RAM (bounded-memory long runs; view with 'view DIR')",
    )
    r.add_argument(
        "--snapshot-detail",
        dest="snapshot_detail",
        choices=("full", "integrated"),
        default="full",
        help="'integrated' reduces each stored snapshot on device and pulls "
        "only integrated frames + per-bin sums (~NE x less device->host "
        "traffic; requires --stream-dir in energy-resolved mode)",
    )
    r.add_argument(
        "--checkpoint-dir",
        dest="checkpoint_dir",
        help="checkpoint directory: snapshots are saved there and an "
        "interrupted run resumes from the latest one",
    )
    r.add_argument(
        "--freeze-phonons",
        dest="freeze_phonons",
        action="store_true",
        help="pin the phonon bath at its thermal state (the instantly-"
        "rethermalizing-substrate limit of MKID decay analyses)",
    )
    r.add_argument(
        "--space-shards",
        dest="space_shards",
        type=int,
        help="shard the grid by rows over N local devices (the mesh= hot "
        "loop: halo rows, then pencil transposes or the Wang interface rows); "
        "requires energy-resolved mode and a grid divisible by N in both "
        "dimensions.  N is at most torch.cuda.device_count() on cuda, and on "
        "the CPU XLA_FLAGS' --xla_force_host_platform_device_count (else 1)",
    )
    r.set_defaults(fn=_cmd_run)

    sw = sub.add_parser(
        "sweep",
        help="run a setup over a parameter grid and summarize the results",
    )
    sw.add_argument("setup", help="path to a setup .json")
    sw.add_argument(
        "--vary",
        action="append",
        required=True,
        metavar="FIELD=SPEC",
        help="sweep axis: FIELD=v1,v2,... or FIELD=lo:hi:N (inclusive "
        "linspace); FIELD is a SimulationParameters field (tau_0, "
        "bath_temperature, dynes_gamma, ...) or external_generation.<field> "
        "(rate, pulse_rate, ...); repeatable",
    )
    sw.add_argument(
        "--mode",
        choices=("product", "zip"),
        default="product",
        help="'product' crosses all axes; 'zip' pairs them index-by-index",
    )
    sw.add_argument(
        "--out-dir",
        dest="out_dir",
        default="sweep_results",
        help="directory for per-variant result JSONs + sweep_summary.json",
    )
    sw.add_argument("--no-save", action="store_true", help="summary only, no result files")
    sw.add_argument(
        "--resume",
        action="store_true",
        help="reuse variants whose result file already exists in --out-dir "
        "(an interrupted sweep picks up where it stopped)",
    )
    sw.add_argument(
        "--dry-run", action="store_true", help="list the variants without running"
    )
    sw.add_argument(
        "--backend", default="auto", choices=("auto", "dense", "adi", "cg", "wang", "pallas")
    )
    sw.add_argument(
        "--collision-backend",
        dest="collision_backend",
        default="auto",
        choices=("auto", "kernel", "plain", "xla", "pallas"),
    )
    sw.add_argument(
        "--strang-mode",
        dest="strang_mode",
        default="auto",
        choices=("auto", "exact", "merged"),
    )
    sw.add_argument(
        "--freeze-phonons",
        dest="freeze_phonons",
        action="store_true",
        help="pin the phonon bath at its thermal state for every variant",
    )
    sw.set_defaults(fn=_cmd_sweep)

    p = sub.add_parser("precompute", help="build + save a setup's .precompute.npz sidecar")
    p.add_argument("setup")
    p.add_argument("--kernels", action="store_true", help="include collision kernels")
    p.set_defaults(fn=_cmd_precompute)

    g = sub.add_parser("gen-tests", help="generate the 28-case analytic benchmark suite")
    g.add_argument("--nx", type=int, default=100)
    g.add_argument("--total-time", type=float, default=8.0, dest="total_time")
    g.add_argument("--store-every", type=int, default=2, dest="store_every")
    g.add_argument("--output")
    g.set_defaults(fn=_cmd_gen_tests)

    gi = sub.add_parser("gds-info", help="inspect a GDSII file")
    gi.add_argument("file")
    gi.set_defaults(fn=_cmd_gds_info)

    eg = sub.add_parser(
        "export-gds", help="export a setup's rasterized mask back to GDSII polygons"
    )
    eg.add_argument("setup", help="setup JSON path")
    eg.add_argument("output", help="output .gds path")
    eg.add_argument("--layer", type=int, default=1)
    eg.set_defaults(fn=_cmd_export_gds)

    cp = sub.add_parser(
        "compare",
        help="compare two saved simulations field by field (max rel err)",
    )
    cp.add_argument("a", help="simulation .json (e.g. reference-produced)")
    cp.add_argument("b", help="simulation .json to compare against")
    cp.add_argument("--rtol", type=float, default=1e-6)
    cp.set_defaults(fn=_cmd_compare)

    pr = sub.add_parser(
        "profile",
        help="time a setup's run (warm-up vs steady-state) and optionally "
        "capture a torch.profiler trace",
    )
    pr.add_argument("setup", help="path to a setup .json")
    pr.add_argument("--steps", type=int, help="override the horizon to N steps")
    pr.add_argument(
        "--trace-dir", dest="trace_dir", help="write a torch.profiler trace here"
    )
    pr.add_argument(
        "--fresh-cache",
        dest="fresh_cache",
        action="store_true",
        help="accepted for the JAX package's CLI; the port builds its kernels "
        "once per checkout and keeps no per-run compile cache",
    )
    pr.set_defaults(fn=_cmd_profile)

    vw = sub.add_parser(
        "view",
        help="render a saved simulation to PNG images (headless viewer)",
    )
    vw.add_argument(
        "simulation",
        help="path to a simulation .json, or a streamed-frames directory "
        "(see 'run --stream-dir')",
    )
    vw.add_argument("--out", help="output directory (default: <sim>_frames/)")
    vw.add_argument(
        "--frames",
        default="all",
        help="which stored frames: 'all', 'last', 'first', '0,3,-1', or a "
        "start:stop:step slice (default: all)",
    )
    vw.add_argument(
        "--phonons", action="store_true", help="also render phonon frames"
    )
    vw.add_argument(
        "--bin",
        type=int,
        default=None,
        help="also render one energy bin's spectral-density frames",
    )
    vw.add_argument("--no-mass", action="store_true", help="skip the mass-trace plot")
    vw.add_argument(
        "--gif", action="store_true", help="also assemble frames into movie.gif"
    )
    vw.add_argument("--fps", type=float, default=8.0, help="GIF frame rate")
    vw.add_argument(
        "--mkid",
        type=float,
        default=None,
        metavar="GHZ",
        help="also render the Mattis–Bardeen readout response (δf/f and "
        "δ(1/Q) at this readout frequency) from the stored spectral frames",
    )
    vw.add_argument(
        "--mkid-alpha",
        dest="mkid_alpha",
        type=float,
        default=1.0,
        help="kinetic-inductance fraction α scaling the --mkid response",
    )
    vw.add_argument("--cmap", default="inferno")
    vw.add_argument("--dpi", type=int, default=110)
    vw.set_defaults(fn=_cmd_view)

    vt = sub.add_parser(
        "view-tests",
        help="render analytic-suite cases (simulated vs analytic) to PNGs",
    )
    vt.add_argument("manifest", help="test-suite manifest .json (see gen-tests)")
    vt.add_argument("--out", help="output root (default: <manifest>_images/)")
    vt.add_argument("--group", help="only this geometry_id")
    vt.add_argument("--case", help="only cases whose title contains this (or exact case_id)")
    vt.add_argument("--frames", default="last", help="frame selection per case (default: last)")
    vt.add_argument("--dpi", type=int, default=110)
    vt.set_defaults(fn=_cmd_view_tests)

    qs = sub.add_parser(
        "qubit-sweep",
        help="gap-asymmetric junction regime sweep (Marchegiani 2025)",
    )
    qs.add_argument("--gap-l", type=float, default=190.0, help="Δ_L (µeV)")
    qs.add_argument("--gap-r", type=float, default=180.0, help="Δ_R (µeV)")
    qs.add_argument("--omega10", type=float, default=20.0, help="qubit ω₁₀ (µeV)")
    qs.add_argument(
        "--gamma-ph-hz", type=float, default=300.0,
        help="photon-assisted parity rate γ^ph (Hz)",
    )
    qs.add_argument(
        "--cooper-pairs", type=float, default=1e9,
        help="Cooper-pair number of the high-gap electrode (2ν₀Δ_L·V)",
    )
    qs.add_argument("--tau-r-ns", type=float, default=5e4, help="R>→R< relaxation (ns)")
    qs.add_argument(
        "--temps", nargs=3, metavar=("LO", "HI", "N"), default=(0.02, 0.28, 14),
        help="temperature sweep: lo hi n (K)",
    )
    qs.add_argument("--l00", type=float, default=3.0, help="Γ̃^L_00 (1/ns per x)")
    qs.add_argument("--l11", type=float, default=2.0)
    qs.add_argument("--l10", type=float, default=5.0)
    qs.add_argument("--l01", type=float, default=1.0)
    qs.add_argument("--photons-off", action="store_true",
                    help="thermal-relaxation limit (no photon drive)")
    qs.add_argument("--json", action="store_true")
    qs.set_defaults(fn=_cmd_qubit_sweep)

    b = sub.add_parser("bench", help="run the benchmark's 15 stages (prints one JSON line; exit 1 if a stage "
                       "fails, 2 without a card)")
    b.set_defaults(fn=_cmd_bench)

    for name in COMPUTES:
        sub.choices[name].add_argument(
            "--device", default="cuda", choices=("cuda", "cpu"),
            help="'cuda' (default; exits with code 2 without a card) or 'cpu' "
            "(every kernel's plain PyTorch version)",
        )
    return parser


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return args.fn(args)
    except (FileNotFoundError, ValueError) as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    raise SystemExit(main())
