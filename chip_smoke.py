#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``qpsim_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, one line (or a few) each; any failure is an uncaught exception and
a non-zero exit:

1. environment — the card, torch/CUDA versions, the TF32 flags;
2. build — compiles ``qpsim_tpu_torch/csrc/*.cu`` with nvcc (first use)
   and prints each kernel's ptxas report, and the launch plans of the
   staged ADI kernels K1 and K2 (lines per block, chunks held at once,
   shared bytes per block) at the paths' shapes;
3. each kernel against its plain PyTorch version on the card, float64 and
   float32: the collision step (K3) on a uniform gap and with per-pixel
   gap ids (G = 3 random, G = 8 mixed in every warp, the trap disc's), the
   analytic-gap collision step (K4) on a continuous gap plane (γ = 0 and
   0.12), at NE = 1 and 2 (the validation suite's recombination gate runs
   one bin), 8, 9, 16 (the pair walk's 16 bins in registers), 11 (a
   split ω diagonal), and 17, 32, 33, 50 and 64 (where they run the column
   walk) — every form at 11, 16 and 50 bins, at the others the uniform
   gap with frozen phonons, G = 8 mixed ids and the Dynes analytic form
   (cut in PR 14 to make room for phase 11) —, the fused ADI halves (K2) with one plane and with NB
   per-pixel planes on the rectangle and the masked donut, on 250 × 255
   and 250 × 301 (ragged tiles; K = 1, and 32 chunks on 301 cells with the
   last padded), on 24 × 16384 (the two-pass form for long rows) and on
   8 × 16385 and 16385 × 8 (padded chunks in two passes), the separable ADI halves (K1) at NB = 1 and 16 on full films
   with mixed faces, on 1030 × 1020 × 16 (ragged tiles, K = 2 and 4) and
   on 16 × 65536 (two passes), and the tridiagonal solve (K10) in its rows
   and cols layouts on lines of 2 to 16385 cells (K = 1, K raised to 32
   with padded chunks, two passes, ragged blocks, 100 K lines), with zero
   couplings and NaN in the entries it must not read, on Crank–Nicolson
   lines at α·s = 10 and 10³, and through one copy into rows (a broadcast,
   mixed layouts), with exact launch counts; beyond 64
   bins the collision step on the column walk (K5) on a uniform gap and
   with gap ids, and its analytic form (K6), at NE = 65 (split ω
   diagonals), 72 (ω rows shared by a difference and a sum; with phonons
   updated and frozen), 100 and 256;
   the offset walks, explicit entry points on the same kernel: K8
   (uniform and G = 3 gap ids) at NE = 16, 72, 100 and 256 and with G = 9
   ids at 16, K9 at 16, 72 and the split 66 (there also against K3's plain
   version), and the line solve K7 (Thomas and Wang K = 32, one plane and
   NB planes, B = 1000; Thomas asked for on lines of 16385, where the
   kernel pads its chunks); and the t = 0 snapshot kernel against the
   runner's float64 host reduction of the same state on the donut
   (1024² × 16 and × 100, 512² × 300, float64 at 128² × 100, and with no
   phonons: frames bit for bit, sums within 1e-13, two launches the same
   bits), timed against its bytes bound and beside the host reduction;
4. the coupled path: ``run_2d_crank_nicolson`` on the 1024² intrinsic
   rectangle × 16 energy bins, 100 steps, float32, default (merged)
   stepping, with launch counters proving it ran through K3 and K2,
   timed over three calls (steady-state ms/step and set-up apart); then
   each kernel checked against its plain version at those shapes, and
   both timed;
4b. gap maps at the same width: the coupled path with a quasiparticle
   trap (two gaps: K3 with gap ids) and with a gap gradient (a distinct
   gap per pixel: K4), both through per-pixel D(E, x) on K2's NB planes,
   with exact launch counts, timed as in phase 4 over two calls; then
   K3-gid (random G = 3 ids, and the trap disc's coherent ids), K4 and K2
   on NB planes timed against their plain versions at 1024² × 16;
4c. beyond 64 bins: the coupled path at 100 energy bins (NW = 299), 20
   steps (cut from 40 to make room for phase 13) stored at the start and
   the end — uniform on the 1024² rectangle through K5, the trap (K5
   with gap ids) and a gradient (K6) on 512², one timed call each — with
   exact launch counts and no K3/K4 launch; then K5, K5-gid (random
   ids, and the trap disc's coherent ids) and K6 timed against their
   plain versions at 1024² × 100 (beyond 256 bins: phase 11);
4d. the explicit entry points at full width, float32: each called once
   with exact launch counts — K8 at 1024² × 100 on phase 4c's inputs
   (uniform and gap ids) and at 1024² × 256, K9 at 1024² × 72 and × 16,
   K7's ``solve_lines`` on 16 × 1024 lines of 1024 (Thomas and K = 32)
   and ``build_adi_step`` on phase 4's rectangle × 16; then each against
   its plain version and timed beside K5 (100, 72 bins), K3 (16 bins)
   and K2's fused step (agreeing to 1e-10 in float64);
5. the same physics on a 128² grid in float64 for 20 steps, kernels
   against the plain path end to end, uniform and with both gap maps;
   then at 100 bins on 64² for 10 steps (K5, K5-gid, K6);
6. the scalar path (``energy_gap=0``) on the full 1024² film, float32,
   10 000 steps: exactly one launch of each K1 half per step and none of
   K2, mass conserved, steady-state ms/step and cell-steps/s over three
   calls; then K1 timed against its plain version;
7. the other diffusion paths: (a) the masked 512² donut through K2, (b) a
   diffusion-only energy-resolved 1024² × 16 film through K1, (c) float64
   scalar runs holding the kernel path, K10 under
   ``set_default_solver("pallas")``, and the 'wang' and 'cg' backends
   against the plain ones; (d) the film of (b), 20 steps from a random
   field, on the 'adi' backend under ``set_default_solver("pallas")``:
   exactly 2 K10 launches a step, one of them in the cols layout, no copy,
   frames held to the auto run (K1), ms/step; then K10 timed against its
   plain version on 16 K and 1024 rows and 16 × 1024 cols of 1024;
8. the GDS film: an MKID layout (a pad, a meander PATH and an SREF'd
   capacitor) written with ``write_gds`` and rasterized to 1024² by
   ``create_geometry_from_gds`` (which rasterizer ran is printed), 16
   bins, an ``initial_condition_spec`` (gaussian QPs, Fermi–Dirac
   weights, Bose–Einstein phonons), traced custom generation and the
   photon drive (pair breaking at 2.6Δ in [1.0, 3.5) ns), 100 steps,
   float32, strang "auto": exactly 104 K3 launches with no generation
   plane and 100 + 100 K2 halves, steady ms/step over two calls beside
   the same film with neither photons nor custom generation, the set-up
   split (GDS raster, IC build, program build), a two-tone drive, the trap
   map (K3 gap ids) and the gradient (K4) under the per-pixel photon
   substep, the photon substep and the traced generation timed alone, and
   K3 with no plane and K2 on the film's planes against their plain
   versions; (8b) the layout at 8.13 µm (128²) in float64 against the
   plain path, uniform and gradient, and host-mode generation on 64²
   ("auto" → exact); (8c) ``run_fast_validation_suite(device="cuda")``
   in float64 and float32 with its figures and kernel counters (K3
   launches by bin count);
9. the setup runner, in a temporary directory deleted at the end: (9a)
   phase 4's flagship (1024² × 16, pulse, 100 steps stored every 25) as a
   setup file written with ``save_setup`` and read with ``load_setup``,
   run by ``run_setup`` in integrated detail with ``stream_dir`` and
   ``checkpoint_dir`` — exactly 104 K3 and 100 + 100 K2 launches, the
   stream bit-equal to a direct ``run_2d_crank_nicolson`` call with the
   same keywords and no sinks, the saved result loaded back, per stored
   index the shard write and the checkpoint save (ms, MB); (9a′) 256² in
   full detail, streamed, bit-equal to the direct call; (9b) the same
   setup interrupted at 3.1 ns (62 steps: a forced final store) and run
   to 5 ns into the same directories: bit-equal to 9a, the forced index
   discarded; (9c) 1024² × 100, 20 steps, integrated and streamed — 21 K5
   launches, within 1e-5 of a full-detail call's reductions; (9d) the
   scalar 1024² film, 2000 steps, streamed — 2 K1 launches a step, mass
   drift ≤ steps × float32 ε; (9e) a 2 × 1 ``run_sweep`` on 256² × 16,
   each variant bit-equal to a lone ``run_setup``, ``resume=True``
   re-running none (the analytic suite, 9f until PR 14: phase 11f);
10. the slice of observables, the qubit model, differentiable simulation
   and film ensembles: (10a) ``make_differentiable_sim`` on a 64² film ×
   16 bins, 400 steps, ``remat_chunk=20``, float64, with the total,
   spatial, phonon-spectrum and MKID observables and the gradient with
   respect to D0, τ_s, τ_r and Δ — K10 launches forward and backward
   exactly as predicted, value and gradient (by ``torch.autograd.grad``,
   the MKID traces in the loss) held to the same 400-step call with
   ``ThomasSolve`` on its plain solve (1e-10 scaled), d/dτ_r to a central
   difference, the same call's observables in float32 to the float32 tier
   (its gradient at 40 steps), the three remat modes' K10
   launches and peak memory at 40 steps; (10b) ``fit_parameters`` on
   the 1 × 64 wire (card against CPU) and ``fit_ensemble`` with 32
   members in one batch (one K10 launch per half-step for all of them);
   (10c) ``build_film_ensemble`` with 32 members of 64² × 8 bins, 200
   steps in float32, uniform (K3), per-member gaps (K4), per-member τ
   (K5's column walk with 32 int32 member ids), 8 members' τ (K3 with gap
   ids) and per-member pulse windows with the photon drive at per-member
   n̄ — exact launch counts, ms/step over a window with no host work,
   members against solo runs, separator rows exactly 0, and float64
   against the plain path; (10d) ``temperature_sweep`` over 50
   temperatures on the card against the CPU and ``mkid_response_trace``
   on phase 4's stored frames; (10e) ``"auto"`` launching K10 on CUDA
   tensors and a kernel wrapper refusing an input that requires grad;
11. more than 256 bins, the command line and the GUI's run worker:
   (11a) phase 4's physics at 1024² × 512 bins (NW 1535), float32, 2
   steps, the pulse on from t = 0, light snapshots: K5 in the staged form
   (4 launches, none in the device-memory form), ms/step; the same at 96²
   against the plain path; (11b) 512 bins in float64 at 128² (the
   device-memory form: 8 launches, all counted as ``column_walk_device``)
   against the plain path at 1e-10; (11c) 256² × 1024 bins (NW 3071),
   float32, 2 steps, the device-memory form, and K5 at 1024 bins held to
   its plain version at 128² to the float32 tier (2e-3); (11d) the two
   forms on the same float32 inputs at 256² × 512 (the trap's ids),
   bit-equality printed, each timed; (11e) the trap map (K5 gap ids) and
   a gradient (K6) at 256² × 300, 6 steps each; each form's kernel row
   held to its plain version (on 256² or 128², the plain version's time
   growing with the pixels) and timed at the run's shape; (11f) ``python
   -m qpsim_tpu_torch info`` and ``validate --json`` as subprocesses, then
   in process ``run`` (1024² × 16, 40 steps, streamed and checkpointed:
   42 K3 and 40 + 40 K2 launches), ``profile --trace-dir`` on 256² (the
   trace must name the CUDA kernels), ``gen-tests`` at its defaults in
   float32 (the 28 cases against the gates of ``tests/test_testcases.py``,
   K3 launches by bin count, no K1/K2: its films are ≤ 4096 cells; then K3
   timed on the suite's 1 × 1 cell at 1, 10 and 15 bins and on the
   validation suite's 1 × 16 strip at 24) and ``qubit-sweep --json`` on
   the card against the CPU; (11g) ``ui.run_worker`` driving
   ``run_setup`` on the card at 256² × 16 without Tk, bit-equal to a
   direct call;
12. sharding on the card (``qpsim_tpu_torch.parallel``), 4 shards of
   card 0 (``make_mesh`` with the card repeated): (a) phase 4's physics
   at 1024² × 16, float32, 15 exact steps, light snapshots, through
   ``run_2d_crank_nicolson(mesh=...)`` under the Wang and the pencil y
   solve: 8 K3 and 8 K7 (``adi_lines``: the x half, and the pencil y half
   or the Wang local solve) launches a step, frames and mass within 1e-5
   of the single-device engine, steady ms/step beside it; one bare
   sharded step's device time split into kernels, copies and glue
   (``torch.profiler``) and the host's time inside the exchange; CPU
   shards on the card's mesh refused; (b) float64 at 256² × 16 within
   1e-10 of the single-device engine (prefactored and lazy Wang, pencil),
   and K7's local solves against the plain recurrences and K10; (c) a gap
   gradient at 1024² × 16 through K4 with each shard's gap plane passed
   at call time, at 512² × 100 through K6 so, and a uniform gap at 512² ×
   100 through K5, each against its single-device run; (d) merged Strang
   with a constant generation fused into K3 (L + 1 launches a segment of
   L steps per shard); (e) the distributed exchange on NCCL at world size
   1 (``initialize_distributed`` on a localhost port) bit-equal to the
   local exchange; (f) ``run --space-shards 1 --device cuda`` in process,
   and ``--space-shards 2`` refused with exit code 2 on one card; then
   K7's rows at the sharded shapes and K4/K6's with call-time planes,
   each against its plain version;
13. the benchmark and the entry points: (a) each of the 15 stage
   functions of ``qpsim_tpu_torch.bench`` at its full width with its
   lengths cut to a few steps — exact launch counts per stage (a warm-up
   of ``WARMUP_STEPS`` and two timed runs), every payload key, finite
   positive numbers; (b) the shapes the bench runs first, each kernel
   against its plain version: K10 on the 1 × 4096 × 64 wire's x lines,
   K3's column walk at 64 bins on that one-row film, K7 on the one-device
   mesh's 256-cell lines (x and pencil y), K1 on the standalone 1024² × 16
   step; (c) ``graft_entry.entry()``'s step: 2 K3 and 1 + 1 K2 launches,
   within 1e-5 of the step on the plain versions; (d)
   ``graft_entry.dryrun_multichip(4)`` on four cells of the card;
14. a JSON line with the kernels' numbers (phase 9's rows: the kernel's
   times at the same shapes from phases 4, 4c and 6 of this run, with
   phase 9's launches, and the small-cell K3 rows; phase 10's K10, K3,
   K3-gid, K4 and column-walk rows at the slice's shapes; phase 11's K5
   and K6 rows beyond 256 bins, each with its form and shapes; phase 12's
   sharded rows; phase 13's rows at the bench's new shapes), the card
   line, and a last JSON line ``{"ok": true, "device": {...}}``.

Errors are "scaled max errors": max|kernel − plain| / max|plain| over the
compared arrays.  Kernel timings use CUDA events after a warm-up; K1's and
K2's are taken over a CUDA graph of the timed calls, so that a kernel of
tens of µs shows its own time and not the host's per-call cost; each row
of the JSON line says which (``timing``: "graph" or "events").  Each
kernel's ``bound_ms`` is the least time the card could take for the same
work: the larger of its bytes (each input read once, each output written
once) over 3.35 TB/s and its operations (counted from the algorithm,
see ``*_work``) over 67 TFLOP/s in float32 — the H100 SXM data sheet.  The
script imports nothing of JAX; it exits non-zero without CUDA.  For where
the main path's time goes, run ``tools/profile_main.py``.
"""

from __future__ import annotations

import contextlib
import io
import json
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

# the H100's peaks and the kernels' work counts, shared with qpsim_tpu_torch.bench
from qpsim_tpu_torch.ops import launch_tables
from qpsim_tpu_torch.utils.roofline import (  # noqa: F401 (re-exported for tools/*.py)
    HBM_BYTES_PER_S,
    PEAK_FLOPS,
    adi_sep_work,
    adi_work,
    bound,
    collision_work,
    kernel_tensors,
    nbytes,
    thomas_work,
)

F32, F64 = torch.float32, torch.float64
TOL = {("collision_step", F64): 1e-10, ("collision_step", F32): 5e-7,
       ("collision_step_gid", F64): 1e-10, ("collision_step_gid", F32): 5e-7,
       # the f32 tolerance of MOSAIC_PARITY_r05.json analytic_gap_gen_fused
       ("collision_step_analytic", F64): 1e-10, ("collision_step_analytic", F32): 5e-6,
       ("adi", F64): 1e-10, ("adi", F32): 5e-6,
       ("adi_sep", F64): 1e-10, ("adi_sep", F32): 5e-6,
       ("adi_lines", F64): 1e-10, ("adi_lines", F32): 5e-6,
       ("thomas", F64): 1e-10, ("thomas", F32): 5e-6}


def blocked_tol(dtype, ne: int) -> float:
    """Tolerance of the blocked kernels (K5, K6): float64 1e-10; float32 K4's
    5e-6 up to 100 bins, the JAX package's sharded float32 tier
    (MOSAIC_PARITY_r05.json) 2e-5 beyond, where 256-term sums accumulate."""
    return 1e-10 if dtype == F64 else (5e-6 if ne <= 100 else 2e-5)


#: the two gap maps of phase 4b: a quasiparticle trap (G = 2) and a gradient (G ≈ 10⁶)
GAP_MAPS = {
    "trap": "return 180.0 - 20.0 * (((x - 0.5)**2 + (y - 0.5)**2) < 0.04)",
    "gradient": "return 170.0 + 20.0 * x + 2.0 * y",
}
#: the gap maps at 100 bins (phases 4c, 5): the first bin centre is then
#: 182.7 µeV, below the largest gaps of the 170–192 µeV gradient, so its
#: initial state (the uniform gap's DOS in every bin) would fill forbidden
#: states, which the Pauli gate refuses; the gradient moves down by 20 µeV
GAP_MAPS_100 = dict(GAP_MAPS, gradient="return 150.0 + 20.0 * x + 2.0 * y")


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


def check_snapshot_reduce() -> None:
    """The t = 0 snapshot kernel against the runner's float64 host reduction of the same state
    (``light_on_host``): frames bit for bit, the bin sums, ω sums and mass within 1e-13, the same
    bits from two launches; its time against its bytes bound, beside the host reduction's."""
    from qpsim_tpu_torch.ops.snapshot_reduce_cuda import snapshot_reduce
    from qpsim_tpu_torch.solver.spectral_runner import light_on_host

    print("  snapshot_reduce: random states on the donut (a film with a hole)", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(20)
    for n, ne, nw, dtype, phonons in ((1024, 16, 47, F32, True), (1024, 100, 299, F32, True),
                                      (512, 300, 899, F32, True), (128, 100, 299, F64, True),
                                      (1024, 16, 47, F32, False)):
        mask = donut(n)[0]
        mask_d = torch.as_tensor(mask, device="cuda")
        q = torch.rand((ne, n, n), generator=gen, device="cuda", dtype=dtype) * 2e-5 * mask_d
        ph = torch.rand((nw, n, n), generator=gen, device="cuda", dtype=dtype) * 3e-2 * mask_d
        widths = np.random.default_rng(ne).uniform(1.0, 20.0, nw)
        dE = 540.0 / ne
        args = (q, ph if phonons else None, mask_d,
                torch.as_tensor(widths, device="cuda") if phonons else None, dE)
        got = [None if g is None else g.cpu().numpy() for g in snapshot_reduce(*args)]
        again = [None if g is None else g.cpu().numpy() for g in snapshot_reduce(*args)]
        torch.cuda.synchronize()
        q_h, ph_h = q.cpu().numpy(), ph.cpu().numpy() if phonons else None
        t0 = time.perf_counter()
        host = light_on_host(q_h, ph_h, mask, dE, widths)
        host_ms = (time.perf_counter() - t0) * 1e3
        tag = f"{n}² × {ne}{f', NW {nw}' if phonons else ', no phonons'} {str(dtype)[6:]}"
        repeat = all((a is None and b is None) or a.tobytes() == b.tobytes() for a, b in zip(got, again))
        frames = [np.array_equal(got[0][mask], host[0][mask]) and not np.any(got[0][~mask])]
        sums = [scaled_err(torch.as_tensor(got[1]), torch.as_tensor(host[1])),
                abs(np.sum(got[1]) - np.sum(host[1])) / abs(np.sum(host[1]))]
        if phonons:
            frames.append(np.array_equal(got[2][mask], host[2][mask]) and not np.any(got[2][~mask]))
            sums.append(scaled_err(torch.as_tensor(got[3]), torch.as_tensor(host[3])))
        ms = time_ms(lambda: snapshot_reduce(*args), 20)
        n_bytes = (ne + (nw if phonons else 0)) * n * n * q.element_size() + n * n * (1 + 8 * (1 + phonons))
        bound = n_bytes / HBM_BYTES_PER_S * 1e3
        print(f"  snapshot_reduce {tag}: frames bit-equal {frames}, two launches bit-equal {repeat}; "
              f"kernel {ms:.4f} ms, bound {bound:.4f} ms (bytes), {100 * bound / ms:.1f} % of it; "
              f"host reduction {host_ms:.1f} ms", flush=True)
        if not (all(frames) and repeat):
            raise AssertionError(f"snapshot_reduce {tag}: frames {frames}, repeat {repeat}")
        check(f"snapshot_reduce {tag} bin sums, mass{', ω sums' if phonons else ''}", max(sums), 1e-13)
        del q, ph, got, again, host, q_h, ph_h
        torch.cuda.empty_cache()


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


def graph_ms(fn, reps: int) -> float:
    """Mean ms per call of ``reps`` calls captured in one CUDA graph (after a
    warm-up call on a side stream): the card's time for the kernels without
    the host's per-call cost, which a µs-scale kernel would otherwise show."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------- helpers


#: the collision kernels' forms and their launch counters: K3 on a uniform
#: gap, K3 with gap ids, K4; and beyond 64 bins K5, K5 with gap ids, K6
COLLISION_KINDS = {"uniform": "collision_step", "gid": "collision_step_gid",
                   "analytic": "collision_step_analytic"}
BLOCKED_KINDS = {"uniform": "collision_step_blocked", "gid": "collision_step_blocked_gid",
                 "analytic": "collision_step_blocked_analytic"}

_PMAPS: dict = {}


def phonon_map(ne, emax=4.0):
    """The energy grid (E, dE) and ω map at NE bins (Δ = 180, E_max = emax·Δ), built once per (NE, emax)."""
    from qpsim_tpu_torch.ops.energy_grid import build_energy_grid
    from qpsim_tpu_torch.ops.phonon_map import build_phonon_frequency_map

    if (ne, emax) not in _PMAPS:
        E, dE = build_energy_grid(180.0, 1.0, emax, ne)
        _PMAPS[ne, emax] = (E, dE, build_phonon_frequency_map(E))
    return _PMAPS[ne, emax]


def collision_setup(ne, n, dtype, *, kind="uniform", phonons=True, gamma=0.0, seed=0,
                    blocked=False, pixel_chunk=4096, emax=4.0):
    """A collision kernel, its plain version and a random state at NE bins on an
    n×n grid (an (ny, nx) grid where ``n`` is a pair), E_max = emax·Δ.

    ``kind`` "uniform": one gap (K3); "gid": per-gap tables for G = 3 gaps
    and random gap ids (K3 with gap ids); "gid8": G = 8 (the gap-id bound),
    random ids, so every warp mixes them; "trap": G = 2, the ids of
    ``GAP_MAPS_100["trap"]``'s disc (coherent, as a trap map's are);
    "analytic": a random continuous gap plane (K4); with ``blocked`` the
    same forms through K5 / K6 on their column tables.  The state is drawn
    on the card from ``seed``.  Returns (kernel_step, plain_step, plan,
    table tensors, q, ph, gen); each step is ``step(q, ph, dt, gen)``.
    """
    from qpsim_tpu_torch.ops import collisions_blocked_cuda as kb
    from qpsim_tpu_torch.ops import collisions_cuda as kc
    from qpsim_tpu_torch.ops.collisions import build_analytic_plan, build_collision_plan_arrays
    from qpsim_tpu_torch.ops.dos import dynes_density_of_states, thermal_phonon_occupation
    from qpsim_tpu_torch.ops.kernels import recombination_kernel_base, scattering_kernel_base

    E, dE, pm = phonon_map(ne, emax)
    rng = np.random.default_rng(seed)
    shape = (n, n) if isinstance(n, int) else tuple(n)
    if kind == "analytic":
        plane = rng.uniform(150.0, 195.0, shape)
        plan, tab = build_analytic_plan(
            E_bins=E, dE=dE, gap_plane=plane, pmap=pm, tau_s=440.0, tau_r=440.0, T_c=1.2,
            dynes_gamma=gamma, update_phonons=phonons, device="cuda", dtype=dtype,
            pixel_chunk=pixel_chunk)
        rho = np.stack([dynes_density_of_states(E, g, gamma) for g in (150.0, 195.0)]).mean(0)
        if blocked:
            tables = kb.build_column_tables(plan, tab)
            tensors = tables.kernel_tensors()
        else:
            tables = kc.build_kernel_tables(plan, tab)
            tensors = kernel_tensors(tables, tab.g2, tab.E, tab.inv_E, tab.e2, tab.zi)
        step = kb.collision_step_blocked_analytic if blocked else kc.collision_step_analytic
        kernel = lambda q, ph, dt, g: step(plan, tab, tables, q, ph, dt, g)
        plain = lambda q, ph, dt, g: kc.collision_step_analytic_plain(plan, tab, q, ph, dt, g)
    else:
        gaps = {"uniform": (180.0,), "gid": (160.0, 170.0, 180.0), "gid8": tuple(np.linspace(150.0, 185.0, 8)),
                "trap": (160.0, 180.0)}[kind]
        gid = {"uniform": None, "gid": rng.integers(0, len(gaps), shape),
               "gid8": rng.integers(0, len(gaps), shape),
               "trap": trap_ids(shape) if kind == "trap" else None}[kind]
        stack = lambda fn: np.stack([fn(E, g, 440.0, 1.2) for g in gaps])
        rho_g = np.stack([dynes_density_of_states(E, g, gamma) for g in gaps])
        plan = build_collision_plan_arrays(
            dE=dE, rho=rho_g, K_r0=stack(recombination_kernel_base),
            K_s0=stack(scattering_kernel_base), pmap=pm, enable_recombination=True,
            enable_scattering=True, update_phonons=phonons, device="cuda", dtype=dtype, gap_id=gid,
            pixel_chunk=pixel_chunk)
        rho = rho_g.mean(0)
        if blocked:
            tables = kb.build_column_tables(plan)
            tensors = tables.kernel_tensors()
        else:
            tables = kc.build_kernel_tables(plan)
            tensors = kernel_tensors(tables, plan.gap_id)
        step = kb.collision_step_blocked if blocked else kc.collision_step
        kernel = lambda q, ph, dt, g: step(plan, tables, q, ph, dt, g)
        plain = lambda q, ph, dt, g: kc.collision_step_plain(plan, q, ph, dt, g)
    draw = torch.Generator(device="cuda").manual_seed(seed)
    uniform = lambda lo, hi, shape: lo + (hi - lo) * torch.rand(
        shape, generator=draw, device="cuda", dtype=F64)
    as_t = lambda a: torch.as_tensor(a, dtype=F64, device="cuda")
    q = uniform(0.0, 2e-3, (ne, *shape)) * as_t(rho)[:, None, None]
    ph = as_t(thermal_phonon_occupation(pm.omega_bins, 0.25))[:, None, None] * uniform(
        0.5, 2.0, (pm.num_omega, *shape))
    gen = uniform(0.0, 1e-6, shape)
    return kernel, plain, plan, tensors, q.to(dtype), ph.to(dtype), gen.to(dtype)


def trap_ids(shape):
    """The gap ids of ``GAP_MAPS_100["trap"]`` on a (ny, nx) film: the disc
    (x − ½)² + (y − ½)² < 0.04 at pixel centres takes the lower gap, id 0
    in ``np.unique`` order, the rest id 1."""
    cy, cx = ((np.arange(m) + 0.5) / m for m in shape)
    return (((cx[None, :] - 0.5) ** 2 + (cy[:, None] - 0.5) ** 2) >= 0.04).astype(np.int64)


def column_counts(ne):
    """(scattering, recombination) columns of K9's grouping at NE bins (K5/K6's)."""
    _, _, pm = phonon_map(ne)
    i, j = np.meshgrid(np.arange(ne), np.arange(ne), indexing="ij")
    low = i > j
    n_scat = len(set(zip((i - j)[low], pm.idx_diff[low])))
    n_rec = len(set(zip((i + j).ravel(), pm.idx_sum.ravel())))
    return n_scat, n_rec


def walk_step(form, ne, n, *, kind="uniform", phonons=True, seed=0, dt=0.025):
    """K8 (``form`` "loop") or K9 ("rows") on :func:`collision_setup`'s
    physics at the same ``seed``: the same gaps, gap ids and K tables, so
    it takes that function's state; built for the card.  ``kind`` "gid9"
    gives K8 nine gaps and random ids."""
    from qpsim_tpu_torch.ops.collisions_loop_cuda import build_collision_step_loop
    from qpsim_tpu_torch.ops.collisions_rows_cuda import build_collision_step_rows
    from qpsim_tpu_torch.ops.dos import dynes_density_of_states
    from qpsim_tpu_torch.ops.kernels import recombination_kernel_base, scattering_kernel_base

    E, dE, pm = phonon_map(ne)
    rng = np.random.default_rng(seed)
    gaps = {"uniform": (180.0,), "gid": (160.0, 170.0, 180.0),
            "gid9": tuple(150.0 + 5.0 * g for g in range(9))}[kind]
    gid = None if kind == "uniform" else rng.integers(0, len(gaps), (n, n))
    stack = lambda fn: np.stack([fn(E, g, 440.0, 1.2) for g in gaps])
    rho_g = np.stack([dynes_density_of_states(E, g, 0.0) for g in gaps])
    args = dict(E_bins=E, dE=dE, pmap=pm, dt=dt, update_phonons=phonons, device="cuda")
    if form == "rows":  # uniform gap only
        return build_collision_step_rows(rho=rho_g[0], K_s0=stack(scattering_kernel_base)[0],
                                         K_r0=stack(recombination_kernel_base)[0], **args)
    return build_collision_step_loop(rho=rho_g, K_s0=stack(scattering_kernel_base),
                                     K_r0=stack(recombination_kernel_base), gap_id=gid, **args)


def line_system(nb, n, batch, nbp, dtype, seed=4):
    """K7's inputs: diagonally dominant (NB, N, B) lines (α = 1), NBp planes, a
    decoupled interval boundary inside the first chunk, a per-bin scale."""
    rng = np.random.default_rng(seed)
    lo = rng.uniform(-0.3, -0.1, (nbp, n, batch))
    hi = rng.uniform(-0.3, -0.1, (nbp, n, batch))
    di = rng.uniform(2.0, 3.0, (nbp, n, batch))
    lo[:, 0] = hi[:, -1] = lo[:, 17] = hi[:, 16] = 0.0
    as_t = lambda a: torch.as_tensor(a, dtype=dtype, device="cuda")
    return (as_t(rng.uniform(-1.0, 1.0, (nb, n, batch))), as_t(lo), as_t(di), as_t(hi),
            as_t(rng.uniform(1.0, 1.5, nb)))


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


def adi_operator(geometry, nb=16, seed=1, per_pixel=False):
    """The ADI operator of ``geometry``: per-bin D(E) (one plane), or with
    ``per_pixel`` a D(E, x) from a random continuous gap plane (NB planes)."""
    from qpsim_tpu_torch.ops.diffusion import build_directional_stencils, fold_diffusion
    from qpsim_tpu_torch.ops.dos import diffusion_coefficient_of_energy
    from qpsim_tpu_torch.ops.energy_grid import build_energy_grid

    mask, edges, bcs = geometry
    E, _ = build_energy_grid(180.0, 1.0, 4.0, nb)
    if per_pixel:
        gap = np.random.default_rng(seed + 7).uniform(150.0, 190.0, mask.shape)
        D = diffusion_coefficient_of_energy(6.0, E[:, None, None], gap[None])
    else:
        D = diffusion_coefficient_of_energy(6.0, E, 180.0)  # per-bin D(E)
    return fold_diffusion(*build_directional_stencils(mask, edges, bcs, 1.0), mask, 1.0, D)


def adi_planes(geometry, dtype, nb=16, seed=1, per_pixel=False):
    """K2's planes of :func:`adi_operator` and a random state."""
    from qpsim_tpu_torch.ops.adi_cuda import AdiPlanes

    planes = AdiPlanes.from_operator(adi_operator(geometry, nb, seed, per_pixel), "cuda", dtype)
    mask = geometry[0]
    u = np.random.default_rng(seed).uniform(0.0, 1e-5, (nb, *mask.shape)) * mask[None]
    return planes, torch.as_tensor(u, dtype=dtype, device="cuda")


def film(ny, nx, kinds=("reflective",)):
    """A full ny × nx film (every cell inside), one BC per face, cycling ``kinds``."""
    from qpsim_tpu_torch.geometry.mask import extract_edge_segments
    from qpsim_tpu_torch.models.params import BoundaryCondition

    mask = np.ones((ny, nx), dtype=bool)
    edges = extract_edge_segments(mask)
    bcs = {}
    for i, e in enumerate(edges):
        kind = kinds[i % len(kinds)]
        bcs[e.edge_id] = BoundaryCondition(
            kind=kind, value=0.4 if kind in ("dirichlet", "neumann", "robin") else None,
            aux_value=0.2 if kind == "robin" else None,
        )
    return mask, edges, bcs


MIXED_FACES = ("dirichlet", "neumann", "robin", "reflective")


def sep_factors(geometry, nb, dtype, dt=0.1, seed=2):
    """K1's factors for a film at NB bins (per-bin D(E) for NB > 1) and a random state."""
    from qpsim_tpu_torch.ops.adi_sep import SepFactors
    from qpsim_tpu_torch.ops.diffusion import build_directional_stencils, fold_diffusion
    from qpsim_tpu_torch.ops.dos import diffusion_coefficient_of_energy
    from qpsim_tpu_torch.ops.energy_grid import build_energy_grid

    mask, edges, bcs = geometry
    D = 6.0 if nb == 1 else diffusion_coefficient_of_energy(6.0, build_energy_grid(180.0, 1.0, 4.0, nb)[0], 180.0)
    op = fold_diffusion(*build_directional_stencils(mask, edges, bcs, 1.0), mask, 1.0, D)
    f = SepFactors.build(op, dt, "cuda", dtype)
    u = np.random.default_rng(seed).uniform(0.0, 1e-5, (nb, *mask.shape))
    return f, torch.as_tensor(u, dtype=dtype, device="cuda")


def reset_counts():
    for table in launch_tables():
        for k in table:
            table[k] = 0


def read_counts() -> dict:
    return {k: v for table in launch_tables() for k, v in table.items()}


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
        m = re.search(
            r"Compiling entry function '.*?(adi_sep_kernel|adi_kernel|adi_lines_kernel"
            r"|thomas_kernel)I([fd])(?:Lb([01])E)?E",
            line)
        o = re.search(r"Compiling entry function '.*?(column_walk_kernel)I([fd])Li(\d)ELi(\d)ENS_\d+"
                      r"(TableConsts|AnalyticConsts)I[fd]E(?:ELb([01])E)?", line)
        c = re.search(r"Compiling entry function '.*?(collision_step_kernel)I([fd])Lb([01])ENS_\d+"
                      r"(TableConsts|AnalyticConsts)I[fd](?:Lb([01])E)?E", line)
        if c:
            form = "simple" if c.group(3) == "1" else "general"
            ids = {"0": ", uniform gap", "1": ", gap ids", None: ""}[c.group(5)]
            name = f"{c.group(1)}<{'float' if c.group(2) == 'f' else 'double'}, {form}, {c.group(4)}{ids}>"
        elif m:
            flag = m.group(3)
            if flag is None:
                form = ""
            elif m.group(1).startswith("adi"):
                form = f", {'x' if flag == '1' else 'y'} half"
            else:
                form = f", {'rows' if flag == '1' else 'cols'}"
            name = f"{m.group(1)}<{'float' if m.group(2) == 'f' else 'double'}{form}>"
        elif o:
            form = {"1": ", device-memory", "0": ", staged", None: ""}[o.group(6)]
            name = (f"{o.group(1)}<{'float' if o.group(2) == 'f' else 'double'}, P={o.group(3)}, "
                    f"B={o.group(4)}, {o.group(5)}{form}>")
        elif "Compiling entry function" in line:
            name = None
        elif name and ("stack frame" in line or "Used" in line):
            print(f"  ptxas {name}: {line.split(':', 1)[-1].strip()}")
    # the staged ADI kernels' launch plans at the main paths' shapes (and
    # the long-row form phase 3 checks): lines per block, chunks of a line
    # held at once (fewer than K: two passes), dynamic shared bytes per block
    from qpsim_tpu_torch.ops import adi_cuda, adi_sep_cuda, tridiag_cuda
    from qpsim_tpu_torch.ops.adi_sep import pick_chunks

    for dtype in (F32, F64):
        for nb, ny, nx in ((1, 1024, 1024), (16, 1024, 1024), (1, 16, 65536)):
            plans = [f"{h} {adi_sep_cuda.kernel_plan(h, dtype, nb, ny, nx, pick_chunks(nx if h == 'x' else ny))}"
                     for h in "xy"]
            print(f"  adi_sep_kernel {str(dtype)[6:]} {nb}×{ny}×{nx}: {'; '.join(plans)}")
        for nb, ny, nx in ((16, 1024, 1024), (100, 1024, 1024), (2, 24, 16384), (2, 8, 16385),
                           (2, 16385, 8)):
            plans = [f"{h} {adi_cuda.kernel_plan(h, dtype, nb, ny, nx)}" for h in "xy"]
            print(f"  adi_kernel {str(dtype)[6:]} {nb}×{ny}×{nx}: {'; '.join(plans)}")
        # K10 (lead × lines of n): the adi backend's halves at 1024² × 16, one
        # film, 100 bins, and lines of 16385 (two passes where one line's
        # chunks do not fit)
        for lead, lines, n in ((16, 1024, 1024), (1, 1024, 1024), (100, 1024, 1024), (1, 64, 16385)):
            plans = [f"{form} {tridiag_cuda.kernel_plan(form, dtype, n, lines, lead)}"
                     for form in ("rows", "cols")]
            print(f"  thomas_kernel {str(dtype)[6:]} {lead}×{lines} lines of {n}: {'; '.join(plans)}")
    # the column walk's pixels per lane and bins per register block at
    # 1024² and its dynamic shared memory per block (q and partner of the
    # tile), at K5/K6's columns
    from qpsim_tpu_torch.ops.column_walk import blocks_per_sm, column_bins, column_pixels

    for ne in (65, 72, 100, 256):
        n_scat, n_rec = column_counts(ne)
        forms = []
        for dtype, size in ((F32, 4), (F64, 8)):
            pixels = column_pixels(dtype, ne, 1024 * 1024)
            smem = 2 * ne * 32 * pixels * size
            forms.append(f"{str(dtype)[6:]} P={pixels} B={column_bins(dtype, ne, pixels, 'staged')} "
                         f"{smem} B ({blocks_per_sm(smem)} block(s) of 8 warps per SM by shared memory)")
        print(f"  column_walk_kernel at NE={ne} ({n_scat} + {n_rec} columns): {'; '.join(forms)}")
    sys.stdout.flush()


def phase_kernels_vs_plain() -> None:
    print("== 3 kernels against their plain versions on the card", flush=True)
    from qpsim_tpu_torch.ops import adi_cuda

    timed_phase(check_pair_walk)
    timed_phase(check_blocked)
    # K2: the main rectangle, the masked donut (zero coupling rows), each with
    # one plane and NB planes; ragged tiles in both halves on 250 × 255 (K = 1
    # along x, 2 along y) and 250 × 301 (K = 1 asked along x, 32 launched,
    # the last chunk padded); 24 × 16384, long enough rows for the x half's
    # two-pass form in both dtypes; lines of 16385 = 5·29·113 cells, whose
    # 32 padded chunks take two passes (x half; y half in float64)
    for name, geometry, nb, pixel_forms in (
        ("rectangle 1024²", rectangle(1024), 16, (False,)),  # NB planes at 1024²: phase 4b
        ("donut 256²", donut(256), 16, (False, True)),
        ("film 250×255", film(250, 255, MIXED_FACES), 16, (False,)),
        ("film 250×301", film(250, 301, MIXED_FACES), 16, (False, True)),
        ("film 24×16384", film(24, 16384, MIXED_FACES), 2, (False,)),
        ("film 8×16385", film(8, 16385, MIXED_FACES), 2, (False,)),
        ("film 16385×8", film(16385, 8, MIXED_FACES), 2, (False,)),
    ):
        for per_pixel in pixel_forms:
            for dtype in (F64, F32):
                planes, u = adi_planes(geometry, dtype, nb=nb, per_pixel=per_pixel)
                alpha = 0.025
                ux_ref = adi_cuda.adi_x_half_plain(u, planes, alpha)
                ux = adi_cuda.adi_x_half(u, planes, alpha)
                uy_ref = adi_cuda.adi_y_half_plain(ux_ref, planes, alpha)
                uy = adi_cuda.adi_y_half(ux_ref, planes, alpha)
                step = adi_cuda.adi_step(u, planes, alpha)
                torch.cuda.synchronize()
                tol = TOL[("adi", dtype)]
                px = adi_cuda.kernel_plan("x", dtype, *u.shape)
                py = adi_cuda.kernel_plan("y", dtype, *u.shape)
                tag = (f"{name}×{nb} nbp={planes.ax_lo.shape[0]} {str(dtype)[6:]} "
                       f"(x: K={px['k']}, TL={px['tl']}, waves={px['waves']}; "
                       f"y: K={py['k']}, TL={py['tl']}, waves={py['waves']})")
                check(f"adi_x_half {tag}", scaled_err(ux, ux_ref), tol)
                check(f"adi_y_half {tag}", scaled_err(uy, uy_ref), tol)
                check(f"adi_step   {tag}", scaled_err(step, uy_ref), tol)
    from qpsim_tpu_torch.ops import adi_sep_cuda as k1

    # mixed faces, so the split source sx(x) + sy(y) is non-zero; 512×1024
    # shows a swapped x/y; 1030×1020×16 ragged tiles in both halves with
    # K = 2 (M = 515) along y and 4 along x; 16×65536 rows long enough for
    # the x half's two-pass form in both dtypes
    for (ny, nx), nb in (((1024, 1024), 1), ((1024, 1024), 16), ((512, 1024), 1),
                         ((1030, 1020), 16), ((16, 65536), 1)):
        for dtype in (F64, F32):
            f, u = sep_factors(film(ny, nx, MIXED_FACES), nb, dtype)
            ux_ref = k1.adi_sep_x_half_plain(u, f)
            ux = k1.adi_sep_x(u, f)
            uy_ref = k1.adi_sep_y_half_plain(ux_ref, f)
            uy = k1.adi_sep_y(ux_ref, f)
            step = k1.adi_sep_step(u, f)
            torch.cuda.synchronize()
            px = k1.kernel_plan("x", dtype, nb, ny, nx, int(f.facx.shape[3]))
            py = k1.kernel_plan("y", dtype, nb, ny, nx, int(f.facy.shape[3]))
            tol = TOL[("adi_sep", dtype)]
            tag = (f"{ny}×{nx}×{nb} {str(dtype)[6:]} (x: K={f.facx.shape[3]}, TL={px['tl']}, "
                   f"waves={px['waves']}; y: K={f.facy.shape[3]}, TL={py['tl']})")
            check(f"adi_sep_x {tag}", scaled_err(ux, ux_ref), tol)
            check(f"adi_sep_y {tag}", scaled_err(uy, uy_ref), tol)
            check(f"adi_sep_step {tag}", scaled_err(step, uy_ref), tol)
    timed_phase(check_thomas)
    timed_phase(check_offset_walks)
    timed_phase(check_adi_lines)
    timed_phase(check_snapshot_reduce)


def check_pair_walk() -> None:
    """K3 and K4: the pair walk's 16 bins (8 and 9 padded, the split ω
    diagonal at 11, the main path's 16 in the simple form, and 16 at E_max
    = 5Δ and 9Δ, where a difference and a sum share ω rows although each
    diagonal is one group: the general form) and
    the column walk K3/K4 launch beyond them (17, 32, 33, 50, 64), on
    ragged last blocks; a uniform gap, G = 3 random gap ids, G = 8 ids
    mixed in every warp, the trap disc's coherent ids, and a random Δ plane
    at γ = 0 and 0.12, with phonons updated and frozen; with and without
    the dt·g plane."""
    from qpsim_tpu_torch.ops.collisions_cuda import pair_walk, walk_bins

    forms = [("uniform", 0.0, True), ("uniform", 0.0, False), ("gid", 0.0, True),
             ("gid", 0.0, False), ("gid8", 0.0, True), ("trap", 0.0, True),
             ("analytic", 0.0, True), ("analytic", 0.12, True), ("analytic", 0.12, False)]
    # every form at the split diagonal (11), the main path's 16 and the
    # column walk's 50; at the other bin counts one of each kernel: the
    # uniform gap with frozen phonons, G = 8 ids mixed in every warp, and
    # the Dynes analytic form
    few = [forms[1], forms[4], forms[7]]
    for ne, n, emax in ((1, (45, 50), 4.0), (2, (45, 50), 4.0),
                        (8, (45, 50), 4.0), (9, (45, 50), 4.0), (11, (45, 50), 4.0), (16, 256, 4.0),
                        (16, (45, 50), 5.0), (16, (45, 50), 9.0), (17, (45, 50), 4.0),
                        (32, (45, 50), 4.0), (33, (45, 50), 4.0), (50, 128, 4.0),
                        (64, (64, 50), 4.0)):
        grid = f"{n}²" if isinstance(n, int) else f"{n[0]}×{n[1]}"
        grid += "" if emax == 4.0 else f" E_max={emax:g}Δ"
        for kind, gamma, phonons in (forms if (ne, emax) in ((11, 4.0), (16, 4.0), (50, 4.0)) else few):
            name = COLLISION_KINDS[{"gid8": "gid", "trap": "gid"}.get(kind, kind)]
            for dtype in (F64, F32):
                kern, plain, plan, _, q, ph, gen = collision_setup(
                    ne, n, dtype, kind=kind, phonons=phonons, gamma=gamma, pixel_chunk=1024,
                    emax=emax)
                if emax != 4.0:  # one group per diagonal, ω rows shared
                    walk = pair_walk(plan, 16)
                    rows = np.concatenate([walk.s_meta[:, 0], walk.r_meta[:, 0]])
                    if (len(walk.s_meta), len(walk.r_meta)) != (15, 31) or len(set(rows)) == len(rows):
                        raise AssertionError(f"NE=16 at E_max={emax}Δ: expected 15 + 31 groups "
                                             f"sharing ω rows, got {len(walk.s_meta)} + "
                                             f"{len(walk.r_meta)}, {len(set(rows))} rows")
                for g in (None, gen):
                    ref = plain(q, ph, 0.025, g)
                    got = kern(q, ph, 0.025, g)
                    torch.cuda.synchronize()
                    err = max(scaled_err(got[0], ref[0]), scaled_err(got[1], ref[1]))
                    extra = {"uniform": "", "gid": " G=3", "gid8": " G=8 mixed", "trap": " trap ids",
                             "analytic": f" gamma={gamma}"}[kind]
                    bins = walk_bins(ne)
                    form = f"{bins} bins in registers" if bins else "column walk"
                    check(f"{name} NE={ne} ({form}) {grid} {str(dtype)[6:]}{extra} "
                          f"gen={g is not None} phonons={phonons}", err, TOL[(name, dtype)])
                del kern, plain, plan, q, ph, gen, ref, got
    torch.cuda.empty_cache()


def check_blocked() -> None:
    """K5, K5 with gap ids, K6 on the column walk: split ω diagonals (65), ω
    rows shared by a difference and a sum (72, on a ragged last tile: 45²
    pixels, an odd count, at one pixel per lane, and 46 × 45, an even one,
    at two), the slice's 100 bins, the 256-bin envelope; with and without
    gen at 100 bins, with gen (the stepping's case) at the others."""
    from qpsim_tpu_torch.ops.column_walk import column_pixels

    for kind, name in BLOCKED_KINDS.items():
        for ne, n in ((65, 128), (72, 45), (72, (46, 45)), (100, 128), (256, 64)):
            n_pix = n * n if isinstance(n, int) else n[0] * n[1]
            grid = f"{n}²" if isinstance(n, int) else f"{n[0]}×{n[1]}"
            for dtype in (F64, F32):
                for phonons in ((True, False) if ne == 72 else (True,)):
                    for gamma in ((0.0, 0.12) if kind == "analytic" else (0.0,)):
                        kern, plain, _, _, q, ph, gen = collision_setup(
                            ne, n, dtype, kind=kind, phonons=phonons, gamma=gamma, blocked=True,
                            pixel_chunk=1024)
                        for g in ((None, gen) if ne == 100 else (gen,)):
                            ref = plain(q, ph, 0.025, g)
                            got = kern(q, ph, 0.025, g)
                            torch.cuda.synchronize()
                            err = max(scaled_err(got[0], ref[0]), scaled_err(got[1], ref[1]))
                            extra = {"uniform": "", "gid": " G=3", "analytic": f" gamma={gamma}"}[kind]
                            pixels = column_pixels(dtype, ne, n_pix, uniform=kind == "uniform")
                            check(f"{name} NE={ne} {grid} P={pixels} "
                                  f"{str(dtype)[6:]}{extra} gen={g is not None} phonons={phonons}",
                                  err, blocked_tol(dtype, ne))


def check_offset_walks() -> None:
    """K8 (uniform, G = 3 gap ids) at NE 16, 72 (ω rows shared by a difference
    and a sum), 100 and 256, and with G =
    9 ids at 16; K9 at 16, 72 and the split 66, where it also meets K3's
    plain version; with and without phonons, each against its plain version
    on collision_setup's state."""
    from qpsim_tpu_torch.ops.collisions_loop_cuda import build_collision_step_loop
    from qpsim_tpu_torch.ops.collisions_loop_cuda import collision_step_loop_plain as walk_plain

    for ne in (65, 66):  # split ω diagonals: the K8 builder declines, as the JAX one does
        E, dE, pm = phonon_map(ne)
        if build_collision_step_loop(E_bins=E, dE=dE, rho=np.ones(ne), K_s0=np.eye(ne), K_r0=None,
                                     pmap=pm, dt=0.025, device="cuda") is not None:
            raise AssertionError(f"the K8 builder must return None at NE={ne}")
        print(f"  collision_step_loop builder at NE={ne}: None (a split ω diagonal) ok")
    for form, cases in (("loop", [(16, 128), (72, 128), (100, 128), (256, 64)]),
                        ("rows", [(16, 128), (72, 128), (66, 128)])):
        for ne, n in cases:
            for kind in ((("uniform", "gid") + (("gid9",) if ne == 16 else ())) if form == "loop"
                         else ("uniform",)):
                for dtype in (F64, F32):
                    _, k3_plain, _, _, q, ph, _ = collision_setup(
                        ne, n, dtype, kind="gid" if kind == "gid9" else kind, blocked=ne > 64,
                        pixel_chunk=1024)
                    for phonons in (True, False):
                        step = walk_step(form, ne, n, kind=kind, phonons=phonons)
                        ref = walk_plain(step, q, ph)
                        got = step(q, ph)
                        torch.cuda.synchronize()
                        err = max(scaled_err(got[0], ref[0]), scaled_err(got[1], ref[1]))
                        tag = (f"{step.counter}{' G=9' if kind == 'gid9' else ''} NE={ne} {n}² "
                               f"{str(dtype)[6:]} phonons={phonons}")
                        check(tag, err, blocked_tol(dtype, ne))
                        if form == "rows" and ne == 66 and phonons:
                            k3 = k3_plain(q, ph, 0.025, None)
                            err = max(scaled_err(got[0], k3[0]), scaled_err(got[1], k3[1]))
                            check(f"{tag} against K3's plain version (split diagonal)", err,
                                  blocked_tol(dtype, ne))
                    del q, ph, ref, got
    torch.cuda.empty_cache()


def check_adi_lines() -> None:
    """K7: Thomas asked for (chunks 1: on 1024 rows the kernel launches 32)
    and the Wang partition (K = 32) on 16 × 1024-row lines, B = 1000 (not a
    multiple of 32), one plane and NB planes; and Thomas asked for on 2 ×
    16385-row lines, B = 8 (32 padded chunks, two passes in float64)."""
    from qpsim_tpu_torch.ops.adi_cuda import solve_lines, solve_lines_plain

    for chunks, (nb, n, batch), nbps in ((1, (16, 1024, 1000), (1, 16)), (32, (16, 1024, 1000), (1, 16)),
                                         (1, (2, 16385, 8), (1,))):
        for nbp in nbps:
            for dtype in (F64, F32):
                system = line_system(nb, n, batch, nbp, dtype)
                ref = solve_lines_plain(*system, alpha=1.0, chunks=chunks)
                got = solve_lines(*system, alpha=1.0, chunks=chunks)
                torch.cuda.synchronize()
                check(f"adi_lines K={chunks} {nb}×{n}×{batch} nbp={nbp} {str(dtype)[6:]}",
                      scaled_err(got, ref), TOL[("adi_lines", dtype)])


def tridiag_case(form, lead, lines, n, dtype, kind="masked", alpha_s=1e3, seed=3):
    """K10's inputs on the card: lead × lines lines of n, in the rows layout
    ((lead, lines, n) contiguous) or the cols layout (the movedim(−2, −1)
    view of (lead, n, lines) tensors).  ``kind`` "dominant": b in [2, 3],
    a and c in [−0.3, −0.1], rhs in [−1, 1]; "masked": the same with zero
    couplings — an interval boundary at the launched K's first chunk
    boundary and mid-line, an isolated identity cell; "cn": Crank–Nicolson
    lines at ``alpha_s`` (b = 1 + 2α·s, a = c = −α·s).  sub[..., 0] and
    sup[..., −1] hold NaN, which the solve must never read."""
    from qpsim_tpu_torch.ops.tridiag_cuda import kernel_plan

    gen = torch.Generator(device="cuda").manual_seed(seed)
    shape = (lead, n, lines) if form == "cols" else (lead, lines, n)
    uniform = lambda lo, hi: lo + (hi - lo) * torch.rand(shape, generator=gen, device="cuda", dtype=dtype)
    if kind == "cn":
        sub, sup = (torch.full(shape, -alpha_s, device="cuda", dtype=dtype) for _ in range(2))
        diag = torch.full(shape, 1.0 + 2.0 * alpha_s, device="cuda", dtype=dtype)
    else:
        sub, diag, sup = uniform(-0.3, -0.1), uniform(2.0, 3.0), uniform(-0.3, -0.1)
    view = (lambda t: t.movedim(-2, -1)) if form == "cols" else (lambda t: t)
    sub, diag, sup, rhs = (view(t) for t in (sub, diag, sup, uniform(-1.0, 1.0)))
    if kind == "masked" and n >= 7:
        m = -(-n // kernel_plan(form, dtype, n, lines, lead)["k"])
        for p in {m, n // 2} if m < n else {n // 2}:  # interval boundaries between p − 1 and p
            sub[..., p] = 0.0
            sup[..., p - 1] = 0.0
        i = 3  # an isolated cell: an identity row
        sub[..., i] = sup[..., i] = sup[..., i - 1] = sub[..., i + 1] = 0.0
        diag[..., i] = 1.0
    sub[..., 0] = float("nan")
    sup[..., -1] = float("nan")
    return sub, diag, sup, rhs


#: K10's phase-3 shapes (lead, lines, n): the adi backend's halves at 1024² ×
#: 16 and 100 K lines at 100 bins; K raised from 1 to 32 on 257 cells (three
#: chunks of identity rows) and on 1023; 8 of 1000; K = 1 on 7 and 2 cells;
#: ragged last blocks (1000, 1001, 999, 333, 250 lines); lines of 16385 (K
#: 32 of 513 rows: two passes in float64, and in float32 in the rows form)
THOMAS_SHAPES = ((16, 1024, 1024), (100, 1024, 1024), (1, 1000, 257), (4, 250, 1000),
                 (2, 333, 1023), (3, 1001, 7), (2, 999, 2), (1, 64, 16385))


def check_thomas() -> None:
    """K10 in both layouts against its plain version (the Thomas sweep), with
    exact launch counts: every shape of THOMAS_SHAPES on masked lines (float64
    ≤ 1e-10, float32 ≤ 5e-6); Crank–Nicolson lines at α·s = 10 (both dtypes)
    and 10³ (float64 ≤ 1e-10; float32 see below); one copy into rows (a
    broadcast diagonal, mixed layouts).

    Float32 at α·s = 10³ (2-norm condition number κ ≈ 4·10³): the plain
    version's own float32 error there is 3–5e-5 against the float64 solve
    of the same inputs, so a chunked solve cannot come within 5e-6 of it.
    There the check reads both against the plain version run in float64 on
    the same inputs and holds the kernel to κ·u (u = 2⁻²⁴, float32's unit
    roundoff), the forward-error bound of a backward-stable solve, which
    the plain version meets too."""
    from qpsim_tpu_torch.ops import tridiag_cuda as k10

    def solve(label, system, dtype, form, relayout=False):
        before = dict(k10.LAUNCHES)
        ref = k10.thomas_plain(*system)
        got = k10.thomas(*system)
        torch.cuda.synchronize()
        expect = {"thomas": 1, "thomas_cols": int(form == "cols" and not relayout),
                  "thomas_relayout": int(relayout)}
        got_counts = {k: k10.LAUNCHES[k] - before[k] for k in expect}
        if got_counts != expect:
            raise AssertionError(f"{label}: launches {got_counts} != {expect}")
        return got, ref

    for lead, lines, n in THOMAS_SHAPES:
        for form in ("rows", "cols"):
            for dtype in (F64, F32):
                tag = f"{form} {lead}×{lines} lines of {n} {str(dtype)[6:]}"
                system = tridiag_case(form, lead, lines, n, dtype)
                got, ref = solve(tag, system, dtype, form)
                plan = k10.kernel_plan(form, dtype, n, lines, lead)
                check(f"thomas masked {tag} (K={plan['k']}, TL={plan['tl']}, waves={plan['waves']})",
                      scaled_err(got, ref), TOL[("thomas", dtype)])
                del system, got, ref
    torch.cuda.empty_cache()
    # (lines of 16385 are held above on masked lines: the plain sweep's host
    # loop of 16385 steps made them a third of this check)
    for lead, lines, n in ((16, 1024, 1024), (1, 1000, 257), (2, 333, 1023)):
        for form in ("rows", "cols"):
            for dtype in (F64, F32):
                for alpha_s in (10.0, 1e3):
                    tag = f"{form} {lead}×{lines} lines of {n} {str(dtype)[6:]}"
                    system = tridiag_case(form, lead, lines, n, dtype, kind="cn", alpha_s=alpha_s)
                    got, ref = solve(tag, system, dtype, form)
                    if dtype == F64 or alpha_s < 1e3:
                        check(f"thomas CN α·s={alpha_s:g} {tag}", scaled_err(got, ref),
                              TOL[("thomas", dtype)])
                        continue
                    exact = k10.thomas_plain(*(t.double() for t in system))
                    e_kernel, e_plain = scaled_err(got, exact), scaled_err(ref, exact)
                    # eigenvalues 1 + 2α·s(1 − cos(jπ/(n + 1))), j = 1 … n
                    eig = lambda j: 1.0 + 2.0 * alpha_s * (1.0 - np.cos(j * np.pi / (n + 1)))
                    limit = eig(n) / eig(1) * 2.0**-24
                    print(f"  thomas CN α·s={alpha_s:g} {tag}: kernel − plain {scaled_err(got, ref):.3e} "
                          f"(not held to 5e-6); against the float64 solve: plain {e_plain:.3e}, kernel "
                          f"{e_kernel:.3e} (κ·u {limit:.2e}) {'ok' if e_kernel <= limit else 'FAIL'}",
                          flush=True)
                    if e_kernel > limit:
                        raise AssertionError(f"thomas CN α·s={alpha_s:g} {tag}: {e_kernel:.3e} > κ·u "
                                             f"{limit:.2e}")
    # one copy into rows: a broadcast diagonal; mixed layouts (rows rhs, cols couplings)
    for dtype in (F64, F32):
        sub, diag, sup, rhs = tridiag_case("rows", 4, 250, 1000, dtype)
        got, ref = solve("broadcast", (sub, diag[0, 0], sup, rhs), dtype, "rows", relayout=True)
        check(f"thomas broadcast diagonal 4×250 lines of 1000 {str(dtype)[6:]}", scaled_err(got, ref),
              TOL[("thomas", dtype)])
        sub, diag, sup, _ = tridiag_case("cols", 4, 250, 1000, dtype)
        got, ref = solve("mixed", (sub, diag, sup, rhs), dtype, "rows", relayout=True)
        check(f"thomas mixed layouts 4×250 lines of 1000 {str(dtype)[6:]}", scaled_err(got, ref),
              TOL[("thomas", dtype)])


def timed_run(kw: dict, steps: int):
    """One call: its result and (steady ms/step, set-up s, whole-call ms).

    Set-up runs from the call to the first stored frame (t = 0); the
    steady state from the first to the last stored frame (host clock),
    which holds every step and the other stored frames.
    """
    import qpsim_tpu_torch

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


def coupled_expect(segments, collision: str) -> dict:
    """Exact launch counts of the coupled merged path through collision kernel ``collision``."""
    steps = sum(s.length for s in segments)
    names = [*COLLISION_KINDS.values(), *BLOCKED_KINDS.values()]
    expect = {n: 0 for n in names} | {f"{n}_with_gen": 0 for n in names}
    expect[collision] = sum(s.length + 1 if s.length > 1 else 2 for s in segments)
    expect[f"{collision}_with_gen"] = steps
    return expect | {"adi_x_half": steps, "adi_y_half": steps, "adi_sep_x": 0, "adi_sep_y": 0,
                     "thomas": 0, "thomas_cols": 0, "thomas_relayout": 0, "thomas_backward": 0,
                     "column_walk_device": 0} | {k: 0 for k in EXPLICIT_COUNTERS}


#: the counters of the explicit entry points (K8, K9, K7), which no path of
#: ``run_2d_crank_nicolson`` launches
EXPLICIT_COUNTERS = ("collision_step_loop", "collision_step_loop_gid", "collision_step_rows",
                     "adi_lines")


def run_coupled_timed(label: str, kw: dict, expect_collision: str, card: str, calls: int = 3,
                      keep: dict | None = None) -> dict:
    """``calls`` timed calls of a coupled configuration with exact launch
    counts and the physics checks; returns the launch counts of the first
    (and puts its stored energy frames and bins into ``keep``)."""
    from qpsim_tpu_torch.solver.stepping import _plan_segments, _split_time

    full, rem, _ = _split_time(kw["total_time"], kw["dt"])
    segments = _plan_segments(full, rem, kw["dt"], kw["store_every"])
    steps = sum(s.length for s in segments)
    expect = coupled_expect(segments, expect_collision)
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    (times, frames, mass, clim, ef, e_bins), first = timed_run(kw, steps)
    counts = read_counts()
    if keep is not None:
        keep.update(energy_frames=ef, E_bins=e_bins, times=times)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    print(f"  {label}: launches {counts} (expected {expect})")
    if counts != expect:
        raise AssertionError(f"{label}: launch counts {counts} != {expect}")
    check_frames(frames, kw["mask"])
    print(f"  {label}: stored times {times}")
    print(f"  {label}: mass {mass}")
    if not (len(times) == len(segments) + 1 and abs(times[-1] - kw["total_time"]) < 1e-9):
        raise AssertionError(f"{label}: unexpected stored times {times}")
    if not all(m > mass[0] for m in mass[1:3]):
        raise AssertionError(f"{label}: mass must rise during the pulse")
    runs = [first] + [timed_run(kw, steps)[1] for _ in range(calls - 1)]
    for i, (st, su, wh) in enumerate(runs):
        print(f"  {label} run {i + 1}: steady state {st:.3f} ms/step (host clock, first to last "
              f"stored frame, {steps} steps); set-up {su:.3f} s (call to first stored frame); "
              f"whole call {wh / steps:.3f} ms/step (CUDA events)")
    med = float(np.median([r[0] for r in runs]))
    which = f"median {med:.3f} ms/step over {len(runs)} runs" if len(runs) > 1 else \
        f"{med:.3f} ms/step, one run (no median)"
    print(f"  {label} end to end: steady state {which} "
          f"(range {min(r[0] for r in runs):.3f}–{max(r[0] for r in runs):.3f}); set-up "
          f"{min(r[1] for r in runs):.3f}–{max(r[1] for r in runs):.3f} s; peak device memory "
          f"{peak_gib:.2f} GiB — {card}", flush=True)
    return counts


def timed_once(fn):
    """One call's result and its ms on the card (CUDA events, no warm-up)."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def collision_row(kind, line, launches, dt, *, ne=16, blocked=False):
    """A kernels-line row for a collision kernel form at a main path's shapes (1024², float32).

    K3/K4 (NE = 16): the plain version timed over 3 calls after a warm-up;
    K5/K6 (``blocked``): its one reference call is timed (seconds at 100 bins).
    ``kind`` "trap" is the gap-id form on the trap disc's coherent ids.
    """
    name = (BLOCKED_KINDS if blocked else COLLISION_KINDS)["gid" if kind == "trap" else kind]
    kern, plain, plan, tensors, q, ph, gen = collision_setup(ne, 1024, F32, kind=kind, blocked=blocked)
    ref, plain_once = timed_once(lambda: plain(q, ph, dt, gen))
    got = kern(q, ph, dt, gen)
    torch.cuda.synchronize()
    tol = blocked_tol(F32, ne) if blocked else TOL[(name, F32)]
    check(f"{name} NE={ne} 1024² float32 gen=True phonons=True, q", scaled_err(got[0], ref[0]), tol)
    check(f"{name} NE={ne} 1024² float32 gen=True phonons=True, ph", scaled_err(got[1], ref[1]), tol)
    n_bytes, flops = collision_work(plan, q, ph, gen, tensors, analytic=kind == "analytic")
    source, pallas = (("offset_walk.cu", "pallas_collisions_blocked.py") if blocked
                      else ("collisions.cu", "pallas_collisions.py"))
    return dict(
        name=name + ("_trap_ids" if kind == "trap" else ""), route="cuda", source=f"qpsim_tpu_torch/csrc/{source}",
        replaces=f"qpsim_tpu/ops/{pallas}:{line}", launches=launches,
        max_abs_err=max(abs_err(got[0], ref[0]), abs_err(got[1], ref[1])),
        ms=time_ms(lambda: kern(q, ph, dt, gen), 5 if blocked else 20),
        plain_ms=plain_once if blocked else time_ms(lambda: plain(q, ph, dt, gen), 3),
        **bound(n_bytes, flops, F32), library_ms=None,
    )


def print_rows(rows, shape: str, card: str, dtype: str = "float32") -> None:
    for r in rows:
        print(f"  {r['name']}: kernel {r['ms']:.4f} ms ({r.get('timing', 'events')}), plain "
              f"{r['plain_ms']:.3f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}), max abs err {r['max_abs_err']:.3e}, "
              f"{r['launches']} launches ({shape}, {dtype}) — {card}")
    sys.stdout.flush()


def phase_main_path(card: str, keep: dict | None = None) -> list[dict]:
    print("== 4 main path: 1024² × 16 bins, 100 steps, float32, merged stepping", flush=True)
    import qpsim_tpu_torch
    from qpsim_tpu_torch.ops import adi_cuda

    dt, total, store_every = 0.05, 5.0, 25
    kw = dict(main_path_kwargs(1024), dt=dt, total_time=total, store_every=store_every)
    t0 = time.perf_counter()
    qpsim_tpu_torch.run_2d_crank_nicolson(**kw)  # warm-up
    torch.cuda.synchronize()
    print(f"  warm-up run {time.perf_counter() - t0:.2f} s", flush=True)
    counts = run_coupled_timed("uniform gap", kw, "collision_step", card, keep=keep)

    # each kernel against its plain version at the main path's shapes, then their times
    rows = [collision_row("uniform", 169, counts["collision_step"], dt)]
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
            ms=graph_ms(lambda: kern(u, planes, alpha), 20), timing="graph",
            plain_ms=time_ms(lambda: plain(u, planes, alpha), 3),
            **bound(*adi_work(u, planes), F32), library_ms=None,
        ))
    print_rows(rows, "1024² × 16, one plane", card)
    return rows


def phase_gap_maps(card: str) -> list[dict]:
    print("== 4b gap maps: 1024² × 16 bins, 100 steps, float32, merged stepping", flush=True)
    from qpsim_tpu_torch.ops import adi_cuda

    dt = 0.05
    counts = {}
    for map_name, collision in (("trap", "collision_step_gid"), ("gradient", "collision_step_analytic")):
        kw = dict(main_path_kwargs(1024), dt=dt, total_time=5.0, store_every=25,
                  gap_expression=GAP_MAPS[map_name])
        # two timed calls each (three on the uniform gap): the script's time
        # budget holds the 100-bin path's checks
        counts[map_name] = run_coupled_timed(f"{map_name} map", kw, collision, card, calls=1)

    rows = [collision_row("gid", 169, counts["trap"]["collision_step_gid"], dt),
            collision_row("trap", 169, counts["trap"]["collision_step_gid"], dt),
            collision_row("analytic", 429, counts["gradient"]["collision_step_analytic"], dt)]
    # K2 on NB = 16 per-pixel planes (a gap map's D(E, x)) at the same shapes;
    # its launches are the trap map's
    planes, u = adi_planes(rectangle(1024), F32, per_pixel=True)
    alpha = 0.5 * dt
    for name, line, kern, plain in (
        ("adi_x_half", 225, adi_cuda.adi_x_half, adi_cuda.adi_x_half_plain),
        ("adi_y_half", 275, adi_cuda.adi_y_half, adi_cuda.adi_y_half_plain),
    ):
        got, ref = kern(u, planes, alpha), plain(u, planes, alpha)
        torch.cuda.synchronize()
        check(f"{name} rectangle 1024²×16 nbp=16 float32", scaled_err(got, ref), TOL[("adi", F32)])
        rows.append(dict(
            name=f"{name}_nb_planes", route="cuda", source="qpsim_tpu_torch/csrc/adi.cu",
            replaces=f"qpsim_tpu/ops/pallas_adi.py:{line}", launches=counts["trap"][name],
            max_abs_err=abs_err(got, ref),
            ms=graph_ms(lambda: kern(u, planes, alpha), 20), timing="graph",
            plain_ms=time_ms(lambda: plain(u, planes, alpha), 3),
            **bound(*adi_work(u, planes), F32), library_ms=None,
        ))
    print_rows(rows, "1024² × 16", card)
    return rows


def phase_blocked_path(card: str) -> list[dict]:
    print("== 4c beyond 64 bins: 100 bins, 20 steps (cut from 40 for phase 13), float32, merged stepping — "
          "uniform gap on 1024², gap maps on 512² (cut from 1024²: their per-pixel D(E, x) fold grows with NE)",
          flush=True)
    dt, steps = 0.05, 20
    # stored only at the start and the end: each stored frame rebuilds 100
    # bins on the host.  No warm-up call: the kernels were built and run in
    # phases 3–4, and a 100-bin call spends ≈ 15 s of host set-up (1024²)
    counts = {"uniform": run_coupled_timed(
        "uniform gap 1024² × 100",
        dict(main_path_kwargs(1024), num_energy_bins=100, dt=dt, total_time=dt * steps,
             store_every=steps),
        "collision_step_blocked", card, calls=1)}
    for map_name, collision in (("trap", "collision_step_blocked_gid"),
                                ("gradient", "collision_step_blocked_analytic")):
        kw_map = dict(main_path_kwargs(512), num_energy_bins=100, dt=dt, total_time=dt * steps,
                      store_every=steps, gap_expression=GAP_MAPS_100[map_name])
        counts[map_name] = run_coupled_timed(f"{map_name} map 512² × 100", kw_map, collision, card,
                                             calls=1)

    # each form at 1024² × 100 against its plain version, then their times
    rows = [collision_row("uniform", 101, counts["uniform"]["collision_step_blocked"], dt,
                          ne=100, blocked=True),
            collision_row("gid", 101, counts["trap"]["collision_step_blocked_gid"], dt,
                          ne=100, blocked=True),
            collision_row("trap", 101, counts["trap"]["collision_step_blocked_gid"], dt,
                          ne=100, blocked=True),
            collision_row("analytic", 972, counts["gradient"]["collision_step_blocked_analytic"], dt,
                          ne=100, blocked=True)]
    print_rows(rows, "1024² × 100, NW 299", card)
    return rows


def phase_explicit_entry_points(card: str) -> list[dict]:
    print("== 4d explicit entry points at full width, float32: K8 (1024² × 100, uniform and gap ids, "
          "and × 256), K9 (1024² × 72 and × 16), K7 (16 × 1024 lines of 1024; the unfused ADI step "
          "on phase 4's rectangle × 16)", flush=True)
    from qpsim_tpu_torch.ops.adi_cuda import (
        AdiPlanes,
        adi_step,
        build_adi_step,
        solve_lines,
        solve_lines_plain,
    )
    from qpsim_tpu_torch.ops.collisions_loop_cuda import collision_step_loop_plain as walk_plain

    dt = 0.05
    alpha = 0.5 * dt
    # the inputs, made before the counted drive: K8 on K5's phase-4c inputs
    # (the same physics and state), K9 on K5's at 72 bins and K3's at 16
    k5 = {kind: collision_setup(100, 1024, F32, kind=kind, blocked=True) for kind in ("uniform", "gid")}
    k8 = {kind: walk_step("loop", 100, 1024, kind=kind, dt=dt) for kind in k5}
    _, _, plan256, _, q256, ph256, _ = collision_setup(256, 1024, F32, blocked=True)
    k8_256 = walk_step("loop", 256, 1024, dt=dt)
    near = {ne: collision_setup(ne, 1024, F32, blocked=ne > 64) for ne in (72, 16)}
    k9 = {ne: walk_step("rows", ne, 1024, dt=dt) for ne in near}
    op = adi_operator(rectangle(1024))
    planes, u = adi_planes(rectangle(1024), F32)
    y_lines = (planes.ay_lo, planes.ay_diag, planes.ay_hi, planes.scale)
    k7_step = build_adi_step(op, dt, F32, device="cuda")

    # the drive: each entry point once, counted
    reset_counts()
    ms_256 = timed_once(lambda: k8_256(q256, ph256))[1]
    for kind, step in k8.items():
        step(k5[kind][4], k5[kind][5])
    for ne, step in k9.items():
        step(near[ne][4], near[ne][5])
    for chunks in (1, None):
        solve_lines(u, *y_lines, alpha=alpha, chunks=chunks)
    k7_step(u)
    torch.cuda.synchronize()
    counts = read_counts()
    check_counts("explicit entry points", counts, {k: 0 for k in counts} | {
        "collision_step_loop": 2, "collision_step_loop_gid": 1, "collision_step_rows": 2,
        "adi_lines": 4})
    b = bound(*collision_work(plan256, q256, ph256, None, k8_256.tables(F32).kernel_tensors()), F32)
    print(f"  collision_step_loop NE=256 (NW 767) at 1024²: kernel {ms_256:.4f} ms (one launch), bound "
          f"{b['bound_ms']:.4f} ms ({b['bound_by']}) — float32, {card}", flush=True)
    del q256, ph256, plan256, k8_256

    rows = []
    walks = [(k8[kind], k5[kind], BLOCKED_KINDS[kind], "pallas_collisions_loop.py:99", 100)
             for kind in k8]
    walks += [(k9[ne], near[ne], (BLOCKED_KINDS if ne > 64 else COLLISION_KINDS)["uniform"],
               "pallas_collisions_rows.py:92", ne) for ne in (72, 16)]
    for step, (beside, _, plan, _, q, ph, _), beside_name, replaces, ne in walks:
        # the plain walk: one timed call at 100 and 72 bins (seconds), three at 16
        ref, plain_ms = timed_once(lambda: walk_plain(step, q, ph))
        if ne == 16:
            plain_ms = time_ms(lambda: walk_plain(step, q, ph), 3)
        got = step(q, ph)
        torch.cuda.synchronize()
        tag = f"{step.counter} NE={ne} 1024² float32"
        check(f"{tag}, q", scaled_err(got[0], ref[0]), blocked_tol(F32, ne))
        check(f"{tag}, ph", scaled_err(got[1], ref[1]), blocked_tol(F32, ne))
        reps = 20 if ne == 16 else 5
        ms = time_ms(lambda: step(q, ph), reps)
        beside_ms = time_ms(lambda: beside(q, ph, dt, None), reps)
        row = dict(
            name=step.counter, route="cuda", source="qpsim_tpu_torch/csrc/offset_walk.cu",
            replaces=f"qpsim_tpu/ops/{replaces}", launches=counts[step.counter],
            max_abs_err=max(abs_err(got[0], ref[0]), abs_err(got[1], ref[1])), ms=ms, plain_ms=plain_ms,
            **bound(*collision_work(plan, q, ph, None, step.tables(F32).kernel_tensors()), F32),
            library_ms=None,
        )
        print(f"  {tag} (NW {plan.num_omega}): kernel {ms:.4f} ms beside {beside_name} {beside_ms:.4f} ms "
              f"on the same inputs (no gen), plain {plain_ms:.3f} ms, bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']}) — {card}", flush=True)
        if ne != 16:  # K9 at 16 bins is printed, the 72-bin launch is its row
            rows.append(row)
        del ref, got
    del k5, k8, near, k9
    torch.cuda.empty_cache()

    # K7: the y lines of the rectangle, the auto chunk count (K = 32) and
    # Thomas asked for (the kernel launches 32 chunks on lines of 1024)
    for chunks in (None, 1):
        ref, got = solve_lines_plain(u, *y_lines, alpha=alpha, chunks=chunks), solve_lines(
            u, *y_lines, alpha=alpha, chunks=chunks)
        torch.cuda.synchronize()
        asked = "K=32" if chunks is None else "K=1 asked (32 launched)"
        tag = f"adi_lines {asked} 16 × 1024 lines of 1024 float32"
        check(tag, scaled_err(got, ref), TOL[("adi_lines", F32)])
        row = dict(
            name="adi_lines", route="cuda", source="qpsim_tpu_torch/csrc/adi_lines.cu",
            replaces="qpsim_tpu/ops/pallas_adi.py:131", launches=counts["adi_lines"],
            max_abs_err=abs_err(got, ref),
            ms=time_ms(lambda: solve_lines(u, *y_lines, alpha=alpha, chunks=chunks), 20),
            plain_ms=time_ms(lambda: solve_lines_plain(u, *y_lines, alpha=alpha, chunks=chunks), 3),
            **bound(nbytes(u, u, *y_lines), 8 * u.numel(), F32), library_ms=None,
        )
        print(f"  {tag}: kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.3f} ms, bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']}) — {card}", flush=True)
        if chunks is None:  # the step's choice is the row; Thomas is printed
            rows.append(row)
    # the unfused step (two K7 launches) beside K2's fused step on the same operator
    got, ref = k7_step(u), adi_step(u, planes, alpha)
    torch.cuda.synchronize()
    check("build_adi_step vs adi_step (K2) 1024²×16 float32", scaled_err(got, ref), TOL[("adi", F32)])
    step_ms = time_ms(lambda: k7_step(u), 20)
    k2_ms = time_ms(lambda: adi_step(u, planes, alpha), 20)
    planes64 = AdiPlanes.from_operator(op, "cuda", F64)
    u64 = u.double()
    check("build_adi_step vs adi_step (K2) 1024²×16 float64",
          scaled_err(build_adi_step(op, dt, F64, device="cuda")(u64), adi_step(u64, planes64, alpha)),
          TOL[("adi", F64)])
    print(f"  build_adi_step (2 adi_lines launches + torch stencils and swaps) {step_ms:.4f} ms/step "
          f"beside adi_step (K2, 2 launches) {k2_ms:.4f} ms/step, rectangle 1024² × 16, float32 — {card}",
          flush=True)
    print_rows(rows, "see above", card)
    return rows


def phase_end_to_end_f64() -> None:
    print("== 5 end to end, float64, 128² × 16 bins, 20 steps: kernels against plain", flush=True)
    import qpsim_tpu_torch

    run = qpsim_tpu_torch.run_2d_crank_nicolson
    kw = dict(main_path_kwargs(128), dt=0.05, total_time=1.0, store_every=5, dtype=F64)
    reset_counts()
    a = run(**kw)
    check_counts("uniform gap", read_counts(), {"collision_step": 24, "adi_x_half": 20})
    assert_runs_close("uniform gap: kernels vs plain", a,
                      run(**kw, collision_backend="plain", diffusion_backend="adi"), 1e-10, 1e-12)
    # gap maps: the plain path of the same form is the CPU run (gap-id tables,
    # or the analytic plain version for the gradient's continuous map)
    for map_name, collision in (("trap", "collision_step_gid"), ("gradient", "collision_step_analytic")):
        kw_map = dict(kw, gap_expression=GAP_MAPS[map_name])
        reset_counts()
        a = run(**kw_map)
        check_counts(f"{map_name} map", read_counts(), {collision: 24, "collision_step": 0, "adi_x_half": 20})
        assert_runs_close(f"{map_name} map: kernels vs plain", a,
                          run(**kw_map, device="cpu", diffusion_backend="adi"), 1e-10, 1e-12)

    print("== 5 end to end, float64, 64² × 100 bins, 10 steps: K5/K6 against plain", flush=True)
    # 'adi' on both sides: 'auto' takes the dense backend on this small
    # film, and K2 is held end to end at 128² above
    kw = dict(main_path_kwargs(64), num_energy_bins=100, dt=0.05, total_time=0.5, store_every=5,
              dtype=F64, diffusion_backend="adi")
    # the plain path of the same form: the per-gap gather version on the card
    # (uniform, trap), the analytic plain version on the CPU (gradient)
    for map_name, collision, plain_kw in (
        ("uniform", "collision_step_blocked", dict(collision_backend="plain")),
        ("trap", "collision_step_blocked_gid", dict(collision_backend="plain")),
        ("gradient", "collision_step_blocked_analytic", dict(device="cpu")),
    ):
        kw_map = dict(kw, gap_expression=GAP_MAPS_100[map_name]) if map_name != "uniform" else kw
        reset_counts()
        t0 = time.perf_counter()
        a = run(**kw_map)
        check_counts(f"{map_name}, 100 bins, {time.perf_counter() - t0:.2f} s", read_counts(),
                     {collision: 12, "collision_step": 0, "collision_step_gid": 0,
                      "collision_step_analytic": 0, "adi_x_half": 0})
        assert_runs_close(f"{map_name}, 100 bins: kernels vs plain", a, run(**kw_map, **plain_kw),
                          1e-10, 1e-12)


def scalar_kwargs(geometry, *, dt, steps, store_every, seed=0, **extra):
    mask, edges, bcs = geometry
    init = np.zeros(mask.shape)
    init[mask] = np.random.default_rng(seed).uniform(0.0, 1.0, int(mask.sum()))
    return dict(mask=mask, edges=edges, edge_conditions=bcs, initial_field=init,
                diffusion_coefficient=6.0, dt=dt, total_time=dt * steps, dx=1.0,
                store_every=store_every, energy_gap=0.0, **extra)


def check_frames(frames, mask) -> None:
    for f in frames:
        if not (np.all(np.isfinite(f[mask])) and np.all(np.isnan(f[~mask]))):
            raise AssertionError("frames must be finite inside the mask and NaN outside")


def check_counts(label: str, counts: dict, expect: dict) -> None:
    got = {k: counts[k] for k in expect}
    print(f"  {label}: launches {got} (expected {expect})", flush=True)
    if got != expect:
        raise AssertionError(f"{label}: launch counts {got} != {expect}")


def phase_scalar_path(card: str) -> list[dict]:
    print("== 6 scalar path: full 1024² film, energy_gap=0, float32, 10 000 steps", flush=True)
    import qpsim_tpu_torch
    from qpsim_tpu_torch.ops import adi_sep_cuda as k1

    n, dt, steps, store_every = 1024, 0.1, 10_000, 2500
    kw = scalar_kwargs(film(n, n), dt=dt, steps=steps, store_every=store_every)
    t0 = time.perf_counter()
    qpsim_tpu_torch.run_2d_crank_nicolson(**kw)  # warm-up
    torch.cuda.synchronize()
    print(f"  warm-up run {time.perf_counter() - t0:.2f} s", flush=True)

    def timed_run():
        """One call: its result and (steady ms/step, set-up s); see phase 4."""
        stamps: list[float] = []
        t_call = time.perf_counter()
        out = qpsim_tpu_torch.run_2d_crank_nicolson(
            **kw, progress_callback=lambda t, f: stamps.append(time.perf_counter())
        )
        return out, (1e3 * (stamps[-1] - stamps[0]) / steps, stamps[0] - t_call)

    reset_counts()
    (times, frames, mass, _, _, _), first = timed_run()
    check_counts("scalar 1024²", read_counts(), {
        "adi_sep_x": steps, "adi_sep_y": steps, "adi_x_half": 0, "adi_y_half": 0, "thomas": 0})
    sep_launches = {k: read_counts()[k] for k in ("adi_sep_x", "adi_sep_y")}
    check_frames(frames, kw["mask"])
    if not (len(times) == steps // store_every + 1 and abs(times[-1] - dt * steps) < 1e-6):
        raise AssertionError(f"unexpected stored times {times}")
    # reflective faces: mass moves only by float32 roundoff, at most one
    # unit of float32 rounding per step
    drift = max(abs(m - mass[0]) for m in mass) / mass[0]
    drift_bound = steps * float(np.finfo(np.float32).eps)
    print(f"  stored times {times}; mass {mass}; max relative mass drift {drift:.3e} "
          f"(bound {drift_bound:.1e})", flush=True)
    if drift > drift_bound:
        raise AssertionError(f"mass drift {drift:.3e} > {drift_bound:.1e}")
    runs = [first] + [timed_run()[1] for _ in range(2)]
    cells = n * n
    for i, (st, su) in enumerate(runs):
        print(f"  run {i + 1}: steady state {st * 1e3:.2f} µs/step = {cells / (st * 1e-3):.4e} "
              f"cell-steps/s; set-up {su:.3f} s")
    med = sorted(r[0] for r in runs)[1]
    lo, hi = min(r[0] for r in runs), max(r[0] for r in runs)
    print(f"  end to end: steady state median {med * 1e3:.2f} µs/step over {len(runs)} runs "
          f"(range {lo * 1e3:.2f}–{hi * 1e3:.2f}) = {cells / (med * 1e-3):.4e} cell-steps/s "
          f"(range {cells / (hi * 1e-3):.4e}–{cells / (lo * 1e-3):.4e}) — {card}", flush=True)

    # K1 at the path's shapes (NB = 1, reflective), and at NB = 16
    rows = []
    f, u = sep_factors(film(n, n), 1, F32, dt=dt)
    ux_ref = k1.adi_sep_x_half_plain(u, f)
    ux = k1.adi_sep_x(u, f)
    uy_ref = k1.adi_sep_y_half_plain(ux_ref, f)
    uy = k1.adi_sep_y(ux_ref, f)
    torch.cuda.synchronize()
    check("adi_sep_x 1024²×1 float32", scaled_err(ux, ux_ref), TOL[("adi_sep", F32)])
    check("adi_sep_y 1024²×1 float32", scaled_err(uy, uy_ref), TOL[("adi_sep", F32)])
    f16, u16 = sep_factors(film(n, n), 16, F32, dt=dt)
    for name, line, err, kern, plain in (
        ("adi_sep_x", 237, abs_err(ux, ux_ref), k1.adi_sep_x, k1.adi_sep_x_half_plain),
        ("adi_sep_y", 280, abs_err(uy, uy_ref), k1.adi_sep_y, k1.adi_sep_y_half_plain),
    ):
        rows.append(dict(
            name=name, route="cuda", source="qpsim_tpu_torch/csrc/adi_sep.cu",
            replaces=f"qpsim_tpu/ops/pallas_adi_sep.py:{line}", launches=sep_launches[name],
            max_abs_err=err, ms=graph_ms(lambda: kern(u, f), 200), timing="graph",
            plain_ms=time_ms(lambda: plain(u, f), 5),
            **bound(*adi_sep_work(u, f, name[-1]), F32), library_ms=None,
        ))
        print(f"  {name} at 1024²×1 float32: {rows[-1]['ms'] * 1e3:.2f} µs in a CUDA graph, "
              f"{time_ms(lambda: kern(u, f), 200) * 1e3:.2f} µs launched one by one from the host")
        print(f"  {name} at 1024²×16 float32: kernel {graph_ms(lambda: kern(u16, f16), 50):.4f} ms, "
              f"plain {time_ms(lambda: plain(u16, f16), 3):.3f} ms — {card}")
    print_rows(rows, "1024²×1", card)
    return rows


def assert_runs_close(label: str, a, b, rtol_frames: float, rtol_mass: float) -> None:
    if a[0] != b[0]:
        raise AssertionError(f"{label}: stored times differ")
    np.testing.assert_allclose(a[2], b[2], rtol=rtol_mass, atol=0)
    for fa, fb in zip(a[1], b[1]):
        np.testing.assert_array_equal(np.isnan(fa), np.isnan(fb))
        np.testing.assert_allclose(np.nan_to_num(fa), np.nan_to_num(fb), rtol=rtol_frames, atol=0)
    frame_err = max(
        float(np.nanmax(np.abs(fa - fb)) / np.nanmax(np.abs(fb))) for fa, fb in zip(a[1], b[1])
    )
    mass_err = float(np.max(np.abs(np.subtract(a[2], b[2])) / np.abs(b[2])))
    print(f"  {label}: frames max rel err {frame_err:.3e} (rtol {rtol_frames:.0e}), mass max rel "
          f"err {mass_err:.3e} (rtol {rtol_mass:.0e}) ok", flush=True)


def phase_other_diffusion_paths(card: str) -> list[dict]:
    print("== 7 other diffusion paths on the card", flush=True)
    import qpsim_tpu_torch
    from qpsim_tpu_torch.ops import tridiag_cuda as k10
    from qpsim_tpu_torch.ops.tridiag import get_default_solver, set_default_solver

    run = qpsim_tpu_torch.run_2d_crank_nicolson
    # (a) the masked donut: not separable, so K2 at NB = 1
    mask, edges, _ = donut(512)
    from qpsim_tpu_torch.models.params import BoundaryCondition

    kinds = ("absorbing", "reflective")
    bcs = {e.edge_id: BoundaryCondition(kind=kinds[i % 2]) for i, e in enumerate(edges)}
    steps = 2000
    kw = scalar_kwargs((mask, edges, bcs), dt=0.1, steps=steps, store_every=500)
    reset_counts()
    t0 = time.perf_counter()
    times, frames, mass, _, _, _ = run(**kw)
    check_counts(f"(a) donut 512² scalar, {steps} steps, {time.perf_counter() - t0:.2f} s",
                 read_counts(), {"adi_x_half": steps, "adi_y_half": steps, "adi_sep_x": 0, "adi_sep_y": 0})
    check_frames(frames, mask)
    if not all(b < a for a, b in zip(mass, mass[1:])):
        raise AssertionError("absorbing faces must drain mass")

    # (b) diffusion-only energy-resolved film: standalone multi-bin K1
    mask, edges, bcs = film(1024, 1024)
    init = np.full(mask.shape, 1e-5)
    steps = 100
    reset_counts()
    t0 = time.perf_counter()
    times, frames, mass, _, ef, _ = run(
        mask=mask, edges=edges, edge_conditions=bcs, initial_field=init, diffusion_coefficient=6.0,
        dt=0.05, total_time=0.05 * steps, dx=1.0, store_every=steps, energy_gap=180.0,
        energy_max_factor=4.0, num_energy_bins=16, bath_temperature=0.1,
    )
    check_counts(f"(b) diffusion-only 1024² × 16 bins, {steps} steps, {time.perf_counter() - t0:.2f} s",
                 read_counts(), {"adi_sep_x": steps, "adi_sep_y": steps, "adi_x_half": 0, "adi_y_half": 0,
                                 "collision_step": 0})
    check_frames(frames, mask)
    drift = abs(mass[-1] - mass[0]) / mass[0]
    print(f"  (b) mass {mass} (relative drift {drift:.2e}, reflective faces)", flush=True)
    if drift > steps * float(np.finfo(np.float32).eps):
        raise AssertionError("diffusion-only run must conserve mass to float32 roundoff")

    # (c) float64 end to end, each run against the plain path
    geometry = film(256, 256, MIXED_FACES)
    kw = scalar_kwargs(geometry, dt=0.1, steps=200, store_every=50, dtype=F64)
    reset_counts()
    kernel = run(**kw)
    check_counts("(c) auto on the 256² film", read_counts(), {"adi_sep_x": 200, "adi_sep_y": 200})
    saved = get_default_solver()
    # the plain reference: 'adi' on the plain Thomas sweep, asked for by name
    # ('auto' on the card runs K10, as 'pallas' does)
    try:
        set_default_solver("thomas")
        reset_counts()
        plain_adi = run(**kw, diffusion_backend="adi")
        check_counts("(c) 'adi' on 'thomas'", read_counts(), {"thomas": 0})
    finally:
        set_default_solver(saved)
    reset_counts()
    auto_adi = run(**kw, diffusion_backend="adi")
    check_counts("(c) 'adi' on 'auto'", read_counts(), {"thomas": 400})
    assert_runs_close("(c) K1 path vs 'adi'", kernel, plain_adi, 1e-10, 1e-12)
    assert_runs_close("(c) 'adi' on 'auto' (K10) vs 'adi' on 'thomas'", auto_adi, plain_adi, 1e-10, 1e-12)
    try:
        set_default_solver("pallas")
        reset_counts()
        pallas = run(**kw, diffusion_backend="adi")
        counts = {k: read_counts()[k] for k in k10.LAUNCHES}
        print(f"  (c) set_default_solver('pallas') with 'adi': launches {counts}")
        if counts["thomas"] == 0:
            raise AssertionError("set_default_solver('pallas') did not launch the Thomas kernel")
    finally:
        set_default_solver(saved)
    assert_runs_close("(c) 'adi' on K10 vs 'adi'", pallas, plain_adi, 1e-10, 1e-12)
    assert_runs_close("(c) 'wang' vs 'adi'", run(**kw, diffusion_backend="wang"), plain_adi, 1e-10, 1e-12)
    # a film the dense backend takes (≤ 4096 cells; its host eigh is O(P³))
    kw48 = scalar_kwargs(film(48, 48, MIXED_FACES), dt=0.1, steps=200, store_every=50, dtype=F64)
    assert_runs_close("(c) 'cg' vs 'dense' on a 48² film", run(**kw48, diffusion_backend="cg"),
                      run(**kw48, diffusion_backend="dense"), 1e-9, 1e-9)

    # (d) the diffusion-only film of (b) with a random initial field on the
    # 'adi' backend under set_default_solver("pallas"): K10 in rows (x half)
    # and cols (y half), no copy; held to the auto run (K1) on the same film
    steps = 20
    mask, edges, bcs = film(1024, 1024)
    kw = dict(
        mask=mask, edges=edges, edge_conditions=bcs,
        initial_field=np.random.default_rng(5).uniform(0.5e-5, 1.5e-5, mask.shape),
        diffusion_coefficient=6.0, dt=0.05, total_time=0.05 * steps, dx=1.0, store_every=steps,
        energy_gap=180.0, energy_max_factor=4.0, num_energy_bins=16, bath_temperature=0.1,
    )
    reset_counts()
    auto = run(**kw)
    check_counts("(d) auto (K1)", read_counts(), {"adi_sep_x": steps, "adi_sep_y": steps, "thomas": 0})
    try:
        set_default_solver("pallas")
        reset_counts()
        pallas, d_times = timed_run(kw | {"diffusion_backend": "adi"}, steps)
        d_counts = read_counts()
        check_counts(f"(d) 'adi' + 'pallas' on the 1024² × 16 film, {steps} steps", d_counts,
                     {"thomas": 2 * steps, "thomas_cols": steps, "thomas_relayout": 0, "adi_sep_x": 0,
                      "adi_x_half": 0})
        d_runs = [d_times] + [timed_run(kw | {"diffusion_backend": "adi"}, steps)[1]]
    finally:
        set_default_solver(saved)
    check_frames(pallas[1], mask)
    # float32, the same Peaceman–Rachford step in another elimination order:
    # roundoff of ≈ 1e-7 a solve over 40 solves
    assert_runs_close("(d) 'adi' on K10 vs auto (K1), float32", pallas, auto, 1e-5, 1e-5)
    for i, (st, su, wh) in enumerate(d_runs):
        print(f"  (d) run {i + 1}: steady state {st:.3f} ms/step (host clock); set-up {su:.3f} s; "
              f"whole call {wh / steps:.3f} ms/step (CUDA events) — {card}", flush=True)

    # K10 against its plain version at the adi backend's shapes at 1024² × 16:
    # 16 K lines of 1024 in rows (x half) and cols (y half); and one film's 1024
    rows, d_rows = [], d_counts["thomas"] - d_counts["thomas_cols"]
    for form, lead, lines, key in (("rows", 1, 16 * 1024, "thomas"), ("rows", 1, 1024, "thomas_1024_lines"),
                                   ("cols", 16, 1024, "thomas_cols")):
        system = tridiag_case(form, lead, lines, 1024, F32, kind="dominant")
        ref = k10.thomas_plain(*system)
        got = k10.thomas(*system)
        torch.cuda.synchronize()
        check(f"{key}: {form} {lead}×{lines} lines of 1024 float32", scaled_err(got, ref),
              TOL[("thomas", F32)])
        rows.append(dict(
            name=key, route="cuda", source="qpsim_tpu_torch/csrc/tridiag.cu",
            replaces="qpsim_tpu/ops/pallas_tridiag.py:35",
            launches=d_counts["thomas_cols"] if form == "cols" else d_rows,
            max_abs_err=abs_err(got, ref), ms=time_ms(lambda: k10.thomas(*system), 20),
            plain_ms=time_ms(lambda: k10.thomas_plain(*system), 3),
            **bound(*thomas_work(system), F32), library_ms=None,
        ))
        del system, ref, got
    print_rows(rows, "lines of 1024 (16 K rows, 1024 rows, 16 × 1024 cols)", card)
    return rows


# ---------------------------------------------------------------- phase 8: the GDS film


#: the photon drive of phase 8: a pair-breaking tone at 2.6Δ (n̄ = 2, c = 2e-5
#: /ns) in the window [1.0, 3.5) ns, and the two-tone variant's scattering
#: tone at ω = 4·dE (dE = 33.75 µeV at 16 bins to 4Δ)
PHOTON_PAIR = dict(photon_energy=2.6 * 180.0, occupancy=2.0, coupling=2e-5,
                   window_start=1.0, window_duration=2.5)
PHOTON_SCATTER = dict(photon_energy=4 * 33.75, occupancy=0.5, coupling=2e-5,
                      include_pair_breaking=False)
#: the traced custom generation: a gaussian hot spot on the pad, on in
#: [0.5, 2.0) ns, exponential in E
GEN_TRACED = ("params.get('g0', 1e-6) * np.exp(-((x - 0.2)**2 + (y - 0.5)**2) / 0.01)"
              " * np.where((t >= 0.5) & (t < 2.0), 1.0, 0.0) * np.exp(-(E - 180.0) / 200.0)")
#: the same with a Python conditional on t: the JAX rule leaves it to the host
GEN_HOST = ("params.get('g0', 1e-6) * np.exp(-((x - 0.2)**2 + (y - 0.5)**2) / 0.01)"
            " * np.exp(-(E - 180.0) / 200.0) if 0.5 <= t < 2.0 else 0.0")


def write_mkid_layout(path) -> None:
    """An MKID-like film on layer 1: a 420 × 1022 µm pad, a 60 µm meander
    PATH leaving it in seven rows, and an SREF'd 100 × 80 µm capacitor cell
    at its end; the bounding box is 1022 µm square, so a 1 µm mesh (plus
    the one-cell ring) rasterizes it to 1024²."""
    from qpsim_tpu_torch.geometry.gds import write_gds

    rows = [60.0 + 150.0 * i for i in range(7)]
    line = [(400.0, rows[0])]
    for i, y in enumerate(rows):
        ends = (480.0, 990.0) if i % 2 == 0 else (990.0, 480.0)
        if i:
            line.append((ends[0], y))
        line.append((ends[1], y))
    rect = lambda x0, y0, w, h: np.array([[x0, y0], [x0 + w, y0], [x0 + w, y0 + h], [x0, y0 + h]])
    write_gds(path, {"CAP": [(1, rect(0.0, 0.0, 100.0, 80.0))],
                     "MKID": [(1, rect(0.0, 0.0, 420.0, 1022.0)), (1, np.array(line), 60.0)]})
    # the SREF (the writer emits BOUNDARY and PATH only): CAP at (922, 942)
    import struct
    from qpsim_tpu_torch.geometry.gds import _ascii_record, _record

    data = path.read_bytes()
    endstr = data.rfind(struct.pack(">HBB", 4, 0x07, 0))
    origin = np.rint(np.array([[922.0, 942.0]]) / 1e-3).astype(">i4").tobytes()
    sref = _record(0x0A, 0) + _ascii_record(0x12, "CAP") + _record(0x10, 3, origin) + _record(0x11, 0)
    path.write_bytes(data[:endstr] + sref + data[endstr:])


def gds_film(mesh: float):
    """(mask, edges, reflective BCs, seconds) of the MKID layout at ``mesh`` µm."""
    import tempfile
    from pathlib import Path

    from qpsim_tpu_torch.geometry.gds import create_geometry_from_gds
    from qpsim_tpu_torch.models.params import BoundaryCondition

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "mkid.gds"
        write_mkid_layout(path)
        geo = create_geometry_from_gds(path, layer=1, mesh_size=mesh)
    mask = np.asarray(geo.mask, dtype=bool)
    bcs = {e.edge_id: BoundaryCondition(kind="reflective") for e in geo.edges}
    return mask, geo.edges, bcs, time.perf_counter() - t0


def film_ic(mask):
    """The phase's initial condition: a gaussian QP profile (peak 1e-5) with
    Fermi–Dirac weights at the bath, uniform Bose–Einstein phonons; returns
    (spec, initial_field, energy_weights, seconds)."""
    from qpsim_tpu_torch.fields import build_initial_energy_weights, build_initial_field
    from qpsim_tpu_torch.models.params import InitialConditionSpec
    from qpsim_tpu_torch.ops.energy_grid import build_energy_grid

    t0 = time.perf_counter()
    spec = InitialConditionSpec(
        spatial_kind="gaussian", spatial_params={"amplitude": 1e-5, "x0": 0.2, "y0": 0.5, "sigma": 0.15},
        energy_kind="fermi_dirac", phonon_spatial_kind="uniform", phonon_energy_kind="bose_einstein")
    E, _ = build_energy_grid(180.0, 1.0, 4.0, 16)
    init = build_initial_field(mask, spec)
    weights = build_initial_energy_weights(E, 180.0, 0.0, spec, 0.1)
    return spec, init, weights, time.perf_counter() - t0


def film_kwargs(geometry, *, photons=True, gen="traced", two_tone=False, steps=100, store_every=25,
                dtype=F32):
    """``run_2d_crank_nicolson`` keywords of phase 8 on a film."""
    from qpsim_tpu_torch.models.params import ExternalGenerationSpec, PhotonDriveSpec

    mask, edges, bcs = geometry[:3]
    spec, init, weights, _ = film_ic(mask)
    kw = dict(mask=mask, edges=edges, edge_conditions=bcs, initial_field=init, energy_weights=weights,
              initial_condition_spec=spec, diffusion_coefficient=6.0, dt=0.05, total_time=0.05 * steps,
              dx=1.0, store_every=store_every, energy_gap=180.0, energy_max_factor=4.0,
              num_energy_bins=16, enable_recombination=True, enable_scattering=True,
              bath_temperature=0.1, dtype=dtype)
    if gen:
        kw["external_generation"] = ExternalGenerationSpec(
            mode="custom", custom_body=GEN_TRACED if gen == "traced" else GEN_HOST,
            custom_params={"g0": 1e-6})
    if photons:
        drive = [PhotonDriveSpec(mode="photon", **PHOTON_PAIR)]
        if two_tone:
            drive.append(PhotonDriveSpec(mode="photon", **PHOTON_SCATTER))
        kw["photon_drive"] = drive
    return kw


def film_expect(collision: str, steps: int, segments: int, merged: bool = True, k2: bool = True) -> dict:
    """Launch counts of a 16-bin coupled run with no generation plane in the
    collision calls, diffusing through K2 (or, ``k2`` False, the dense backend)."""
    calls = steps + segments if merged else 2 * steps
    forms = {f"{n}{g}": 0 for n in COLLISION_KINDS.values() for g in ("", "_with_gen")}
    halves = steps if k2 else 0
    return forms | {collision: calls, "adi_x_half": halves, "adi_y_half": halves,
                    "adi_sep_x": 0, "adi_sep_y": 0}


def timed_film_calls(label, kw, expect, card, calls=2):
    """``calls`` timed calls; (first result, runs, launch counts of the first call, checked exact)."""
    reset_counts()
    out, first = timed_run(kw, int(round(kw["total_time"] / kw["dt"])))
    counts = read_counts()
    check_counts(label, counts, expect)
    check_frames(out[1], kw["mask"])
    runs = [first] + [timed_run(kw, int(round(kw["total_time"] / kw["dt"])))[1] for _ in range(calls - 1)]
    for i, (st, su, wh) in enumerate(runs):
        print(f"  {label} run {i + 1}: steady state {st:.3f} ms/step (host clock, first to last stored "
              f"frame); set-up {su:.3f} s (call to first stored frame); whole call "
              f"{wh / 100:.3f} ms/step (CUDA events)")
    med = float(np.median([r[0] for r in runs]))
    print(f"  {label} end to end: steady state median {med:.3f} ms/step over {len(runs)} runs (range "
          f"{min(r[0] for r in runs):.3f}–{max(r[0] for r in runs):.3f}) — {card}", flush=True)
    return out, runs, counts


def phase_photon_film(card: str) -> list[dict]:
    print("== 8 the GDS film: an MKID layout rasterized to 1024², 16 bins, initial-condition spec, "
          "custom traced generation and the photon drive, 100 steps, float32, strang 'auto'", flush=True)
    import qpsim_tpu_torch
    from qpsim_tpu_torch.geometry.gds import native_raster_available
    from qpsim_tpu_torch.ops import photon_drive as pd
    from qpsim_tpu_torch.ops.generation import build_generation_program
    from qpsim_tpu_torch.models.params import ExternalGenerationSpec
    from qpsim_tpu_torch.solver import spectral_runner

    mask, edges, bcs, raster_s = gds_film(1.0)
    fill = float(mask.mean())
    print(f"  GDS film: {mask.shape[0]}×{mask.shape[1]}, {100 * fill:.1f} % inside, one component; "
          f"rasterizer: {'native C++ (native/gds_raster.cpp)' if native_raster_available() else 'numpy'}; "
          f"write + rasterize {raster_s:.3f} s", flush=True)
    if mask.shape != (1024, 1024) or fill < 0.4:
        raise AssertionError(f"GDS film {mask.shape}, {fill:.3f} inside: expected 1024² and ≥ 40 %")
    geometry = (mask, edges, bcs)
    ic_s = film_ic(mask)[3]

    # the program build's share of the set-up, timed around the builder
    build_s: list[float] = []
    builder = spectral_runner.build_engine_program

    def timed_builder(**kw):
        t0 = time.perf_counter()
        out = builder(**kw)
        torch.cuda.synchronize()
        build_s.append(time.perf_counter() - t0)
        return out

    spectral_runner.build_engine_program = timed_builder
    try:
        kw = film_kwargs(geometry)
        qpsim_tpu_torch.run_2d_crank_nicolson(**kw)  # warm-up
        torch.cuda.synchronize()
        out, runs, counts = timed_film_calls("GDS film, photons + traced generation", kw,
                                             film_expect("collision_step", 100, 4), card)
        print(f"  set-up split: GDS write + rasterize {raster_s:.3f} s, IC build {ic_s:.3f} s, program "
              f"build {min(build_s):.3f}–{max(build_s):.3f} s, call to first frame "
              f"{min(r[1] for r in runs):.3f}–{max(r[1] for r in runs):.3f} s — {card}", flush=True)
        mass = out[2]
        print(f"  GDS film: mass {mass}", flush=True)
        if not (mass[1] > mass[0] and mass[2] > mass[1]):
            raise AssertionError("the hot spot and the pair-breaking window must raise the mass")
        # the same film, no photons and no custom generation
        plain_kw = film_kwargs(geometry, photons=False, gen=None)
        timed_film_calls("GDS film, no photons, no generation", plain_kw,
                         film_expect("collision_step", 100, 4), card)
        # two tones, and the two gap maps, one call each
        reset_counts()
        qpsim_tpu_torch.run_2d_crank_nicolson(**film_kwargs(geometry, two_tone=True))
        check_counts("GDS film, two tones", read_counts(), film_expect("collision_step", 100, 4))
        map_counts = {}
        for map_name, collision in (("trap", "collision_step_gid"), ("gradient", "collision_step_analytic")):
            reset_counts()
            t0 = time.perf_counter()
            res = qpsim_tpu_torch.run_2d_crank_nicolson(
                **film_kwargs(geometry), gap_expression=GAP_MAPS[map_name])
            check_counts(f"GDS film, {map_name} map, photons per pixel, {time.perf_counter() - t0:.2f} s",
                         read_counts(), film_expect(collision, 100, 4))
            check_frames(res[1], mask)
            map_counts[map_name] = read_counts()
    finally:
        spectral_runner.build_engine_program = builder

    # the photon substep and the traced generation alone, by CUDA events
    from qpsim_tpu_torch.ops.dos import dynes_density_of_states
    from qpsim_tpu_torch.ops.energy_grid import build_energy_grid

    E, dE = build_energy_grid(180.0, 1.0, 4.0, 16)
    rho = dynes_density_of_states(E, 180.0, 0.0)
    mask_t = torch.as_tensor(mask, dtype=F32, device="cuda")
    q = torch.as_tensor(rho, dtype=F32, device="cuda")[:, None, None] * 1e-3 * mask_t
    plan = pd.build_photon_drive_plan(E_bins=E, dE=dE, gap=180.0, rho=rho, omega=PHOTON_PAIR["photon_energy"],
                                      coupling=2e-5, occupancy=2.0)
    sub = pd.make_photon_substep(plan, 0.05, F32, "cuda")
    aplan = pd.build_photon_drive_plan_analytic(E_bins=E, dE=dE, omega=PHOTON_PAIR["photon_energy"],
                                                coupling=2e-5, occupancy=2.0)
    sub_pp = pd.make_photon_substep_per_pixel(aplan, 0.05, F32, "cuda")
    d2 = mask_t * 180.0**2
    rho_state = torch.as_tensor(rho, dtype=F32, device="cuda")[:, None, None] * mask_t
    gen = build_generation_program(
        ExternalGenerationSpec(mode="custom", custom_body=GEN_TRACED, custom_params={"g0": 1e-6}),
        E, mask, "cuda", F32)
    t_gen = torch.full((), 1.0, dtype=F32, device="cuda")
    if gen.traced_fn is None:
        raise AssertionError("the phase's generation expression must trace")
    ms_sub = time_ms(lambda: sub(q, 1.0, mask_t), 20)
    ms_pp = time_ms(lambda: sub_pp(q, 1.0, mask_t, d2, rho_state), 20)
    ms_gen = time_ms(lambda: gen.add(q, 0.05, t_gen), 20)
    print(f"  photon substep (plain torch, 1024² × 16, float32, CUDA events): uniform {ms_sub:.4f} ms, "
          f"per pixel {ms_pp:.4f} ms; traced generation add {ms_gen:.4f} ms — {card}", flush=True)

    # K3 with no generation plane, at the film's shapes, against its plain version
    rows = []
    kern, plain, cplan, tensors, qk, phk, _ = collision_setup(16, 1024, F32)
    ref, _ = timed_once(lambda: plain(qk, phk, 0.025, None))
    got = kern(qk, phk, 0.025, None)
    torch.cuda.synchronize()
    check("collision_step NE=16 1024² float32 gen=False phonons=True, q", scaled_err(got[0], ref[0]),
          TOL[("collision_step", F32)])
    check("collision_step NE=16 1024² float32 gen=False phonons=True, ph", scaled_err(got[1], ref[1]),
          TOL[("collision_step", F32)])
    rows.append(dict(
        name="collision_step_no_gen_plane", route="cuda", source="qpsim_tpu_torch/csrc/collisions.cu",
        replaces="qpsim_tpu/ops/pallas_collisions.py:169", launches=counts["collision_step"],
        max_abs_err=max(abs_err(got[0], ref[0]), abs_err(got[1], ref[1])),
        ms=time_ms(lambda: kern(qk, phk, 0.025, None), 20),
        plain_ms=time_ms(lambda: plain(qk, phk, 0.025, None), 3),
        **bound(*collision_work(cplan, qk, phk, None, tensors), F32), library_ms=None))
    del kern, plain, cplan, tensors, qk, phk, ref, got
    # K2 on the film's masked planes (one plane)
    from qpsim_tpu_torch.ops import adi_cuda

    planes, u = adi_planes(geometry, F32)
    alpha = 0.025
    for name, line, kern, plainf in (
        ("adi_x_half", 225, adi_cuda.adi_x_half, adi_cuda.adi_x_half_plain),
        ("adi_y_half", 275, adi_cuda.adi_y_half, adi_cuda.adi_y_half_plain),
    ):
        got, ref = kern(u, planes, alpha), plainf(u, planes, alpha)
        torch.cuda.synchronize()
        check(f"{name} GDS film 1024²×16 float32", scaled_err(got, ref), TOL[("adi", F32)])
        rows.append(dict(
            name=f"{name}_gds_film", route="cuda", source="qpsim_tpu_torch/csrc/adi.cu",
            replaces=f"qpsim_tpu/ops/pallas_adi.py:{line}", launches=counts[name],
            max_abs_err=abs_err(got, ref), ms=graph_ms(lambda: kern(u, planes, alpha), 20), timing="graph",
            plain_ms=time_ms(lambda: plainf(u, planes, alpha), 3),
            **bound(*adi_work(u, planes), F32), library_ms=None))
    print_rows(rows, "the GDS film's shapes, 1024² × 16", card)
    print(f"  maps under photons: trap {map_counts['trap']['collision_step_gid']} K3 gap-id launches, "
          f"gradient {map_counts['gradient']['collision_step_analytic']} K4 launches, none with a plane",
          flush=True)
    return rows


def phase_photon_film_f64() -> None:
    print("== 8b the GDS film at 8.13 µm (128²), float64, 30 steps: IC, traced generation and photons "
          "against the plain path; host-mode generation on 64²", flush=True)
    import qpsim_tpu_torch

    run = qpsim_tpu_torch.run_2d_crank_nicolson
    mask, edges, bcs, _ = gds_film(8.13)
    if mask.shape != (128, 128):
        raise AssertionError(f"the 8.13 µm film is {mask.shape}, expected 128²")
    # 30 steps cross both windows: generation [0.5, 2.0), photons [1.0, 3.5);
    # the kernels' run diffuses through K2 ('auto'), the plain one on 'adi'
    kw = film_kwargs((mask, edges, bcs), steps=30, store_every=10, dtype=F64)
    for map_name, collision, plain_kw in (
        ("uniform", "collision_step", dict(collision_backend="plain", diffusion_backend="adi")),
        ("gradient", "collision_step_analytic", dict(device="cpu", diffusion_backend="adi")),
    ):
        kw_map = dict(kw, gap_expression=GAP_MAPS[map_name]) if map_name != "uniform" else kw
        reset_counts()
        a = run(**kw_map)
        check_counts(f"128² {map_name}", read_counts(), film_expect(collision, 30, 3))
        assert_runs_close(f"128² {map_name}, photons + traced generation: kernels vs plain", a,
                          run(**kw_map, **plain_kw), 1e-10, 1e-12)
    # host-mode generation: 'auto' resolves to exact (two collision calls a
    # step); the 64² film's interior takes the dense backend on both sides
    geometry = rectangle(64)
    kw = film_kwargs(geometry, gen="host", steps=30, store_every=10, dtype=F64)
    reset_counts()
    a = run(**kw)
    check_counts("64² host-mode generation, 'auto' → exact", read_counts(),
                 film_expect("collision_step", 30, 3, merged=False, k2=False))
    # the dense solve of this 64² film mixes the gaussian's far tail (10⁻⁷
    # of its peak) from the whole film, so float64 roundoff of the peak
    # reaches ~1e-10 of a tail cell: frames are held to rtol 1e-10 plus an
    # atol of 1e-10 of each frame's peak
    b = run(**kw, collision_backend="plain")
    if a[0] != b[0]:
        raise AssertionError("64² host-mode generation: stored times differ")
    np.testing.assert_allclose(a[2], b[2], rtol=1e-12, atol=0)
    for fa, fb in zip(a[1], b[1]):
        np.testing.assert_array_equal(np.isnan(fa), np.isnan(fb))
        peak = float(np.nanmax(np.abs(fb)))
        np.testing.assert_allclose(np.nan_to_num(fa), np.nan_to_num(fb), rtol=1e-10, atol=1e-10 * peak)
    print("  64² host-mode generation: kernels vs plain, frames within rtol 1e-10 + 1e-10 of the peak, "
          "mass within 1e-12 ok", flush=True)
    if not a[2][-1] > a[2][0]:
        raise AssertionError("host-mode generation must inject")


def phase_validation(card: str) -> dict:
    print("== 8c run_fast_validation_suite(device='cuda'), float64 and float32", flush=True)
    import qpsim_tpu_torch

    for dtype in (F64, F32):
        reset_counts()
        t0 = time.perf_counter()
        with launches_by_bins() as by_bins:
            report = qpsim_tpu_torch.run_fast_validation_suite(device="cuda", dtype=dtype)
        elapsed = time.perf_counter() - t0
        for name, section in report.sections().items():
            print(f"  {str(dtype)[6:]} {name}: {section}")
        launched = {k: v for k, v in read_counts().items() if v}
        print(f"  {str(dtype)[6:]} suite: overall_passed={report.overall_passed} in {elapsed:.2f} s; "
              f"kernel launches {launched} — {card}", flush=True)
        if not report.overall_passed:
            raise AssertionError(f"validation suite failed in {dtype}")
        if not launched.get("collision_step"):
            raise AssertionError("the suite's collision gates must run through K3")
        print(f"  {str(dtype)[6:]} suite: K3 launches by bins "
              f"{ {ne: n for (_, ne), n in sorted(by_bins.items(), key=lambda kv: kv[0][1])} }", flush=True)
    return by_bins


# ---------------------------------------------------------------- phase 9: the setup runner


class launches_by_bins:
    """Within the block, count K3/K4 launches (the collision step up to 64
    bins) by (counter name, bins), read off the plan each launch receives;
    :data:`LAUNCHES` counts them as always."""

    def __enter__(self):
        from qpsim_tpu_torch.ops import collisions_cuda as kc

        self.kc, self.seen = kc, {}
        self.real = (kc._launch, kc.launch_columns)

        def tally(real):
            def launch(name, plan, *args, **kw):
                out = real(name, plan, *args, **kw)
                key = (name, plan.num_energy_bins)
                self.seen[key] = self.seen.get(key, 0) + 1
                return out
            return launch

        kc._launch, kc.launch_columns = (tally(f) for f in self.real)
        return self.seen

    def __exit__(self, *exc):
        self.kc._launch, self.kc.launch_columns = self.real


class timed_calls:
    """Within the block, the seconds of each call of ``owner.name`` (a class's
    method or a module's function), in call order, with what ``extra(args,
    out)`` returns beside each."""

    def __init__(self, owner, name, extra=None):
        self.owner, self.name, self.extra = owner, name, extra

    def __enter__(self):
        self.real, self.calls = getattr(self.owner, self.name), []

        def wrapper(*args, **kw):
            t0 = time.perf_counter()
            out = self.real(*args, **kw)
            dt = time.perf_counter() - t0
            self.calls.append((dt, None if self.extra is None else self.extra(args, out)))
            return out

        setattr(self.owner, self.name, wrapper)
        return self.calls

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self.real)


class engine_keywords:
    """Within the block, the keywords of the runner's engine call (the last)."""

    def __enter__(self):
        from qpsim_tpu_torch import runner

        self.runner, self.real, self.kw = runner, runner.run_2d_crank_nicolson, {}

        def spy(**kw):
            self.kw.clear()
            self.kw.update(kw)
            return self.real(**kw)

        runner.run_2d_crank_nicolson = spy
        return self.kw

    def __exit__(self, *exc):
        self.runner.run_2d_crank_nicolson = self.real


def flagship_setup(n, *, ne=16, steps=100, store_every=25, name="flagship"):
    """Phase 4's physics as a setup: the n² intrinsic rectangle, Δ = 180 µeV,
    E_max = 4Δ, ``ne`` bins, both channels, T_bath 0.1 K, pulse generation,
    dt 0.05 ns, ``steps`` steps stored every ``store_every``; QPs uniform
    1e-5 with the DOS weights, phonons at the bath."""
    from qpsim_tpu_torch.fields import default_initial_condition
    from qpsim_tpu_torch.geometry.mask import create_intrinsic_geometry
    from qpsim_tpu_torch.models.params import (BoundaryCondition, ExternalGenerationSpec, SetupData,
                                               SimulationParameters)

    geo = create_intrinsic_geometry(width=n, height=n)
    ic = default_initial_condition()
    ic.spatial_kind, ic.spatial_params = "uniform", {"value": 1e-5}
    params = SimulationParameters(
        diffusion_coefficient=6.0, dt=0.05, total_time=0.05 * steps, mesh_size=1.0,
        store_every=store_every, energy_gap=180.0, energy_min_factor=1.0, energy_max_factor=4.0,
        num_energy_bins=ne, enable_recombination=True, enable_scattering=True, bath_temperature=0.1,
        external_generation=ExternalGenerationSpec(mode="pulse", pulse_start=0.5, pulse_duration=1.0,
                                                   pulse_rate=1e-5))
    bcs = {e.edge_id: BoundaryCondition(kind="reflective") for e in geo.edges}
    return SetupData(setup_id=f"{name[:6]:0<6}{n:06d}", name=f"{name} {n}² × {ne}",
                     created_at="2026-01-01T00:00:00+00:00", geometry=geo, boundary_conditions=bcs,
                     parameters=params, initial_condition=ic)


def with_params(setup, **params):
    import dataclasses

    return dataclasses.replace(setup, parameters=dataclasses.replace(setup.parameters, **params))


def plan_of(setup):
    from qpsim_tpu_torch.solver.stepping import _plan_segments, _split_time

    p = setup.parameters
    full, rem, _ = _split_time(p.total_time, p.dt)
    return _plan_segments(full, rem, p.dt, p.store_every)


def steady_ms(stamps, steps) -> float:
    """Host ms per step from the first to the last stored frame."""
    return 1e3 * (stamps[-1] - stamps[0]) / steps


def stamp_into(stamps):
    return lambda t, frame: stamps.append(time.perf_counter())


def step_file_mb(args, out) -> float:
    """The size in MB of the checkpoint file a ``save_step`` call wrote."""
    checkpointer, stored_idx = args[0], args[1]
    return checkpointer._path(stored_idx).stat().st_size / 1e6


def shard_mb(args, out) -> float:
    from qpsim_tpu_torch.io.stream import _shard_path

    return _shard_path(args[0].directory, args[1]).stat().st_size / 1e6


def stored_steps(directory) -> list[int]:
    """The step of each stored index of a checkpoint directory, read without its tensors."""
    from qpsim_tpu_torch.io.checkpoint import SimulationCheckpointer

    ck = SimulationCheckpointer(directory)
    return [int(torch.load(ck._path(i), map_location="cpu", weights_only=True, mmap=True)["step"])
            for i in ck.all_steps()]


def equal_streams(label, a, b) -> None:
    """Two finalized frame streams (readers) hold the same bits: times, mass,
    color limits, frames and the per-bin sums."""
    if (a.times, a.mass_over_time, a.color_limits) != (b.times, b.mass_over_time, b.color_limits):
        raise AssertionError(f"{label}: times, mass or color limits differ")
    for i in range(a.count):
        for acc in ("frame", "energy_bin_sums", "phonon_bin_sums", "phonon_frame"):
            x, y = getattr(a, acc)(i), getattr(b, acc)(i)
            if (x is None) != (y is None) or (x is not None and not np.array_equal(x, y, equal_nan=True)):
                raise AssertionError(f"{label}: {acc}({i}) differs")


def direct_matches_stream(label, direct, r, dE) -> None:
    """A direct engine call's (times, frames, mass, limits) against a stream, bit for bit; the
    stream's bin sums give the direct call's mass exactly."""
    times, frames, mass, limits = direct[:4]
    if r.times != times or r.mass_over_time != mass or r.color_limits != limits:
        raise AssertionError(f"{label}: stream times/mass/limits differ from the direct call")
    for i, frame in enumerate(frames):
        if not np.array_equal(r.frame(i), frame, equal_nan=True):
            raise AssertionError(f"{label}: streamed frame {i} differs from the direct call")
        sums = r.energy_bin_sums(i)
        if sums is not None and float(np.sum(sums) * dE) != mass[i]:  # dx = 1
            raise AssertionError(f"{label}: bin sums of frame {i} do not give the direct call's mass")


def copied_row(rows, name, suffix, launches, phase):
    """A kernels-line row of phase 9: the kernel's numbers at the same shapes and inputs
    as an earlier phase's row of this run, with phase 9's launches."""
    src = next(r for r in rows if r["name"] == name)
    return dict(src, name=f"{name}_{suffix}", launches=launches, timed_in=phase)


def phase_setup_flagship(card: str, tmp, rows_before) -> list[dict]:
    print("== 9a the flagship setup from a file: 1024² × 16 through run_setup, integrated detail, "
          "streamed and checkpointed, float32", flush=True)
    import qpsim_tpu_torch
    from qpsim_tpu_torch.io import storage
    from qpsim_tpu_torch.io.checkpoint import SimulationCheckpointer
    from qpsim_tpu_torch.io.stream import FrameStreamWriter, load_frame_stream
    from qpsim_tpu_torch.ops.energy_grid import build_energy_grid

    setup = flagship_setup(1024)
    t0 = time.perf_counter()
    path = qpsim_tpu_torch.save_setup(setup, tmp / "flagship.json")
    loaded = qpsim_tpu_torch.load_setup(path)
    io_s = time.perf_counter() - t0
    if storage.serialize_setup(loaded) != storage.serialize_setup(setup):
        raise AssertionError("9a: the setup changed on its way through the file")
    _, dE = build_energy_grid(180.0, 1.0, 4.0, 16)
    segments = plan_of(loaded)
    stamps: list[float] = []
    with engine_keywords() as kw, \
            timed_calls(FrameStreamWriter, "write", shard_mb) as writes, \
            timed_calls(SimulationCheckpointer, "save_step", step_file_mb) as saves:
        reset_counts()
        t0 = time.perf_counter()
        result, saved = qpsim_tpu_torch.run_setup(
            loaded, save_path=tmp / "flagship_result.json", snapshot_detail="integrated",
            stream_dir=tmp / "9a_stream", checkpoint_dir=tmp / "9a_ck", progress_callback=stamp_into(stamps))
        call_s = time.perf_counter() - t0
        counts = read_counts()
    check_counts("9a run_setup 1024² × 16", counts, coupled_expect(segments, "collision_step"))
    if result.metadata["diagnostics_mode"] != "open_system" or "save_error" in result.metadata:
        raise AssertionError(f"9a: diagnostics {result.metadata.get('diagnostics_mode')}, "
                             f"save error {result.metadata.get('save_error')}")
    back = qpsim_tpu_torch.load_simulation(saved)
    if back.times != result.times or back.mass_over_time != result.mass_over_time:
        raise AssertionError("9a: the saved result does not load as it was saved")
    # the same keywords, the same detail, no sinks
    engine_kw = {k: v for k, v in kw.items() if k not in ("checkpointer", "frame_sink", "progress_callback")}
    engine_kw["phonon_history_out"] = {}
    direct_stamps: list[float] = []
    direct = qpsim_tpu_torch.run_2d_crank_nicolson(**engine_kw, progress_callback=stamp_into(direct_stamps))
    stream_a = load_frame_stream(tmp / "9a_stream")
    direct_matches_stream("9a", direct, stream_a, dE)
    steps = sum(s.length for s in segments)
    print(f"  9a: setup file written and read back in {io_s:.3f} s; run_setup {call_s:.2f} s whole call, "
          f"steady {steady_ms(stamps, steps):.3f} ms/step (host clock, first to last stored frame, "
          f"with the shard writes and checkpoint saves) against the direct call's "
          f"{steady_ms(direct_stamps, steps):.3f} ms/step (no sinks); diagnostics "
          f"{result.metadata['diagnostics_mode']}; the stream bit-equal to the direct call — {card}", flush=True)
    for i, ((w_s, w_mb), (c_s, c_mb)) in enumerate(zip(writes, saves)):
        print(f"  9a stored index {i}: shard write {1e3 * w_s:.1f} ms ({w_mb:.2f} MB), checkpoint save "
              f"{1e3 * c_s:.1f} ms ({c_mb:.1f} MB) — {card}")
    sys.stdout.flush()
    shutil.rmtree(tmp / "9a_ck")
    rows = [copied_row(rows_before, "collision_step", "run_setup", counts["collision_step"], "4"),
            copied_row(rows_before, "adi_x_half", "run_setup", counts["adi_x_half"], "4"),
            copied_row(rows_before, "adi_y_half", "run_setup", counts["adi_y_half"], "4")]

    print("== 9a' full detail on 256², streamed", flush=True)
    small = flagship_setup(256)
    with engine_keywords() as kw, timed_calls(FrameStreamWriter, "write", shard_mb) as writes:
        qpsim_tpu_torch.run_setup(small, save=False, stream_dir=tmp / "9a2_stream")
    engine_kw = {k: v for k, v in kw.items() if k not in ("checkpointer", "frame_sink")}
    ph: dict = {}
    engine_kw["phonon_history_out"] = ph
    direct = qpsim_tpu_torch.run_2d_crank_nicolson(**engine_kw)
    r = load_frame_stream(tmp / "9a2_stream")
    direct_matches_stream("9a'", direct, r, dE)
    for i in range(r.count):
        pairs = ((r.energy_frames(i), np.stack(direct[4][i])), (r.phonon_frame(i), ph["phonon_frames"][i]),
                 (r.phonon_energy_frames(i), np.stack(ph["phonon_energy_frames"][i])))
        if not all(np.array_equal(a, b, equal_nan=True) for a, b in pairs):
            raise AssertionError(f"9a': the per-bin frames of stored frame {i} differ from the direct call")
    print(f"  9a': 256² × 16 full detail streamed, bit-equal to the direct call (frames, 16 energy "
          f"frames, phonon frames); shards " + ", ".join(f"{mb:.1f} MB in {1e3 * s:.0f} ms" for s, mb in writes)
          + f" — {card}", flush=True)
    shutil.rmtree(tmp / "9a2_stream")

    print("== 9b interrupt at 3.1 ns (62 steps, a forced final store) and resume to 5 ns", flush=True)
    from qpsim_tpu_torch.solver import spectral_runner

    short = with_params(loaded, total_time=3.1)
    qpsim_tpu_torch.run_setup(short, save=False, snapshot_detail="integrated",
                              stream_dir=tmp / "9b_stream", checkpoint_dir=tmp / "9b_ck")
    interrupted = stored_steps(tmp / "9b_ck")
    if interrupted != [0, 25, 50, 62]:
        raise AssertionError(f"9b: the interrupted run stored steps {interrupted}")
    with timed_calls(spectral_runner, "_usable_resume_prefix") as replay:
        t0 = time.perf_counter()
        resumed, _ = qpsim_tpu_torch.run_setup(loaded, save=False, snapshot_detail="integrated",
                                               stream_dir=tmp / "9b_stream", checkpoint_dir=tmp / "9b_ck")
        resumed_s = time.perf_counter() - t0
    stream_b = load_frame_stream(tmp / "9b_stream")
    equal_streams("9b: resumed against 9a", stream_b, stream_a)
    if resumed.times != result.times or resumed.mass_over_time != result.mass_over_time or \
            resumed.metadata["energy_qp_total"] != result.metadata["energy_qp_total"] or \
            resumed.metadata["energy_phonon_total"] != result.metadata["energy_phonon_total"]:
        raise AssertionError("9b: the resumed result differs from 9a's")
    after = stored_steps(tmp / "9b_ck")
    if after != [0, 25, 50, 75, 100]:
        raise AssertionError(f"9b: after the resume the checkpoints hold steps {after}")
    print(f"  9b: interrupted run stored steps {interrupted}; the resume replayed 3 indices in "
          f"{replay[0][0]:.2f} s (restores; index 3, the forced step 62, discarded), whole resumed call "
          f"{resumed_s:.2f} s against 9a's {call_s:.2f} s; checkpoints now hold steps {after}; times, mass, "
          f"energy totals and the stream bit-equal to 9a — {card}", flush=True)
    shutil.rmtree(tmp / "9b_ck")
    shutil.rmtree(tmp / "9b_stream")
    shutil.rmtree(tmp / "9a_stream")
    return rows


def phase_setup_ne100(card: str, tmp, rows_before) -> list[dict]:
    print("== 9c 100 bins through run_setup: 1024² × 100, 20 steps (cut from 40 for phase 13), integrated "
          "detail, streamed", flush=True)
    import qpsim_tpu_torch
    from qpsim_tpu_torch.io.stream import load_frame_stream

    setup = flagship_setup(1024, ne=100, steps=20, store_every=20, name="ne100")
    stamps: list[float] = []
    with engine_keywords() as kw:
        reset_counts()
        t_light = time.perf_counter()
        qpsim_tpu_torch.run_setup(setup, save=False, snapshot_detail="integrated",
                                  stream_dir=tmp / "9c_stream", progress_callback=stamp_into(stamps))
        counts = read_counts()
    check_counts("9c run_setup 1024² × 100", counts, coupled_expect(plan_of(setup), "collision_step_blocked"))
    engine_kw = {k: v for k, v in kw.items()
                 if k not in ("checkpointer", "frame_sink", "progress_callback", "phonon_history_out")}
    engine_kw["snapshot_detail"] = "full"
    full_stamps: list[float] = []
    t_full = time.perf_counter()
    full = qpsim_tpu_torch.run_2d_crank_nicolson(**engine_kw, progress_callback=stamp_into(full_stamps))
    r = load_frame_stream(tmp / "9c_stream")
    mask = engine_kw["mask"]
    if r.times != full[0]:
        raise AssertionError("9c: stored times differ")
    frame_err = max(scaled_err_np(r.frame(i), full[1][i]) for i in range(r.count))
    sums_err = max(scaled_err_np(r.energy_bin_sums(i), np.array([np.sum(f[mask]) for f in full[4][i]]))
                   for i in range(r.count))
    check("9c integrated frames against the full-detail call (float32)", frame_err, 1e-5)
    check("9c bin sums against the full-detail call's energy frames (float32)", sums_err, 1e-5)
    print(f"  9c: call to first stored frame / first to last stored frame (20 steps and the final "
          f"stored frame): integrated + stream {stamps[0] - t_light:.3f} / {stamps[-1] - stamps[0]:.3f} s; "
          f"full detail in memory {full_stamps[0] - t_full:.3f} / {full_stamps[-1] - full_stamps[0]:.3f} s "
          f"— {card}", flush=True)
    shutil.rmtree(tmp / "9c_stream")
    return [copied_row(rows_before, "collision_step_blocked", "run_setup", counts["collision_step_blocked"], "4c")]


def scaled_err_np(got, ref) -> float:
    got, ref = np.nan_to_num(np.asarray(got, np.float64)), np.nan_to_num(np.asarray(ref, np.float64))
    return float(np.max(np.abs(got - ref))) / max(1e-300, float(np.max(np.abs(ref))))


def phase_setup_scalar(card: str, tmp, rows_before) -> list[dict]:
    print("== 9d the scalar setup: bench.py's 1024² film, energy_gap 0, 2000 steps stored every 500, "
          "streamed, float32", flush=True)
    import qpsim_tpu_torch
    from qpsim_tpu_torch.fields import default_initial_condition
    from qpsim_tpu_torch.geometry.mask import extract_edge_segments
    from qpsim_tpu_torch.io.stream import load_frame_stream
    from qpsim_tpu_torch.models.params import BoundaryCondition, GeometryData, SetupData, SimulationParameters

    n, steps = 1024, 2000
    mask = np.ones((n, n), dtype=bool)
    edges = extract_edge_segments(mask)
    geo = GeometryData(name="film", source_path="intrinsic", layer=0, mesh_size=1.0,
                       mask=mask.astype(int).tolist(), edges=edges, bounds=[0.0, 0.0, float(n), float(n)])
    setup = SetupData(
        setup_id="scalar001024", name="scalar film 1024²", created_at="2026-01-01T00:00:00+00:00", geometry=geo,
        boundary_conditions={e.edge_id: BoundaryCondition(kind="reflective") for e in edges},
        parameters=SimulationParameters(diffusion_coefficient=6.0, dt=0.1, total_time=0.1 * steps,
                                        mesh_size=1.0, store_every=500, energy_gap=0.0),
        initial_condition=default_initial_condition())
    from qpsim_tpu_torch.io.stream import FrameStreamWriter

    stamps: list[float] = []
    reset_counts()
    t0 = time.perf_counter()
    with timed_calls(FrameStreamWriter, "write", shard_mb) as writes:
        result, saved = qpsim_tpu_torch.run_setup(setup, save_path=tmp / "scalar.json", stream_dir=tmp / "9d_stream",
                                                  progress_callback=stamp_into(stamps))
    counts = read_counts()
    check_counts("9d scalar run_setup 1024²", counts,
                 {"adi_sep_x": steps, "adi_sep_y": steps, "adi_x_half": 0, "adi_y_half": 0, "thomas": 0})
    back = qpsim_tpu_torch.load_simulation(saved)
    r = load_frame_stream(tmp / "9d_stream")
    if back.mass_over_time != result.mass_over_time or r.mass_over_time != result.mass_over_time:
        raise AssertionError("9d: the saved result or the stream lost the mass history")
    if r.times != result.times or len(r.times) != 1 + sum(s.stored for s in plan_of(setup)):
        raise AssertionError(f"9d: stored times {r.times}")
    check_frames([r.frame(i) for i in range(r.count)], mask)
    mass = result.mass_over_time
    drift = max(abs(m - mass[0]) for m in mass) / mass[0]
    bound_ = steps * float(np.finfo(np.float32).eps)
    print(f"  9d: mass {mass}; max relative drift {drift:.3e} (bound {bound_:.1e}); call to first frame "
          f"{stamps[0] - t0:.3f} s, steady {1e3 * steady_ms(stamps, steps):.2f} µs/step = "
          f"{n * n / (steady_ms(stamps, steps) * 1e-3):.4e} cell-steps/s (with the stored frames); shard "
          f"writes " + ", ".join(f"{1e3 * s:.0f} ms ({mb:.2f} MB)" for s, mb in writes) + f" — {card}", flush=True)
    if drift > bound_:
        raise AssertionError(f"9d: mass drift {drift:.3e} > {bound_:.1e}")
    shutil.rmtree(tmp / "9d_stream")
    return [copied_row(rows_before, name, "run_setup", counts[name], "6") for name in ("adi_sep_x", "adi_sep_y")]


def phase_setup_sweep(card: str, tmp) -> None:
    print("== 9e a sweep: bath_temperature 0.1, 0.2 × dynes_gamma 1e-4 on 256² × 16, 20 steps", flush=True)
    import qpsim_tpu_torch
    from qpsim_tpu_torch.sweep import build_variants, run_sweep

    setup = flagship_setup(256, steps=20, store_every=20, name="sweep")
    axes = [("bath_temperature", [0.1, 0.2]), ("dynes_gamma", [1e-4])]
    t0 = time.perf_counter()
    summary = run_sweep(setup, axes, out_dir=tmp / "9e_sweep", device="cuda")
    sweep_s = time.perf_counter() - t0
    if summary["n_variants"] != 2 or summary["n_failed"]:
        raise AssertionError(f"9e: {summary['n_failed']} of {summary['n_variants']} variants failed")
    for i, (record, (overrides, variant)) in enumerate(zip(summary["variants"], build_variants(setup, axes))):
        # streamed, so no frame is converted for JSON: the mass history is the same bits
        alone, _ = qpsim_tpu_torch.run_setup(variant, save=False, stream_dir=tmp / f"9e_alone_{i}")
        if record["overrides"] != overrides or record["mass_final"] != alone.mass_over_time[-1]:
            raise AssertionError(f"9e: variant {overrides} differs from a lone run_setup call")
    t0 = time.perf_counter()
    again = run_sweep(setup, axes, out_dir=tmp / "9e_sweep", device="cuda", resume=True)
    resume_s = time.perf_counter() - t0
    if not all(r.get("resumed") for r in again["variants"]):
        raise AssertionError("9e: resume=True re-ran a finished variant")
    finals = ", ".join(f"{r['mass_final']:.6e}" for r in summary["variants"])
    print(f"  9e: 2 variants in {sweep_s:.2f} s, each final mass bit-equal to a lone run_setup call "
          f"({finals}); resume=True re-ran none, {resume_s:.2f} s — {card}", flush=True)
    shutil.rmtree(tmp / "9e_sweep")


#: the analytic suite's accuracy gates (``tests/test_testcases.py``): per group, the
#: tolerance of each case in order (a single value for all); the donut's on its frame
#: at t = 1 ns, the horizon that test gates (the polygon's eigenvalue differs from the
#: continuum annulus's by a few %, so the error grows with t: 0.30 at the default 8 ns)
SUITE_GATES = {"strip_1d_effective": 2e-2, "polygon_donut": 0.2, "recombination": (0.3, 1e-4, 0.3),
               "scattering": (0.05, 1e-3)}


def suite_errors(suite) -> dict:
    """Each gated case's scaled error (and the recombination cases' early-time error),
    raising where one exceeds its gate."""
    groups = {g.geometry_id: g for g in suite.geometry_groups}
    if list(groups) != ["strip_1d_effective", "rectangle_2d", "polygon_donut", "recombination", "scattering"] \
            or sum(len(g.cases) for g in groups.values()) != 28:
        raise AssertionError("the suite must hold 28 cases in its 5 groups")
    worst = {}
    for gid, gate in SUITE_GATES.items():
        cases = groups[gid].cases
        tols = gate if isinstance(gate, tuple) else (gate,) * len(cases)
        for case, tol in zip(cases, tols):
            sim, ana = case.simulated, case.analytic
            if gid == "polygon_donut":
                at = int(np.argmin(np.abs(np.asarray(case.times) - 1.0)))
                sim, ana = [sim[at]], [ana[at]]
            sim = np.array([[np.nan if v is None else v for v in np.ravel(np.asarray(x, dtype=object))]
                            for x in sim], dtype=np.float64)
            ana = np.array([[np.nan if v is None else v for v in np.ravel(np.asarray(x, dtype=object))]
                            for x in ana], dtype=np.float64)
            m = np.isfinite(ana)
            scale = max(1e-12, float(np.max(np.abs(ana[m]))))
            err = float(np.max(np.abs(sim[m] - ana[m]))) / scale
            if not err < tol:
                raise AssertionError(f"{case.case_id}: scaled error {err:.3e} ≥ {tol:g}")
            worst[case.case_id] = err
            if gid == "recombination":
                k = max(2, sim.shape[1] // 20)
                early = float(np.max(np.abs(sim[0, :k] - ana[0, :k]))) / scale
                if not early < 0.02:
                    raise AssertionError(f"{case.case_id}: early-time error {early:.3e} ≥ 0.02")
    return worst


def suite_rows(card: str, by_bins: dict, validation_bins: dict) -> list[dict]:
    """K3 timed on the analytic suite's 1 × 1 cell at its bin counts (launches
    ``by_bins``: the suite of phase 11f's ``gen-tests``) and on the validation
    suite's 1 × 16 strip at 24 bins (launches: phase 8c's)."""
    rows = [small_k3_row(f"collision_step_suite_cell_ne{ne}", ne, 1, emax, by_bins[ne], card)
            for ne, emax in ((1, 1.5), (10, 3.0), (15, 3.0))]
    rows.append(small_k3_row("collision_step_validation_strip_ne24", 24, (1, 16), 4.0,
                             validation_bins[("collision_step", 24)], card))
    return rows


def small_k3_row(name, ne, n, emax, launches, card) -> dict:
    """A kernels-line row of K3 on a small grid (``n`` an int or (ny, nx)): a launch's
    time on the card is its overhead; events over 200 calls."""
    kern, plain, plan, tensors, q, ph, gen = collision_setup(ne, n, F32, emax=emax)
    ref = plain(q, ph, 0.05, None)
    got = kern(q, ph, 0.05, None)
    torch.cuda.synchronize()
    check(f"{name} float32 gen=False, q", scaled_err(got[0], ref[0]), TOL[("collision_step", F32)])
    check(f"{name} float32 gen=False, ph", scaled_err(got[1], ref[1]), TOL[("collision_step", F32)])
    row = dict(name=name, route="cuda", source="qpsim_tpu_torch/csrc/collisions.cu",
               replaces="qpsim_tpu/ops/pallas_collisions.py:169", launches=launches,
               max_abs_err=max(abs_err(got[0], ref[0]), abs_err(got[1], ref[1])),
               ms=time_ms(lambda: kern(q, ph, 0.05, None), 200),
               plain_ms=time_ms(lambda: plain(q, ph, 0.05, None), 20),
               **bound(*collision_work(plan, q, ph, None, tensors), F32), library_ms=None)
    shape = f"{n}×{n}" if isinstance(n, int) else f"{n[0]}×{n[1]}"
    print(f"  {name}: {ne} bins on {shape}, kernel {1e3 * row['ms']:.2f} µs, plain {1e3 * row['plain_ms']:.1f} µs, "
          f"bound {1e3 * row['bound_ms']:.4f} µs ({row['bound_by']}), {launches} launches — {card}", flush=True)
    return row


def phase_setup_runner(card: str, rows_before: list[dict]) -> list[dict]:
    """Phase 9: a setup file through ``run_setup``, streamed and resumed, and a
    sweep, in a temporary directory deleted at the end (the analytic suite:
    phase 11f's ``gen-tests``)."""
    import tempfile
    from pathlib import Path

    tmp = Path(tempfile.mkdtemp(prefix="qpsim_smoke9_"))
    rows = []
    try:
        for fn in (phase_setup_flagship, phase_setup_ne100, phase_setup_scalar):
            rows += timed_phase(fn, card, tmp, rows_before)
        timed_phase(phase_setup_sweep, card, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print("  phase 9 launches (the kernels line's *_run_setup rows): "
          + ", ".join(f"{r['name']} {r['launches']}" for r in rows), flush=True)
    return rows


# ---------------------------------------------------------------- phase 10: the slice


#: the differentiable simulation of phase 10 (a): a 64² film (diff.py's own
#: docstring size), 16 bins at E_max 4Δ, dt 0.05 ns, a seeded Gaussian
#: burst on a uniform floor (a uniform field would give D0 no gradient)
DIFF_STEPS, DIFF_CHUNK, DIFF_N = 400, 20, 64


def diff_sim(dtype, *, n_steps=DIFF_STEPS, remat=True, remat_chunk=DIFF_CHUNK, device="cuda", store_every=50):
    from qpsim_tpu_torch import diff as td

    n = DIFF_N
    yy, xx = np.mgrid[0:n, 0:n]
    rng = np.random.default_rng(10)
    field = 1e-5 * (1.0 + 4.0 * np.exp(-((xx - 20.0) ** 2 + (yy - 40.0) ** 2) / 60.0)) * rng.uniform(0.9, 1.1, (n, n))
    return td.make_differentiable_sim(
        mask=np.ones((n, n), dtype=bool), num_energy_bins=16, energy_max_factor=4.0, dt=0.05,
        n_steps=n_steps, initial_field=field, dtype=dtype,
        observables=("total", "spatial", "phonon_spectrum", "mkid"), store_every=store_every,
        remat=remat, remat_chunk=remat_chunk, device=device)


DIFF_PARAMS = {"D0": 6.0, "tau_s": 440.0, "tau_r": 440.0, "gap": 180.0}


def diff_loss(out, w, mkid: tuple[float, float] | None = None):
    """One scalar over the observables, each term of order one; ``w`` weighs
    the last frame by the squared distance from the burst (its spread, which
    D0 drives).  ``mkid`` (:func:`mkid_scale` of the reference call, fixed
    weights) adds the MKID traces δf/f and δ(1/Q); float32 leaves them out,
    their δσ/σ ≈ 1e-7 being at its resolution."""
    s = out["spatial"]
    loss = ((s[-1] * w).sum() / s[0].sum() + out["total"][-1] / out["total"][0]
            + out["phonon_spectrum"].sum() / 1e3)
    if mkid is not None:
        loss = loss + out["mkid_df"].sum() / mkid[0] + out["mkid_dq"].sum() / mkid[1]
    return loss


def mkid_scale(out) -> tuple[float, float]:
    """Σ|δf/f| and Σ|δ(1/Q)| over a call's traces: the MKID terms' weights."""
    scale = float(out["mkid_df"].detach().abs().sum()), float(out["mkid_dq"].detach().abs().sum())
    if not min(scale) > 0.0:
        raise AssertionError(f"phase 10a: an MKID trace is zero throughout ({scale})")
    return scale


def log_grads(grads: dict) -> np.ndarray:
    """The gradient with respect to the log-parameters (p·∂L/∂p, what the
    fits step on): one array of commensurate entries, for scaled errors."""
    return np.array([DIFF_PARAMS[k] * grads[k] for k in DIFF_PARAMS])


def diff_value_and_grad(sim, dtype, loss_of, part_of=None):
    """(observables, loss, gradients, K10 launches forward and in backward,
    seconds, peak GiB, gradients of ``part_of``).  Gradients by
    ``torch.autograd.grad`` through the remat checkpoints; ``part_of`` (a
    second loss on the same observables) gets a second backward, after the
    counts and the clock."""
    from qpsim_tpu_torch.ops import tridiag_cuda as k10

    p = {k: torch.tensor(v, dtype=dtype, device="cuda", requires_grad=True) for k, v in DIFF_PARAMS.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    out = sim(p)
    torch.cuda.synchronize()
    fwd = {k: k10.LAUNCHES[k] for k in ("thomas", "thomas_cols", "thomas_relayout")}
    reset_counts()
    loss = loss_of(out)
    grads = torch.autograd.grad(loss, list(p.values()), retain_graph=part_of is not None)
    torch.cuda.synchronize()
    bwd = {k: k10.LAUNCHES[k] for k in ("thomas", "thomas_cols", "thomas_relayout", "thomas_backward")}
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    part = None
    if part_of is not None:
        part = dict(zip(p, (float(g) for g in torch.autograd.grad(part_of(out), list(p.values())))))
    return ({k: v.detach() for k, v in out.items()}, float(loss.detach()),
            dict(zip(p, (float(g) for g in grads))), fwd, bwd, seconds, peak, part)


def remat_expect(n: int, chunk: int | None, remat: bool = True) -> tuple[dict, dict]:
    """K10 launches of an n-step call: n·2 forward; in backward the
    transposed solves (n·2), with remat the step recompute (n·2) and
    two-level the chunk recompute (n·2)."""
    total = 2 * n * (1 + int(remat) + int(bool(chunk)))
    fwd = {"thomas": 2 * n, "thomas_cols": n, "thomas_relayout": 0}
    return fwd, {"thomas": total, "thomas_cols": total // 2, "thomas_relayout": 0, "thomas_backward": 2 * n}


def phase_slice_diff(card: str) -> list[dict]:
    print(f"== 10a make_differentiable_sim: 64² × 16 bins, {DIFF_STEPS} steps, remat_chunk={DIFF_CHUNK}, float64",
          flush=True)
    from qpsim_tpu_torch.ops import tridiag_cuda as k10

    yy, xx = np.mgrid[0:DIFF_N, 0:DIFF_N]
    w = torch.as_tensor(((xx - 20.0) ** 2 + (yy - 40.0) ** 2) / DIFF_N**2, device="cuda")
    # the loss with the MKID traces, and (second backward) without them, for the float32 hold
    out, loss, grads, fwd, bwd, secs, peak, grads_main = diff_value_and_grad(
        diff_sim(F64), F64, lambda o: diff_loss(o, w, mkid_scale(o)), lambda o: diff_loss(o, w))
    scale = mkid_scale(out)
    expect_fwd, expect_bwd = remat_expect(DIFF_STEPS, DIFF_CHUNK)
    n = DIFF_STEPS
    print(f"  K10 launches: forward {fwd} (expected {expect_fwd}); backward {bwd} (expected {expect_bwd}); "
          f"per half-step {(fwd['thomas'] + bwd['thomas']) / (2 * n):.2f} (n × 2 halves × 4 = {8 * n})")
    if fwd != expect_fwd or bwd != expect_bwd:
        raise AssertionError("phase 10a: K10 launch counts differ from the prediction")
    print(f"  value and gradient {secs:.2f} s, peak device memory {peak:.3f} GiB; loss {loss:.12e} "
          f"(MKID weights Σ|δf/f| {scale[0]:.6e}, Σ|δ(1/Q)| {scale[1]:.6e}); grads {grads}; "
          f"without the MKID terms {grads_main} — {card}", flush=True)
    for k, v in out.items():
        if not torch.isfinite(v).all():
            raise AssertionError(f"phase 10a: {k} is not finite")
    if tuple(out["spatial"].shape) != (DIFF_STEPS // 50 + 1, DIFF_N, DIFF_N):
        raise AssertionError(f"phase 10a: spatial frames {tuple(out['spatial'].shape)}")

    # one gradient of the 400-step call against a fourth-order central difference
    # (forward calls only), on the loss without the MKID terms: h = 1 % of τ_r
    # keeps that loss's float64 roundoff over 400 steps (≈ 1e-13) and the h⁴
    # truncation both below 1e-7.  The MKID terms are differences δσ/σ ≈ 1e-8
    # of two float64 integrals, whose roundoff a difference quotient at this h
    # does not resolve to 1e-6: that reading is printed, not held
    h = 1e-2 * DIFF_PARAMS["tau_r"]
    t0 = time.perf_counter()
    with torch.no_grad():
        fd_sim = diff_sim(F64, remat=False, remat_chunk=None)
        at = {s: fd_sim({**DIFF_PARAMS, "tau_r": DIFF_PARAMS["tau_r"] + s * h}) for s in (1, -1, 2, -2)}
        quotient = lambda f: (8.0 * (f(at[1]) - f(at[-1])) - (f(at[2]) - f(at[-2]))) / (12.0 * h)
        fd = quotient(lambda o: float(diff_loss(o, w)))
        fd_mkid = quotient(lambda o: float(diff_loss(o, w, scale)))
    print(f"  with the MKID terms: dL/dtau_r {grads['tau_r']:.9e}, central difference {fd_mkid:.9e} "
          f"(rel {abs(grads['tau_r'] - fd_mkid) / abs(fd_mkid):.3e}; not held)")
    check(f"10a dL/dtau_r (no MKID terms) {grads_main['tau_r']:.9e} vs a central difference {fd:.9e} "
          f"({time.perf_counter() - t0:.2f} s)", abs(grads_main["tau_r"] - fd) / abs(fd), 1e-6)

    # the three remat modes on the first 40 steps of the film: K10 launches and
    # peak memory; the two-level run is the float64 side of the 40-step float32 hold
    for remat, ch in ((False, None), (True, None), (True, 10)):
        out40, _, grads40, mf, mb, msecs, mpeak, _ = diff_value_and_grad(
            diff_sim(F64, n_steps=40, remat=remat, remat_chunk=ch, store_every=10), F64, lambda o: diff_loss(o, w))
        want_f, want_b = remat_expect(40, ch, remat)
        print(f"  remat={remat} remat_chunk={ch}, 40 steps: K10 {mf['thomas']} + {mb['thomas']} = "
              f"{mf['thomas'] + mb['thomas']} (expected {want_f['thomas'] + want_b['thomas']}), {msecs:.2f} s, "
              f"peak {mpeak:.3f} GiB — {card}", flush=True)
        if mf != want_f or mb != want_b:
            raise AssertionError(f"phase 10a: remat={remat}, chunk={ch}: K10 launches differ")

    # the 400-step call with ThomasSolve on its plain solve on the card (forward
    # and backward), on the one-level checkpoint: the two-level schedule's
    # numbers to roundoff (the same operations, other summation boundaries),
    # three solves a half-step instead of four, ≈ 8.6 ms each
    real = k10._solve
    k10._solve = lambda sub, diag, sup, rhs, backward=False: k10.thomas_plain(sub, diag, sup, rhs)
    try:
        ref, _, ref_grads, pf, pb, psecs, _, _ = diff_value_and_grad(
            diff_sim(F64, remat_chunk=None), F64, lambda o: diff_loss(o, w, scale))
    finally:
        k10._solve = real
    if pf["thomas"] or pb["thomas"]:
        raise AssertionError("phase 10a: the plain solve launched K10")
    print(f"  plain solve on the card, {n} steps: {psecs:.2f} s")
    for k in out:
        check(f"10a {k}: K10 vs the plain solve, float64, {n} steps", scaled_err(out[k], ref[k]), 1e-10)
    lg, lg_ref = log_grads(grads), log_grads(ref_grads)
    print(f"  p·dL/dp {dict(zip(DIFF_PARAMS, lg))}; per entry, K10 against plain "
          f"{dict(zip(DIFF_PARAMS, np.abs(lg - lg_ref) / np.abs(lg_ref)))}")
    check(f"10a p·dL/dp (MKID traces in the loss): K10 vs the plain solve, float64, {n} steps (scaled)",
          float(np.max(np.abs(lg - lg_ref)) / np.max(np.abs(lg_ref))), 1e-10)

    # the same 400-step call in float32: its observables against float64 at the
    # float32 tier (docs/f32_tiers.md: ≤ 2e-3).  Its gradient is read against
    # float64's, not held there: float32 arithmetic of the simulation itself
    # moves the total trace's Δ and τ_s entries by ≈ 5e-3 over 400 steps (the
    # plain path on the CPU shows it, PERF.md §6); the gradient is held at 40 steps
    out32, _, grads32, f32_fwd, f32_bwd, secs32, peak32, _ = diff_value_and_grad(
        diff_sim(F32), F32, lambda o: diff_loss(o, w.float()))
    print(f"  float32, {n} steps: {secs32:.2f} s, peak {peak32:.3f} GiB, K10 {f32_fwd} / {f32_bwd}; "
          f"MKID traces (not held: δσ/σ is at float32's resolution) δf/f[-1] {float(out32['mkid_df'][-1]):.3e} "
          f"against {float(out['mkid_df'][-1]):.3e} in float64")
    if f32_fwd != expect_fwd or f32_bwd != expect_bwd:
        raise AssertionError("phase 10a: float32 K10 launch counts differ from the prediction")
    for k in ("total", "spatial", "phonon_spectrum"):
        check(f"10a {k}: float32 vs float64, {n} steps", scaled_err(out32[k], out[k]), 2e-3)
    lg32, lg_main = log_grads(grads32), log_grads(grads_main)
    print(f"  float32 p·dL/dp (no MKID terms), {n} steps, against float64: per entry "
          f"{dict(zip(DIFF_PARAMS, np.abs(lg32 - lg_main) / np.abs(lg_main)))}, scaled "
          f"{float(np.max(np.abs(lg32 - lg_main)) / np.max(np.abs(lg_main))):.3e} (not held)")
    out32, _, grads32, _, _, _, _, _ = diff_value_and_grad(
        diff_sim(F32, n_steps=40, remat_chunk=10, store_every=10), F32, lambda o: diff_loss(o, w.float()))
    for k in ("total", "spatial", "phonon_spectrum"):
        check(f"10a {k}: float32 vs float64, 40 steps", scaled_err(out32[k], out40[k]), 2e-3)
    lg32, lg40 = log_grads(grads32), log_grads(grads40)
    check("10a p·dL/dp (no MKID terms): float32 vs float64, 40 steps (scaled)",
          float(np.max(np.abs(lg32 - lg40)) / np.max(np.abs(lg40))), 2e-3)

    # K10 at the simulation's shapes: 16 × 64 lines of 64, rows (x half) and cols (y half), float64
    rows = []
    for form, key, launches in (("rows", "thomas_diff_rows", fwd["thomas"] - fwd["thomas_cols"]
                                 + bwd["thomas"] - bwd["thomas_cols"]),
                                ("cols", "thomas_diff_cols", fwd["thomas_cols"] + bwd["thomas_cols"])):
        rows.append(thomas_row(key, tridiag_case(form, 16, 64, 64, F64, kind="dominant"), launches, F64))
    print_rows(rows, "16 × 64 lines of 64, the differentiable simulation's halves", card, "float64")
    return rows


def thomas_row(name, system, launches, dtype) -> dict:
    """A kernels-line row of K10 on ``system`` (the plain version on the same inputs)."""
    from qpsim_tpu_torch.ops import tridiag_cuda as k10

    ref = k10.thomas_plain(*system)
    got = k10.thomas(*system)
    torch.cuda.synchronize()
    check(f"{name} {str(dtype)[6:]}", scaled_err(got, ref), TOL[("thomas", dtype)])
    return dict(name=name, route="cuda", source="qpsim_tpu_torch/csrc/tridiag.cu",
                replaces="qpsim_tpu/ops/pallas_tridiag.py:35", launches=launches,
                max_abs_err=abs_err(got, ref), ms=time_ms(lambda: k10.thomas(*system), 20),
                plain_ms=time_ms(lambda: k10.thomas_plain(*system), 3),
                **bound(*thomas_work(system), dtype), library_ms=None)


def phase_slice_fits(card: str) -> None:
    print("== 10b fit_parameters (1 × 64 wire, 20 Adam iterations) and fit_ensemble (B = 32)", flush=True)
    from qpsim_tpu_torch import diff as td
    from qpsim_tpu_torch.ops import tridiag_cuda as k10

    # the JAX package's fit configuration (tests/test_diff.py) on a 1 × 64
    # wire, 15 steps; no remat (a wire's steps hold kilobytes)
    cfg = dict(nx=64, num_energy_bins=8, energy_max_factor=4.0, dt=2.0, n_steps=15, n0=0.5,
               bath_temperature=0.0, phonon_feedback=False, remat=False)
    decay = td.make_differentiable_decay(**cfg)
    fixed = {"D0": 6.0, "tau_s": 440.0}
    with torch.no_grad():
        observed = decay({**fixed, "tau_r": 250.0}).cpu().numpy()
    t0 = time.perf_counter()
    got = td.fit_parameters(observed, {"tau_r": 600.0}, decay_fn=lambda p: decay({**fixed, **p}),
                            learning_rate=0.08, n_iters=20)
    card_s = time.perf_counter() - t0
    cpu_decay = td.make_differentiable_decay(**cfg, device="cpu")
    t0 = time.perf_counter()
    cpu = td.fit_parameters(observed, {"tau_r": 600.0}, decay_fn=lambda p: cpu_decay({**fixed, **p}),
                            learning_rate=0.08, n_iters=20)
    print(f"  fit_parameters: tau_r 600 → {got['tau_r']:.9f} (true 250) on the card in {card_s:.2f} s; "
          f"{cpu['tau_r']:.9f} on the CPU in {time.perf_counter() - t0:.2f} s — {card}", flush=True)
    check("10b fit_parameters card vs CPU", abs(got["tau_r"] - cpu["tau_r"]) / cpu["tau_r"], 1e-9)
    if not got["tau_r"] < 400.0:
        raise AssertionError("phase 10b: fit_parameters did not move towards the truth")

    b = 32
    true_r = np.linspace(200.0, 700.0, b)
    with torch.no_grad():
        reset_counts()
        obs = decay({"D0": np.full(b, 6.0), "tau_s": np.full(b, 440.0), "tau_r": true_r})
        one_call = dict(k10.LAUNCHES)
    # one K10 launch a step for all 32 members: the x half (the y half's
    # lines on a 1 × 64 wire are single cells, a division, no launch)
    check_counts(f"10b one batched decay call (32 members, {cfg['n_steps']} steps)", one_call,
                 {"thomas": cfg["n_steps"], "thomas_backward": 0})
    init = {"D0": np.full(b, 6.0), "tau_s": np.full(b, 440.0), "tau_r": np.full(b, 400.0)}
    obs_np = obs.cpu().numpy()
    loss_of = lambda tr: float(((decay({**fixed, "tau_r": tr}) - obs) ** 2 / obs**2).mean(-1).sum())
    reset_counts()
    t0 = time.perf_counter()
    fitted = td.fit_ensemble(obs_np, init, decay_fn=decay, learning_rate=0.1, n_iters=20)
    secs = time.perf_counter() - t0
    counts = dict(k10.LAUNCHES)
    check_counts("10b fit_ensemble, 20 iterations (a solve and a transposed solve a step)", counts,
                 {"thomas": 20 * 2 * cfg["n_steps"], "thomas_backward": 20 * cfg["n_steps"]})
    with torch.no_grad():
        before, after = loss_of(init["tau_r"]), loss_of(fitted["tau_r"])
    print(f"  fit_ensemble: {secs:.2f} s; summed loss {before:.6e} → {after:.6e}; |tau_r − true| median "
          f"{np.median(np.abs(fitted['tau_r'] - true_r)):.3f} (start {np.median(np.abs(400.0 - true_r)):.3f}) "
          f"— {card}", flush=True)
    if not after < 0.5 * before:
        raise AssertionError("phase 10b: fit_ensemble did not reduce the loss")


ENS_B, ENS_SHAPE, ENS_NE, ENS_STEPS = 32, (64, 64), 8, 200


def ensemble_forms(b=ENS_B):
    """The five forms of phase 10c: (name, build keywords, chunk keywords, launch counter)."""
    from qpsim_tpu_torch.models.params import PhotonDriveSpec

    ny = ENS_SHAPE[0]
    spec = PhotonDriveSpec(mode="photon", photon_energy=2.6 * 180.0, occupancy=1.0, coupling=1e-4,
                           window_start=1.0, window_duration=4.0)
    return (
        ("uniform", dict(), dict(), "collision_step"),
        ("member_gaps", dict(gap=np.linspace(170.0, 190.0, b)), dict(), "collision_step_analytic"),
        ("member_taus", dict(tau_r=np.linspace(200.0, 700.0, b), tau_s=np.linspace(300.0, 600.0, b)), dict(),
         "collision_step_blocked_gid"),
        ("member_taus_8", dict(n_members=8, tau_r=np.linspace(200.0, 700.0, 8)), dict(), "collision_step_gid"),
        ("pulse_photon", dict(), dict(rates=np.linspace(1e-6, 4e-6, b), starts=np.linspace(0.5, 5.0, b),
                                      photon=spec, occupancy=np.linspace(0.5, 3.0, b)), "collision_step"),
    ), ny


def ensemble_chunk(ens, extra, n_steps):
    if not extra:
        return ens.make_chunk(n_steps), False
    return ens.make_chunk(n_steps, gen_plane=ens.generation_plane(extra["rates"]),
                          pulse_window=(extra["starts"], 1.0), photon=extra["photon"],
                          photon_occupancy=extra["occupancy"]), True


def ensemble_state(ens, seed=12):
    b, (ny, nx) = ens.n_members, ens.member_shape
    rng = np.random.default_rng(seed)
    rho = np.interp(np.arange(ens.num_energy_bins), [0, ens.num_energy_bins - 1], [1.0, 0.3])
    q = rng.uniform(0.5e-5, 1.5e-5, (b, ens.num_energy_bins, ny, nx)) * rho[None, :, None, None]
    return ens.pack(q, ens.thermal_phonons(np.full(b, 0.1)))


def member_kwargs(build, extra, m, b):
    """A solo run's build and chunk keywords: member m's parameters alone
    (per-member gaps keep the largest gap as a second member, so the energy
    grid is the ensemble's)."""
    solo = {k: (np.asarray(v)[m] if np.ndim(v) else v) for k, v in build.items() if k != "n_members"}
    n = 1
    if "gap" in build:
        solo["gap"] = np.array([build["gap"][m], build["gap"].max()])
        n = 2
    one = {k: (np.asarray(v)[m : m + 1] if k in ("rates", "starts", "occupancy") else v) for k, v in extra.items()}
    if "rates" in one and n == 2:
        one = {k: (np.repeat(v, 2) if k in ("rates", "starts", "occupancy") else v) for k, v in one.items()}
    return solo, one, n


def phase_slice_ensembles(card: str) -> list[dict]:
    print(f"== 10c film ensembles: {ENS_B} members of {ENS_SHAPE[0]}²×{ENS_NE} bins, {ENS_STEPS} steps, "
          "float32", flush=True)
    from qpsim_tpu_torch.parallel import build_film_ensemble

    forms, ny = ensemble_forms()
    counters = [c for c in read_counts()]
    rows, k10_rows = [], {}
    for name, build, extra, counter in forms:
        b = build.get("n_members", ENS_B)
        kw = {k: v for k, v in build.items() if k != "n_members"}
        t0 = time.perf_counter()
        ens = build_film_ensemble(n_members=b, member_shape=ENS_SHAPE, num_energy_bins=ENS_NE, **kw)
        set_up = time.perf_counter() - t0
        chunk, timed = ensemble_chunk(ens, extra, ENS_STEPS)
        q0, ph0 = ensemble_state(ens)
        state = ens.to_device(q0, ph0)
        call = (lambda q, ph: chunk(q, ph, 0.0)) if timed else chunk
        reset_counts()
        q, ph = call(*state)
        torch.cuda.synchronize()
        counts = read_counts()
        expect = {k: 0 for k in counters if k.startswith(("collision_step", "adi_", "thomas"))}
        expect.update({counter: 2 * ENS_STEPS, "thomas": 2 * ENS_STEPS, "thomas_cols": ENS_STEPS})
        got = {k: counts[k] for k in expect}
        if got != expect:
            raise AssertionError(f"10c {name}: launches {got} != {expect}")
        print(f"  {name}: {counter} {counts[counter]}, K10 {counts['thomas']} ({counts['thomas_cols']} cols, "
              f"{counts['thomas_relayout']} copied), nothing else launched; set-up {set_up:.2f} s", flush=True)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        q2, ph2 = call(*state)
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / ENS_STEPS
        print(f"  {name}: {ms:.4f} ms/step (CUDA events over a {ENS_STEPS}-step chunk, no host work in the "
              f"window), {1e3 * ms / b:.2f} µs per member-step — {card}", flush=True)
        if not (torch.equal(q, q2) and torch.equal(ph, ph2)):
            raise AssertionError(f"10c {name}: a second call gave other bits")
        stride = ny + 1
        if torch.any(q[:, ny::stride] != 0) or torch.any(ph[:, ny::stride] != 0):
            raise AssertionError(f"10c {name}: separator rows are not empty")
        if not (torch.isfinite(q).all() and torch.isfinite(ph).all()):
            raise AssertionError(f"10c {name}: non-finite state")
        qm, pm = ens.unpack(q, ph)
        for m in (0, b // 2, b - 1):
            solo_kw, solo_extra, n_solo = member_kwargs(build, extra, m, b)
            solo = build_film_ensemble(n_members=n_solo, member_shape=ENS_SHAPE, num_energy_bins=ENS_NE,
                                       **solo_kw)
            s_chunk, s_timed = ensemble_chunk(solo, solo_extra, ENS_STEPS)
            qsm, psm = ens.unpack(q0, ph0)
            pick = [m] * n_solo
            s_state = solo.to_device(*solo.pack(qsm[pick], psm[pick]))
            sq, sp = s_chunk(*s_state, 0.0) if s_timed else s_chunk(*s_state)
            sqm, spm = solo.unpack(sq, sp)
            err = max(scaled_err_np(qm[m], sqm[0]), scaled_err_np(pm[m], spm[0]))
            check(f"10c {name}: member {m} vs its solo run", err, 5e-6)
        row = next((r for r in rows if r["counter"] == counter), None)
        if row is None:  # one row a kernel form, at the first form that runs it
            rows.append(ensemble_kernel_row(name, ens, q, ph, counter, counts[counter]) | {"counter": counter})
        else:
            row["launches"] += counts[counter]
        k10_rows["rows"] = k10_rows.get("rows", 0) + counts["thomas"] - counts["thomas_cols"]
        k10_rows["cols"] = k10_rows.get("cols", 0) + counts["thomas_cols"]
        del ens, q, ph, q2, ph2
    for r in rows:
        del r["counter"]
    lines = ENS_B * (ENS_SHAPE[0] + 1) - 1
    rows.append(thomas_row("thomas_ensemble_rows", tridiag_case("rows", ENS_NE, lines, ENS_SHAPE[1], F32,
                                                                kind="dominant"), k10_rows["rows"], F32))
    rows.append(thomas_row("thomas_ensemble_cols", tridiag_case("cols", ENS_NE, ENS_SHAPE[1], lines, F32,
                                                                kind="dominant"), k10_rows["cols"], F32))
    print_rows(rows, f"{ENS_B} × {ENS_SHAPE[0]}² × {ENS_NE} ensemble super-grid", card)
    phase_slice_ensembles_f64()
    return rows


def ensemble_kernel_row(name, ens, q, ph, counter, launches) -> dict:
    """A kernels-line row of the form's collision kernel on its own state after the run."""
    step = ens.collision_half
    ref = step.plain(q, ph)
    got = step(q, ph)
    torch.cuda.synchronize()
    # float32 gates: K3 5e-7; K4 and the column walk 5e-6 (phase 3's)
    tol = 5e-7 if counter in ("collision_step", "collision_step_gid") else 5e-6
    check(f"{name}: {counter} vs its plain version on the ensemble's state, q", scaled_err(got[0], ref[0]), tol)
    check(f"{name}: {counter} vs its plain version on the ensemble's state, ph", scaled_err(got[1], ref[1]), tol)
    analytic = getattr(step, "analytic", None)
    if analytic is not None:
        tensors = kernel_tensors(step.tables, analytic.g2, analytic.E, analytic.inv_E, analytic.e2, analytic.zi)
    else:  # the gap ids ride in the column tables; the pair walk reads the plan's
        tensors = kernel_tensors(step.tables, step.plan.gap_id)
    source = "offset_walk.cu" if counter == "collision_step_blocked_gid" else "collisions.cu"
    replaces = ("qpsim_tpu/ops/pallas_collisions_blocked.py:930" if counter == "collision_step_blocked_gid"
                else "qpsim_tpu/ops/pallas_collisions.py:721" if counter == "collision_step_analytic"
                else "qpsim_tpu/ops/pallas_collisions.py:919")
    return dict(name=f"{counter}_ensemble_{name}", route="cuda", source=f"qpsim_tpu_torch/csrc/{source}",
                replaces=replaces, launches=launches,
                max_abs_err=max(abs_err(got[0], ref[0]), abs_err(got[1], ref[1])),
                ms=time_ms(lambda: step(q, ph), 20), plain_ms=time_ms(lambda: step.plain(q, ph), 3),
                **bound(*collision_work(step.plan, q, ph, None, tensors, analytic=analytic is not None), F32),
                library_ms=None)


def phase_slice_ensembles_f64() -> None:
    """The five forms in float64 on 32 members of 16² for 10 steps: the card
    against the plain path (the same ensemble on the CPU, whose wrappers run
    the plain versions), at the kernels' float64 gate."""
    from qpsim_tpu_torch.parallel import build_film_ensemble

    forms, _ = ensemble_forms()
    for name, build, extra, counter in forms:
        b = build.get("n_members", ENS_B)
        kw = {k: v for k, v in build.items() if k != "n_members"}
        out = []
        for device in ("cuda", "cpu"):
            ens = build_film_ensemble(n_members=b, member_shape=(16, 16), num_energy_bins=ENS_NE, dtype=F64,
                                      device=device, **kw)
            chunk, timed = ensemble_chunk(ens, extra, 10)
            state = ens.to_device(*ensemble_state(ens))
            reset_counts()
            res = chunk(*state, 0.0) if timed else chunk(*state)
            out.append([t.cpu() for t in res])
            if device == "cuda" and read_counts()[counter] != 20:
                raise AssertionError(f"10c f64 {name}: {counter} {read_counts()[counter]} launches, not 20")
        for label, a, c in (("q", out[0][0], out[1][0]), ("ph", out[0][1], out[1][1])):
            check(f"10c float64 {name} ({counter}) card vs plain path, {label}", scaled_err(a, c), 1e-10)


def phase_slice_qubit_observables(card: str, main: dict) -> None:
    print("== 10d the qubit model and the resonator observables", flush=True)
    from qpsim_tpu_torch import qubit as tq
    from qpsim_tpu_torch.observables import (
        PLANCK_UEV_PER_GHZ,
        mattis_bardeen_conductivity,
        mattis_bardeen_conductivity_traced,
        mkid_response_trace,
        occupation_from_spectral,
    )

    p = tq.JunctionParams(gap_L=190.0, gap_R=180.0, omega_10=20.0, cooper_pairs_L=1.0e9, gamma_ph=3.0e-7,
                          tau_R=5e4)
    temps = np.linspace(0.02, 0.28, 50)
    l_rates = dict(l_00=3.0, l_11=2.0, l_10=5.0, l_01=1.0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    on_card = tq.temperature_sweep(p, temps, l_rates=l_rates)
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    on_cpu = tq.temperature_sweep(p, temps, l_rates=l_rates, device="cpu")
    print(f"  temperature_sweep, 50 temperatures: {card_s:.2f} s on the card, {time.perf_counter() - t0:.2f} s "
          f"on the CPU; regimes {sorted(set(on_card['regimes']))} — {card}", flush=True)
    for k in ("states", "parity_rate_per_ns"):
        check(f"10d temperature_sweep {k}: card vs CPU", scaled_err_np(on_card[k], on_cpu[k]), 1e-10)
    check("10d temperature_sweep μ (µeV): card vs CPU, absolute",
          float(np.max(np.abs(on_card["mu_ueV"] - on_cpu["mu_ueV"]))), 1e-9)
    if on_card["regimes"] != on_cpu["regimes"]:
        raise AssertionError("10d: the regimes differ between the card and the CPU")
    if on_card["regimes"][0] == "full_equilibrium" or on_card["regimes"][-1] != "full_equilibrium":
        raise AssertionError(f"10d: no crossover to equilibrium: {on_card['regimes']}")

    frames, e_bins = main["energy_frames"], np.asarray(main["E_bins"])
    t0 = time.perf_counter()
    trace = mkid_response_trace(frames, e_bins, 180.0)
    secs = time.perf_counter() - t0
    print(f"  mkid_response_trace on phase 4's {len(frames)} stored frames (1024² × 16) in {secs:.2f} s: "
          f"t {list(main['times'])} ns, δf/f {trace['df_over_f']}, δ(1/Q) {trace['dQ_inv']}", flush=True)
    # more quasiparticles always lower σ₂ (so f); σ₁'s sign follows the shape
    # of f(E) (the pulse fills every bin alike, so f grows with E here)
    if not (np.all(np.isfinite(trace["df_over_f"] + trace["dQ_inv"])) and trace["df_over_f"][0] == 0.0
            and all(v < 0.0 for v in trace["df_over_f"][1:])):
        raise AssertionError("10d: the pulse must lower the resonance frequency")
    # the last frame's film-averaged occupation through the differentiable form on the card
    stack = np.asarray([np.asarray(b, np.float64) for b in frames[-1]])
    n_avg = np.nanmean(stack.reshape(stack.shape[0], -1), axis=1)
    f_avg = occupation_from_spectral(n_avg, e_bins, 180.0)
    hnu = PLANCK_UEV_PER_GHZ * 5.0
    want = mattis_bardeen_conductivity(f_avg, e_bins, 180.0, hnu)
    got = mattis_bardeen_conductivity_traced(torch.as_tensor(f_avg, device="cuda"), e_bins, 180.0, hnu)
    for i, (a, b) in enumerate(zip(got, want)):
        check(f"10d σ{i + 1} differentiable (card) vs numpy", abs(float(a) - b) / abs(b), 1e-10)


def phase_slice_repairs() -> None:
    print("== 10e the repairs: 'auto' launches K10 on the card; kernel wrappers refuse gradients", flush=True)
    from qpsim_tpu_torch.ops import adi_cuda, collisions_cuda, tridiag_cuda as k10
    from qpsim_tpu_torch.ops.tridiag import get_default_solver, tridiag_solve

    if get_default_solver() != "auto":
        raise AssertionError("10e: the default solver must be 'auto'")
    system = tridiag_case("rows", 1, 100, 64, F32, kind="dominant")
    reset_counts()
    x = tridiag_solve(*system)
    torch.cuda.synchronize()
    check_counts("10e tridiag_solve under 'auto' on CUDA tensors", read_counts(),
                 {"thomas": 1, "thomas_backward": 0})
    check("10e 'auto' vs the plain Thomas sweep", scaled_err(x, k10.thomas_plain(*system)), TOL[("thomas", F32)])
    kern, _, plan, _, q, ph, gen = collision_setup(16, 32, F32)
    q.requires_grad_(True)
    for label, call in (("collision_step (K3)", lambda: kern(q, ph, 0.05, gen)),
                        ("adi_x_half (K2)", lambda: adi_cuda.adi_x_half(q, adi_planes(rectangle(32), F32)[0],
                                                                        0.025))):
        reset_counts()
        try:
            call()
        except RuntimeError as e:
            if "no backward" not in str(e):
                raise
            print(f"  {label} with an input that requires grad: RuntimeError: {str(e)[:110]}…")
        else:
            raise AssertionError(f"10e: {label} took an input that requires grad")
        if any(read_counts().values()):
            raise AssertionError(f"10e: {label} launched while refusing")
    with torch.no_grad():
        kern(q, ph, 0.05, gen)
    if read_counts()["collision_step"] != 1:
        raise AssertionError("10e: under no_grad the wrapper must launch")


def phase_slice(card: str, main: dict) -> list[dict]:
    """Phase 10: the slice of observables, the qubit model, differentiable
    simulation and film ensembles, at the sizes its users run."""
    t0 = time.perf_counter()
    rows = timed_phase(phase_slice_diff, card)
    timed_phase(phase_slice_fits, card)
    rows += timed_phase(phase_slice_ensembles, card)
    timed_phase(phase_slice_qubit_observables, card, main)
    timed_phase(phase_slice_repairs)
    print(f"  phase 10: {time.perf_counter() - t0:.1f} s", flush=True)
    return rows


# ---------------------------------------------------------------- phase 11


#: the float32 tier of docs/f32_tiers.md: what float32 adds to a run's error (≤ 2e-3)
F32_TIER = 2e-3


def beyond_kwargs(n, ne, steps, **extra):
    """Phase 4's physics at ``ne`` bins on the n² rectangle, ``steps`` steps of
    0.05 ns stored at the start, the middle and the end, the pulse on from
    t = 0 (so the mass rises within the run), light snapshots."""
    from qpsim_tpu_torch.models.params import ExternalGenerationSpec

    gen = ExternalGenerationSpec(mode="pulse", pulse_start=0.0, pulse_duration=1.0, pulse_rate=1e-5)
    # pixel_chunk bounds the plain version's (chunk, NE, NE) pair tensors (2 GiB
    # in float64 at 512 bins); the kernels do not read it
    return dict(main_path_kwargs(n), num_energy_bins=ne, dt=0.05, total_time=0.05 * steps,
                store_every=max(1, steps // 2), external_generation=gen, pixel_chunk=1024, **extra)


def beyond_run(label: str, kw: dict, collision: str, device_form: bool, card: str):
    """One call of the coupled path with exact launch counts per form: its
    result, the collision launches and ms/step (whole call, CUDA events)."""
    from qpsim_tpu_torch.solver.stepping import _plan_segments, _split_time

    full, rem, _ = _split_time(kw["total_time"], kw["dt"])
    segments = _plan_segments(full, rem, kw["dt"], kw["store_every"])
    steps = sum(s.length for s in segments)
    expect = coupled_expect(segments, collision)
    expect["column_walk_device"] = expect[collision] if device_form else 0
    if kw["mask"].sum() <= 4096:
        expect.update(adi_x_half=0, adi_y_half=0)  # the dense backend
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out, (steady, set_up, whole) = timed_run(kw, steps)
    wall = time.perf_counter() - t0
    counts = read_counts()
    got = {k: counts[k] for k in expect}
    print(f"  {label}: launches {got}", flush=True)
    if got != expect:
        raise AssertionError(f"{label}: launch counts {got} != {expect}")
    check_frames(out[1], kw["mask"])
    if not out[2][-1] > out[2][0]:
        raise AssertionError(f"{label}: mass must rise during the pulse: {out[2]}")
    print(f"  {label}: steady {steady:.3f} ms/step over {steps} steps (host clock, first to last stored "
          f"frame); set-up {set_up:.2f} s; whole call {whole / 1e3:.2f} s (CUDA events); peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; mass {out[2]} — {card}", flush=True)
    return out, counts[collision]


def beyond_row(name: str, kind: str, ne: int, dtype, launches: int, *, n: int, plain_n: int, tol: float,
               line: int = 930, dt: float = 0.05) -> dict:
    """A kernels-line row for K5/K6 beyond 256 bins: the kernel held against its
    plain version on plain_n² (the plain version's time grows with the
    pixels); the kernel timed on n², the shape its bound is reckoned on.
    Each is one call timed with CUDA events: the same kernel at the same
    bins has run in this phase's engine call, and one call at these bins
    takes tens of ms to seconds."""
    from qpsim_tpu_torch.ops.column_walk import column_form

    kern, plain, plan, tensors, q, ph, gen = collision_setup(ne, plain_n, dtype, kind=kind, blocked=True,
                                                             pixel_chunk=512)
    ref, plain_once = timed_once(lambda: plain(q, ph, dt, gen))
    got, small_ms = timed_once(lambda: kern(q, ph, dt, gen))
    label = f"{name} NE={ne} {plain_n}² {str(dtype)[6:]} ({column_form(dtype, ne)} form)"
    check(f"{label}, q", scaled_err(got[0], ref[0]), tol)
    check(f"{label}, ph", scaled_err(got[1], ref[1]), tol)
    err = max(abs_err(got[0], ref[0]), abs_err(got[1], ref[1]))
    ms = small_ms
    if n != plain_n:
        del kern, plain, plan, tensors, q, ph, gen, ref, got
        torch.cuda.empty_cache()
        kern, _, plan, tensors, q, ph, gen = collision_setup(ne, n, dtype, kind=kind, blocked=True)
        ms = timed_once(lambda: kern(q, ph, dt, gen))[1]
    b = bound(*collision_work(plan, q, ph, gen, tensors, analytic=kind == "analytic"), dtype)
    del kern, plan, tensors, q, ph, gen
    torch.cuda.empty_cache()
    return dict(name=name, route="cuda", source="qpsim_tpu_torch/csrc/offset_walk.cu",
                replaces=f"qpsim_tpu/ops/pallas_collisions_blocked.py:{line}", launches=launches,
                max_abs_err=err, ms=ms, plain_ms=plain_once, **b, library_ms=None,
                shape=f"{n}² × {ne}, {str(dtype)[6:]}", form=column_form(dtype, ne),
                plain_shape=f"{plain_n}²", ms_at_plain_shape=small_ms, timing="events, one call")


def phase_beyond_256(card: str) -> list[dict]:
    """Phase 11 (a)–(e): more than 256 bins on the card, the column walk's
    staged and device-memory forms."""
    import qpsim_tpu_torch
    from qpsim_tpu_torch.ops.collisions_blocked_cuda import build_column_tables
    from qpsim_tpu_torch.ops.column_walk import column_form, launch_column_walk

    run = qpsim_tpu_torch.run_2d_crank_nicolson
    print("== 11a the flagship physics at 1024² × 512 bins (NW 1535), float32, staged form: 2 steps "
          "(cut from 10 to make room for phase 13)", flush=True)
    assert column_form(F32, 512) == "staged" and column_form(F64, 512) == "device"
    assert column_form(F32, 1024) == "device"
    _, k5_512 = beyond_run("1024² × 512", beyond_kwargs(1024, 512, 2, snapshot_detail="integrated"),
                           "collision_step_blocked", False, card)
    # held against the plain path at 96² (K2 on both sides; at ≤ 4096 cells
    # the dense backend's set-up factorises one 4096² operator per bin)
    kw = beyond_kwargs(96, 512, 10)
    a, _ = beyond_run("96² × 512 kernels", kw, "collision_step_blocked", False, card)
    assert_runs_close("96² × 512, float32: kernels vs plain", a, run(**kw, collision_backend="plain"),
                      blocked_tol(F32, 512), blocked_tol(F32, 512))
    rows = [beyond_row("collision_step_blocked_512", "uniform", 512, F32, k5_512, n=1024, plain_n=256,
                       tol=blocked_tol(F32, 512))]

    print("== 11b 512 bins in float64 (device-memory form) at 128², 6 steps, against the plain path",
          flush=True)
    kw = beyond_kwargs(128, 512, 6, dtype=F64)
    a, k5_f64 = beyond_run("128² × 512 float64", kw, "collision_step_blocked", True, card)
    assert_runs_close("128² × 512, float64: kernels vs plain", a, run(**kw, collision_backend="plain"),
                      1e-10, 1e-12)
    rows.append(beyond_row("collision_step_blocked_device_512_f64", "uniform", 512, F64, k5_f64,
                           n=128, plain_n=128, tol=1e-10))

    print("== 11c 256² × 1024 bins (NW 3071), float32 (device-memory form): 2 steps", flush=True)
    _, k5_1024 = beyond_run("256² × 1024", beyond_kwargs(256, 1024, 2, snapshot_detail="integrated"),
                            "collision_step_blocked", True, card)
    rows.append(beyond_row("collision_step_blocked_device_1024", "uniform", 1024, F32, k5_1024,
                           n=128, plain_n=128, tol=F32_TIER))

    print("== 11d the staged and device-memory forms on the same float32 inputs: 256² × 512, the trap's ids",
          flush=True)
    _, _, plan, _, q, ph, gen = collision_setup(512, 256, F32, kind="trap", blocked=True)
    tables = build_column_tables(plan)
    forms = {}
    for form in ("staged", "device"):
        reset_counts()
        out = launch_column_walk(tables, q, ph, 0.05, gen, True, form=form)
        ms = time_ms(lambda: launch_column_walk(tables, q, ph, 0.05, gen, True, form=form), 2)
        forms[form] = (out, ms, read_counts()["column_walk_device"])
    (qs, ps), ms_s, n_s = forms["staged"]
    (qd, pd), ms_d, n_d = forms["device"]
    same = bool(torch.equal(qs, qd) and torch.equal(ps, pd))
    check("11d device-memory form vs staged, q", scaled_err(qd, qs), blocked_tol(F32, 512))
    check("11d device-memory form vs staged, ph", scaled_err(pd, ps), blocked_tol(F32, 512))
    if (n_s, n_d) != (0, 4):
        raise AssertionError(f"11d column_walk_device counted {n_s} (staged) and {n_d} (device), not 0 and 4")
    print(f"  11d bit-equal: {same}; staged {ms_s:.3f} ms, device-memory {ms_d:.3f} ms "
          f"({ms_d / ms_s:.2f}x; events over 2 calls) — float32, {card}", flush=True)
    del plan, tables, q, ph, gen, forms, qs, ps, qd, pd
    torch.cuda.empty_cache()

    print("== 11e the trap map (K5 gap ids) and a continuous map (K6) at 256² × 300 bins, 6 steps "
          "(a map's per-pixel D(E, x) fold takes 18–22 s of set-up at 512² × 300)", flush=True)
    launched = {}
    for map_name, collision in (("trap", "collision_step_blocked_gid"),
                                ("gradient", "collision_step_blocked_analytic")):
        kw = beyond_kwargs(256, 300, 6, gap_expression=GAP_MAPS_100[map_name], snapshot_detail="integrated")
        _, launched[map_name] = beyond_run(f"{map_name} 256² × 300", kw, collision, False, card)
    rows.append(beyond_row("collision_step_blocked_gid_300_trap_ids", "trap", 300, F32, launched["trap"],
                           n=256, plain_n=256, tol=blocked_tol(F32, 300)))
    rows.append(beyond_row("collision_step_blocked_analytic_300", "analytic", 300, F32,
                           launched["gradient"], n=256, plain_n=256, tol=blocked_tol(F32, 300), line=972))
    print_rows(rows, "beyond 256 bins", card, "each row's shape")
    return rows


def run_module(*args) -> subprocess.CompletedProcess:
    """``python -m qpsim_tpu_torch <args>`` from the checkout root, its output captured."""
    from pathlib import Path

    return subprocess.run([sys.executable, "-m", "qpsim_tpu_torch", *args], capture_output=True, text=True,
                          timeout=600, cwd=Path(__file__).resolve().parent)


def phase_cli(card: str, tmp) -> dict:
    """Phase 11 (f): the command line on the card; returns the float32 suite's K3 launches by bins."""
    from qpsim_tpu_torch import cli
    from qpsim_tpu_torch.io.storage import load_simulation, load_test_suite, save_setup
    from qpsim_tpu_torch.io.stream import load_frame_stream

    print("== 11f the command line: info and validate --json as subprocesses, then run, profile, "
          "gen-tests and qubit-sweep in process", flush=True)
    info = run_module("info")
    print("  " + info.stdout.strip().replace("\n", "\n  "))
    name = torch.cuda.get_device_name(0)
    if info.returncode != 0 or name not in info.stdout or "kernel library: built" not in info.stdout:
        raise AssertionError(f"11f info: rc {info.returncode}, {info.stderr[-500:]}")
    t0 = time.perf_counter()
    val = run_module("validate", "--json")
    if val.returncode != 0 or not json.loads(val.stdout)["overall_passed"]:
        raise AssertionError(f"11f validate --json: rc {val.returncode}, {val.stderr[-500:]}")
    print(f"  validate --json (float32 on the card, a subprocess): rc 0, overall_passed in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    setup_path = save_setup(flagship_setup(1024, steps=40, store_every=20), tmp / "flagship.json")
    argv = ["run", str(setup_path), "--output", str(tmp / "sim.json"), "--stream-dir", str(tmp / "stream"),
            "--checkpoint-dir", str(tmp / "ck")]
    reset_counts()
    t0 = time.perf_counter()
    if cli.main(argv) != 0:
        raise AssertionError("11f run: non-zero exit")
    check_counts(f"11f run 1024² × 16, 40 steps, streamed and checkpointed ({time.perf_counter() - t0:.1f} s)",
                 read_counts(), {"collision_step": 42, "collision_step_with_gen": 40, "adi_x_half": 40,
                                 "adi_y_half": 40, "column_walk_device": 0})
    stream = load_frame_stream(tmp / "stream")
    if stream.count != 3 or load_simulation(tmp / "sim.json").metadata.get("streamed_frames_dir") is None:
        raise AssertionError("11f run: expected 3 streamed frames and a result that points at them")

    # profile's two run_setup calls keep full-detail frames as JSON-ready
    # lists (≈ 20 s a 1024² × 16 frame on the host): it profiles a 256² film
    small_path = save_setup(flagship_setup(256, steps=20, store_every=20), tmp / "flagship256.json")
    reset_counts()
    t0 = time.perf_counter()
    if cli.main(["profile", str(small_path), "--steps", "20", "--trace-dir", str(tmp / "trace")]) != 0:
        raise AssertionError("11f profile: non-zero exit")
    trace = (tmp / "trace" / "trace.json").read_text()
    kernels = {k: k in trace for k in ("collision_step_kernel", "adi_kernel")}
    print(f"  11f profile 256² × 16 --steps 20 --trace-dir: {time.perf_counter() - t0:.1f} s; trace.json "
          f"{len(trace) / 2**20:.1f} MiB names the CUDA kernels {kernels}; launches {read_counts()['collision_step']} "
          "K3 over the two runs", flush=True)
    if not all(kernels.values()):
        raise AssertionError(f"11f profile: the trace must name the CUDA kernels: {kernels}")

    reset_counts()
    t0 = time.perf_counter()
    with launches_by_bins() as seen:
        if cli.main(["gen-tests", "--output", str(tmp / "suite.json")]) != 0:
            raise AssertionError("11f gen-tests: non-zero exit")
    suite = load_test_suite(tmp / "suite.json")
    worst = suite_errors(suite)
    expect = {("collision_step", 1): 5000, ("collision_step", 10): 2000, ("collision_step", 15): 4000}
    if seen != expect:
        raise AssertionError(f"11f gen-tests: K3 launches by bins {seen}, expected {expect}")
    check_counts("11f gen-tests: no K1/K2 (every film ≤ 4096 cells runs the dense backend, as the JAX "
                 "package's 'auto' picks)", read_counts(),
                 {"collision_step": 11000, "collision_step_with_gen": 0, "adi_sep_x": 0, "adi_sep_y": 0,
                  "adi_x_half": 0, "adi_y_half": 0})
    print(f"  11f gen-tests (float32, the defaults): 28 cases in {time.perf_counter() - t0:.1f} s, written and "
          f"loaded back; K3 launches by bins { {ne: n for (_, ne), n in seen.items()} }; worst gated errors "
          + ", ".join(f"{cid} {err:.2e}" for cid, err in worst.items()) + f" — {card}", flush=True)

    rows = {}
    for device in ("cuda", "cpu"):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["qubit-sweep", "--json", "--device", device])
        if rc != 0:
            raise AssertionError(f"11f qubit-sweep --device {device}: rc {rc}")
        rows[device] = json.loads(buf.getvalue())
    err = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-300) for a, b in zip(rows["cuda"], rows["cpu"])
              for k in ("x_L", "p1", "parity_hz"))
    check(f"11f qubit-sweep --json: {len(rows['cuda'])} temperatures, card vs CPU", err, 1e-10)
    return {ne: n for (_, ne), n in seen.items()}


def phase_ui_worker(card: str) -> None:
    """Phase 11 (g): the GUI's run worker drives run_setup on the card, without Tk."""
    from qpsim_tpu_torch.runner import run_setup
    from qpsim_tpu_torch.ui.run_worker import SimulationWorker

    print("== 11g ui.run_worker on the card: 256² × 16, 40 steps, no Tk", flush=True)
    if "tkinter" in sys.modules:
        raise AssertionError("11g: importing the run worker must not import tkinter")
    setup = flagship_setup(256, steps=40, store_every=10)
    reset_counts()
    worker = SimulationWorker(setup=setup, save=False, device="cuda")
    t0 = time.perf_counter()
    worker.start()
    worker.join(300)
    if worker.is_running():
        raise AssertionError("11g worker: not finished within 300 s")
    kind, payload = worker.result.get_nowait()
    if kind != "ok":
        raise AssertionError(f"11g worker: {payload!r}")
    live = worker.drain_live()
    counts = read_counts()
    check_counts(f"11g worker ({time.perf_counter() - t0:.1f} s, {len(live)} live frames)", counts,
                 {"collision_step": 44, "collision_step_with_gen": 40, "adi_x_half": 40, "adi_y_half": 40})
    result, _ = payload
    direct, _ = run_setup(setup, save=False)
    if result.times != direct.times or len(live) != 5:
        raise AssertionError("11g worker: stored times or live frames differ from a direct run")
    np.testing.assert_array_equal(result.mass_over_time, direct.mass_over_time)
    print("  11g the worker's result is bit-equal to a direct run_setup on the card (mass, stored times)",
          flush=True)


def phase_beyond_and_cli(card: str, validation_bins: dict) -> list[dict]:
    """Phase 11: more than 256 bins, the command line (with the analytic
    suite's small-cell K3 rows) and the GUI's run worker."""
    import tempfile
    from pathlib import Path

    t0 = time.perf_counter()
    rows = timed_phase(phase_beyond_256, card)
    tmp = Path(tempfile.mkdtemp(prefix="qpsim_smoke11_"))
    try:
        suite_bins = timed_phase(phase_cli, card, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rows += suite_rows(card, suite_bins, validation_bins)
    timed_phase(phase_ui_worker, card)
    print(f"  phase 11: {time.perf_counter() - t0:.1f} s", flush=True)
    return rows


# ---------------------------------------------------------------- phase 12: sharding


#: the sharded runs' shard count on one card (4 cells on cuda:0)
SHARDS = 4


def card_mesh(k: int = SHARDS):
    """A local mesh of ``k`` shards, every one on card 0."""
    from qpsim_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(n_space=k, devices=[torch.device("cuda", 0)] * k)


def zero_counts() -> dict:
    return {k: 0 for k in read_counts()}


def sharded_expect(collision: str, steps: int, *, k: int = SHARDS, gen: bool = True,
                   segments=None) -> dict:
    """Exact launch counts of a mesh run on ``k`` shards: per shard two
    collision substeps a step (exact Strang) or L + 1 a segment of L > 1
    steps (merged), the dt·g plane fused into one a step; two K7 launches
    a step (the x half, and the pencil y half or the Wang local solve)."""
    per = 2 * steps if segments is None else sum(s.length + 1 if s.length > 1 else 2 for s in segments)
    return zero_counts() | {collision: k * per, f"{collision}_with_gen": k * steps if gen else 0,
                            "adi_lines": 2 * k * steps}


def runs_close(label: str, a, b, tol: float) -> None:
    """Stored times equal; frames and mass within ``tol`` (scaled max errors)."""
    if a[0] != b[0]:
        raise AssertionError(f"{label}: stored times differ: {a[0]} != {b[0]}")
    check(f"{label}, frames", max(scaled_err_np(fa, fb) for fa, fb in zip(a[1], b[1])), tol)
    check(f"{label}, mass", float(np.max(np.abs(np.subtract(a[2], b[2])) / np.abs(b[2]))), tol)


def counted_run(label: str, kw: dict, expect: dict | None = None):
    """One engine call: its result, launch counts, stored-frame stamps and start time."""
    import qpsim_tpu_torch

    stamps: list[float] = []
    reset_counts()
    t0 = time.perf_counter()
    out = qpsim_tpu_torch.run_2d_crank_nicolson(**kw, progress_callback=stamp_into(stamps))
    torch.cuda.synchronize()
    counts = read_counts()
    if expect is not None:
        check_counts(label, counts, expect)
    return out, counts, stamps, t0


def sharded_flagship(mesh, n: int, ne: int, dtype, *, y_solve: str, gen: bool = True):
    """Phase 4's physics as a bare ``ShardedStep`` on ``mesh`` (n² × ne, E_max
    4Δ, D(E) lazily scaled above the budget), with its shards of a random state."""
    from qpsim_tpu_torch.ops.diffusion import build_directional_stencils, fold_diffusion
    from qpsim_tpu_torch.ops.dos import (diffusion_coefficient_of_energy, dynes_density_of_states,
                                         thermal_phonon_occupation)
    from qpsim_tpu_torch.ops.kernels import recombination_kernel_base, scattering_kernel_base
    from qpsim_tpu_torch.parallel.sharded import build_sharded_step

    mask, edges, bcs = rectangle(n)
    E, dE, pm = phonon_map(ne, 4.0)
    xs, ys = build_directional_stencils(mask, edges, bcs, 1.0)
    op = fold_diffusion(xs, ys, mask, 1.0, diffusion_coefficient_of_energy(6.0, E, 180.0))
    col = dict(dE=dE, rho=dynes_density_of_states(E, 180.0, 0.0), K_r0=recombination_kernel_base(E, 180.0, 440.0, 1.2),
               K_s0=scattering_kernel_base(E, 180.0, 440.0, 1.2), pmap=pm, enable_recombination=True,
               enable_scattering=True, update_phonons=True)
    sh = build_sharded_step(mesh, op, 0.05, collisions=col, dtype=dtype, y_solve=y_solve, gen_input=gen)
    rng = np.random.default_rng(12)
    rho = dynes_density_of_states(E, 180.0, 0.0)
    q = sh.shard(rng.uniform(0, 2e-3, (ne, *mask.shape)) * rho[:, None, None], dtype)
    ph = sh.shard(np.broadcast_to(thermal_phonon_occupation(pm.omega_bins, 0.1)[:, None, None],
                                  (pm.num_omega, *mask.shape)), dtype)
    grow = sh.shard(rng.uniform(0, 1e-6, mask.shape), dtype) if gen else None
    return sh, q, ph, grow


def step_split(sh, q, ph, grow, label: str, card: str) -> None:
    """Where a sharded step's time goes: CUDA-event ms/step, the profiler's
    device time by kind (the port's kernels, copies and concatenations —
    the exchange's halo rows, pencils and interface rows and the layout
    swaps —, other torch glue), the device's idle share, and the host's
    time inside the exchange's calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    args = (grow,) if grow is not None else ()
    ex = sh.mesh.exchange
    host = {"s": 0.0}
    originals = {}
    for name in ("halo", "all_gather", "all_to_all", "psum"):
        fn = getattr(ex, name)
        originals[name] = fn

        def timed(*a, _fn=fn, **k):
            t0 = time.perf_counter()
            try:
                return _fn(*a, **k)
            finally:
                host["s"] += time.perf_counter() - t0

        setattr(ex, name, timed)
    try:
        state = [q, ph]

        def one():
            state[0], state[1], _ = sh.step(state[0], state[1], *args)

        step_ms = time_ms(one, 5)
        exchange_ms = 1e3 * host["s"] / 6  # the warm-up call and the 5 timed ones
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            one()  # the profiler's own start-up, outside the window read
            torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                one()
            torch.cuda.synchronize()
    finally:
        for name, fn in originals.items():
            setattr(ex, name, fn)
    kinds = {"kernels": 0.0, "copies": 0.0, "glue": 0.0}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        name = e.key
        if any(k in name for k in ("collision_step_kernel", "column_walk_kernel", "adi_lines_kernel")):
            kind = "kernels"
        elif any(k in name.lower() for k in ("copy", "memcpy", "cat")):
            kind = "copies"
        else:
            kind = "glue"
        kinds[kind] += e.self_device_time_total / 1e3 / 5
    busy = sum(kinds.values())
    print(f"  {label}: {step_ms:.3f} ms/step (CUDA events, 5 steps, not profiled); device time a step "
          f"(profiler, 5 steps): kernels {kinds['kernels']:.3f} ms, copies {kinds['copies']:.3f} ms, glue "
          f"{kinds['glue']:.3f} ms, busy {busy:.3f} of {step_ms:.3f} ms ({busy / step_ms:.3f}); host inside "
          f"the exchange's calls {exchange_ms:.3f} ms/step — {card}", flush=True)


def sharded_line_row(name: str, rhs, lo, di, hi, scale, launches: int, card: str) -> dict:
    """A K7 row at a sharded path's shapes: one shard's solve, held to its plain version."""
    from qpsim_tpu_torch.ops.adi_cuda import solve_lines, solve_lines_plain

    alpha = 0.025
    got = solve_lines(rhs, lo, di, hi, scale, alpha=alpha)
    ref, plain_ms = timed_once(lambda: solve_lines_plain(rhs, lo, di, hi, scale, alpha=alpha))
    torch.cuda.synchronize()
    tag = f"{name} {tuple(rhs.shape)} (NB, N, lines) float32"
    check(tag, scaled_err(got, ref), TOL[("adi_lines", F32)])
    row = dict(
        name=name, route="cuda", source="qpsim_tpu_torch/csrc/adi_lines.cu",
        replaces="qpsim_tpu/ops/pallas_adi.py:131", launches=launches, max_abs_err=abs_err(got, ref),
        ms=time_ms(lambda: solve_lines(rhs, lo, di, hi, scale, alpha=alpha), 20), plain_ms=plain_ms,
        **bound(nbytes(rhs, rhs, lo, di, hi, scale), 8 * rhs.numel(), F32), library_ms=None,
    )
    print(f"  {tag}: kernel {row['ms']:.4f} ms, plain {plain_ms:.3f} ms, bound {row['bound_ms']:.4f} ms "
          f"({row['bound_by']}), {launches} launches on the sharded path — {card}", flush=True)
    return row


def call_time_row(name: str, ne: int, shape, launches: int, card: str, emax: float) -> dict:
    """K4 (NE ≤ 64) or K6 with a shard's gap plane passed at call time, held
    to the plain version on the same inputs, at one shard's shape."""
    from qpsim_tpu_torch.ops.collisions_cuda import build_collision_step_analytic
    from qpsim_tpu_torch.ops.dos import dynes_density_of_states, thermal_phonon_occupation

    E, dE, pm = phonon_map(ne, emax)
    rng = np.random.default_rng(5)
    low = 150.0 if ne > 64 else 170.0
    plane = torch.as_tensor(rng.uniform(low, low + 22.0, shape), dtype=F32, device="cuda")
    step = build_collision_step_analytic(E_bins=E, dE=dE, gap_plane=None, pmap=pm, dt=0.025, tau_s=440.0,
                                         tau_r=440.0, T_c=1.2, device="cuda", dtype=F32)
    rho = torch.as_tensor(dynes_density_of_states(E, low + 22.0, 0.0), dtype=F32, device="cuda")
    q = torch.rand((ne, *shape), device="cuda", dtype=F32) * 2e-3 * rho[:, None, None]
    ph = torch.as_tensor(thermal_phonon_occupation(pm.omega_bins, 0.25), dtype=F32,
                         device="cuda")[:, None, None].expand(pm.num_omega, *shape).contiguous()
    gen = torch.rand(shape, device="cuda", dtype=F32) * 1e-6
    got = step(q, ph, plane, gen)
    ref, plain_ms = timed_once(lambda: step.plain(q, ph, plane, gen))
    torch.cuda.synchronize()
    tol = blocked_tol(F32, ne) if ne > 64 else TOL[("collision_step_analytic", F32)]
    tag = f"{name} NE={ne} {shape[0]}×{shape[1]} (one shard) float32, call-time gap plane"
    check(f"{tag}, q", scaled_err(got[0], ref[0]), tol)
    check(f"{tag}, ph", scaled_err(got[1], ref[1]), tol)
    g2 = plane.reshape(-1) ** 2
    tensors = kernel_tensors(step.tables, g2, step.analytic.E, step.analytic.inv_E, step.analytic.e2,
                             step.analytic.zi)
    if ne > 64:
        tensors = [*tensors, g2]
    row = dict(
        name=name, route="cuda",
        source=f"qpsim_tpu_torch/csrc/{'offset_walk.cu' if ne > 64 else 'collisions.cu'}",
        replaces=("qpsim_tpu/ops/pallas_collisions_blocked.py:972" if ne > 64
                  else "qpsim_tpu/ops/pallas_collisions.py:429"),
        launches=launches, max_abs_err=max(abs_err(got[0], ref[0]), abs_err(got[1], ref[1])),
        ms=time_ms(lambda: step(q, ph, plane, gen), 5 if ne > 64 else 20), plain_ms=plain_ms,
        **bound(*collision_work(step.plan, q, ph, gen, tensors, analytic=True), F32), library_ms=None,
    )
    print(f"  {tag}: kernel {row['ms']:.4f} ms (Δ² formed per call), plain {plain_ms:.3f} ms, bound "
          f"{row['bound_ms']:.4f} ms ({row['bound_by']}), {launches} launches on the sharded path — {card}",
          flush=True)
    return row


def phase_sharding(card: str) -> list[dict]:
    print(f"== 12 sharding on the card: {SHARDS} shards of one H100 (make_mesh with the card repeated)",
          flush=True)
    from qpsim_tpu_torch.solver.stepping import _plan_segments, _split_time

    dt = 0.05
    mesh = card_mesh()
    rows: list[dict] = []

    # (a) the flagship, 1024² × 16, float32, 15 exact steps (integrated
    # snapshots every 5: the steady state is read from the 2nd to the 4th)
    steps, every = 15, 5
    kw = dict(main_path_kwargs(1024), dt=dt, total_time=dt * steps, store_every=every, strang_mode="exact",
              snapshot_detail="integrated")
    single, _, st, t0 = counted_run("(a) single device", kw)
    steady = {"single device (K3, K2)": (1e3 * (st[-1] - st[1]) / (steps - every), st[0] - t0)}
    counts_a = {}
    for y in ("wang", "pencil"):
        out, counts_a[y], st, t0 = counted_run(
            f"(a) 1024² × 16 on {SHARDS} shards, y solve {y}", dict(kw, mesh=mesh, mesh_y_solve=y),
            sharded_expect("collision_step", steps))
        check_frames(out[1], kw["mask"])
        runs_close(f"(a) {y} on {SHARDS} shards vs single device, float32", out, single, 1e-5)
        steady[f"{SHARDS} shards, {y}"] = (1e3 * (st[-1] - st[1]) / (steps - every), st[0] - t0)
    for label, (ms, setup) in steady.items():
        print(f"  (a) {label}: steady {ms:.3f} ms/step (host clock, 10 steps and 2 integrated snapshots); "
              f"set-up {setup:.3f} s — 1024² × 16 float32, {card}", flush=True)
    # where a sharded step's time goes (a bare ShardedStep, generation fused)
    for y in ("wang", "pencil"):
        sh, q, ph, grow = sharded_flagship(mesh, 1024, 16, F32, y_solve=y)
        step_split(sh, q, ph, grow, f"(a) split of one sharded step, {y}, 1024² × 16 on {SHARDS} shards", card)
        try:  # no fallback: a shard off its cell's device is refused
            sh.step([t.cpu() for t in q], ph, grow)
        except ValueError as err:
            print(f"  (a) CPU shards on the card's mesh refused: {err}", flush=True)
        else:
            raise AssertionError("(a) a CPU shard on a CUDA mesh must raise")
        if y == "pencil":
            raw = sh.aux[0]
            u = torch.rand((16, 256, 1024), device="cuda", dtype=F32)
            scale = raw["scale"][0]
            rows.append(sharded_line_row("adi_lines_sharded_x", u.transpose(-1, -2).contiguous(),
                                         raw["axlT"][0], raw["axdT"][0], raw["axhT"][0], scale,
                                         counts_a["pencil"]["adi_lines"] // 2, card))
            rows.append(sharded_line_row("adi_lines_sharded_y_pencil", torch.rand((16, 1024, 256), device="cuda",
                                                                                 dtype=F32),
                                         raw["aylC"][0], raw["aydC"][0], raw["ayhC"][0], scale,
                                         counts_a["pencil"]["adi_lines"] // 2, card))
            rows.append(sharded_line_row("adi_lines_sharded_wang_local", torch.rand((48, 256, 1024), device="cuda",
                                                                                   dtype=F32),
                                         raw["ayl"][0], raw["ayd"][0], raw["ayh"][0], scale.repeat(3),
                                         counts_a["wang"]["adi_lines"] // 2, card))
        del sh, q, ph, grow
    torch.cuda.empty_cache()

    # (b) float64 at 256² × 16 on 4 shards against the single-device float64
    # engine; the lazy Wang branch; K7's local solves against the recurrences
    kw64 = dict(main_path_kwargs(256), dt=dt, total_time=0.5, store_every=5, strang_mode="exact", dtype=F64)
    single64 = counted_run("(b) single device float64", kw64)[0]
    for y in ("wang", "pencil"):
        out = counted_run(f"(b) 256² × 16 float64, {y}", dict(kw64, mesh=mesh, mesh_y_solve=y),
                          sharded_expect("collision_step", 10))[0]
        runs_close(f"(b) {y} on {SHARDS} shards vs single device, float64", out, single64, 1e-10)
    from qpsim_tpu_torch.solver.diffusion_backends import ADIDiffusion

    budget = ADIDiffusion.MATERIALIZE_MAX_ELEMENTS
    try:
        ADIDiffusion.MATERIALIZE_MAX_ELEMENTS = 0  # the lazy scale: Wang unfactored, D, A, C on K7
        out = counted_run("(b) lazy scale, wang", dict(kw64, mesh=mesh, mesh_y_solve="wang"),
                          sharded_expect("collision_step", 10))[0]
        runs_close(f"(b) lazy wang on {SHARDS} shards vs single device, float64", out, single64, 1e-10)
        for lazy in (False, True):
            ADIDiffusion.MATERIALIZE_MAX_ELEMENTS = 0 if lazy else budget
            for y in ("wang", "pencil"):
                got = {}
                for backend in ("pallas", "xla"):
                    sh, q, ph = sharded_flagship_backend(mesh, y, backend)
                    for _ in range(3):
                        q, ph, _m = sh.step(q, ph)
                    got[backend] = sh.gather(q)
                check(f"(b) {y}{' (lazy)' if lazy else ''} float64 256² × 16, 3 steps: K7 local solves vs the "
                      "recurrences and K10", scaled_err(got["pallas"], got["xla"]), 1e-10)
    finally:
        ADIDiffusion.MATERIALIZE_MAX_ELEMENTS = budget

    # (c) gap maps: a continuous map at 1024² × 16 through K4 with call-time
    # planes; 512² × 100, the map through K6 with call-time planes, and a
    # uniform gap through K5; each against its single-device run
    counts_c = {}
    for label, n, ne, gmap, collision in (
            ("gradient 1024² × 16", 1024, 16, GAP_MAPS["gradient"], "collision_step_analytic"),
            ("gradient 512² × 100", 512, 100, GAP_MAPS_100["gradient"], "collision_step_blocked_analytic"),
            ("uniform 512² × 100", 512, 100, "", "collision_step_blocked")):
        n_steps = 4 if ne <= 64 else 2
        kw_c = dict(main_path_kwargs(n), num_energy_bins=ne, dt=dt, total_time=dt * n_steps, store_every=n_steps,
                    strang_mode="exact", snapshot_detail="integrated", gap_expression=gmap)
        ref = counted_run(f"(c) {label} single device", kw_c)[0]
        out, counts_c[label], _, _ = counted_run(f"(c) {label} on {SHARDS} shards", dict(kw_c, mesh=mesh),
                                                 sharded_expect(collision, n_steps))
        runs_close(f"(c) {label} on {SHARDS} shards vs single device, float32", out, ref, 1e-5)
    rows.append(call_time_row("collision_step_analytic_call_time", 16, (256, 1024),
                              counts_c["gradient 1024² × 16"]["collision_step_analytic"], card, 4.0))
    rows.append(call_time_row("collision_step_blocked_analytic_call_time", 100, (128, 512),
                              counts_c["gradient 512² × 100"]["collision_step_blocked_analytic"], card, 4.0))
    torch.cuda.empty_cache()

    # (d) merged Strang with a constant generation fused into K3's gen input
    from qpsim_tpu_torch.models.params import ExternalGenerationSpec

    kw_d = dict(main_path_kwargs(256), dt=dt, total_time=0.5, store_every=5,
                external_generation=ExternalGenerationSpec(mode="constant", rate=1e-5))
    full, rem, _ = _split_time(kw_d["total_time"], dt)
    ref = counted_run("(d) single device, merged", kw_d)[0]
    out = counted_run(f"(d) merged, constant generation, 256² × 16 on {SHARDS} shards", dict(kw_d, mesh=mesh),
                      sharded_expect("collision_step", full, segments=_plan_segments(full, rem, dt, 5)))[0]
    runs_close(f"(d) merged on {SHARDS} shards vs single device, float32", out, ref, 1e-5)

    # (e) the distributed exchange on NCCL at world size 1 against the local exchange
    phase_sharding_nccl(card)

    # (f) the command line: --space-shards 1 runs on the card; 2 is refused on one card
    import tempfile
    from pathlib import Path

    from qpsim_tpu_torch import cli
    from qpsim_tpu_torch.io.storage import save_setup

    tmp = Path(tempfile.mkdtemp(prefix="qpsim_smoke12_"))
    try:
        path = tmp / "s.json"
        save_setup(flagship_setup(256, steps=10, store_every=5, name="shards"), path)
        for n, want in ((1, 0), (2, 2)):
            out_buf, err_buf = io.StringIO(), io.StringIO()
            reset_counts()
            with contextlib.redirect_stdout(out_buf), contextlib.redirect_stderr(err_buf):
                rc = cli.main(["run", str(path), "--space-shards", str(n), "--device", "cuda", "--no-save"])
            torch.cuda.synchronize()
            text = out_buf.getvalue() + err_buf.getvalue()
            print(f"  (f) run --space-shards {n}: exit {rc}; launches {read_counts()['collision_step']} "
                  f"collision_step, {read_counts()['adi_lines']} adi_lines; "
                  f"{' | '.join(text.strip().splitlines()[-3:])}", flush=True)
            if rc != want or (n == 1 and "space-sharded over 1 device(s)" not in text) or (
                    n == 2 and "exceeds the 1 available device(s)" not in text):
                raise AssertionError(f"(f) run --space-shards {n}: exit {rc}, expected {want}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print_rows(rows, "see above", card)
    return rows


def sharded_flagship_backend(mesh, y_solve: str, backend: str):
    """Phase 4's physics at 256² × 16 in float64 as a ShardedStep with ``tridiag_backend``."""
    from qpsim_tpu_torch.ops.diffusion import build_directional_stencils, fold_diffusion
    from qpsim_tpu_torch.ops.dos import diffusion_coefficient_of_energy
    from qpsim_tpu_torch.parallel.sharded import build_sharded_step

    mask, edges, bcs = rectangle(256)
    E, dE, pm = phonon_map(16, 4.0)
    xs, ys = build_directional_stencils(mask, edges, bcs, 1.0)
    op = fold_diffusion(xs, ys, mask, 1.0, diffusion_coefficient_of_energy(6.0, E, 180.0))
    sh = build_sharded_step(mesh, op, 0.05, dtype=F64, y_solve=y_solve, tridiag_backend=backend)
    q = sh.shard(np.random.default_rng(3).uniform(0, 1, (16, 256, 256)), F64)
    return sh, q, sh.shard(np.zeros((1, 256, 256)), F64)


def phase_sharding_nccl(card: str) -> None:
    """(e) ``initialize_distributed`` on a localhost port (NCCL, world size 1)
    and ``make_multihost_mesh``: the distributed exchange's step against the
    local exchange's with one shard, float64, both y solves."""
    import socket

    import torch.distributed as dist

    from qpsim_tpu_torch.parallel.mesh import initialize_distributed, make_mesh, make_multihost_mesh

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    initialize_distributed(f"127.0.0.1:{port}", 1, 0, timeout=120)
    try:
        print(f"  (e) process group: backend {dist.get_backend()}, world size {dist.get_world_size()}",
              flush=True)
        dist_mesh = make_multihost_mesh(n_space=1, n_ensemble=1)
        local = make_mesh(n_space=1, devices=[torch.device("cuda", 0)])
        for y in ("wang", "pencil"):
            got = []
            for mesh in (dist_mesh, local):
                sh, q, ph, grow = sharded_flagship(mesh, 256, 16, F64, y_solve=y)
                for _ in range(5):
                    q, ph, mass = sh.step(q, ph, grow)
                got.append((sh.gather(q), sh.gather(ph), mass))
            err = max(scaled_err(a, b) for a, b in zip(got[0], got[1]))
            same = all(torch.equal(a, b) for a, b in zip(got[0], got[1]))
            print(f"  (e) {y}: the NCCL exchange's 5 steps {'bit-equal to' if same else 'differ from'} the "
                  f"local exchange's (max rel err {err:.3e}), 256² × 16 float64 — {card}", flush=True)
            check(f"(e) {y} NCCL vs local exchange", err, 1e-12)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------- phase 13


#: each bench stage's payload keys, as the JAX bench names them (its two v5e
#: peak fractions become the H100 bound shares and what bounds them)
BENCH_KEYS = {
    "scalar_cn_1024": ("value", "vs_baseline"),
    "mkid_pulse": ("mkid_pulse_10k_steps_wallclock_s",),
    "coupled_full_scale": ("coupled_1024_ms_per_step", "coupled_1024_ms_per_step_exact_strang"),
    "rooflines": ("collision_substep_1024_ms", "collision_model_ops_per_s", "collision_bound_share",
                  "collision_bound_by", "adi_1024_ms_per_step", "adi_model_bytes_per_s", "adi_bound_share",
                  "adi_bound_by"),
    "sharded_overhead": ("sharded_1dev_ms_per_step", "sharded_wang_1dev_ms_per_step", "sharded_overhead_1dev",
                         "sharded_merged_1dev_ms_per_step"),
    "snapshot_overlap": ("engine_mkid_10k_store_sparse_s", "engine_mkid_10k_store_dense_s",
                         "engine_mkid_10k_store_dense_light_s", "snapshot_overlap_dense_over_sparse",
                         "snapshot_light_dense_over_sparse"),
    "collisions_100bin": ("collisions_100bin_ms_per_substep",),
    "collisions_50bin": ("collisions_50bin_ms_per_substep", "collisions_50bin_pixels_per_s"),
    "coupled_2d": ("coupled_2d_ms_per_step", "collision_pixels_per_s", "collision_vs_reference"),
    "masked_512": ("masked_512_cell_steps_per_s",),
    "analytic_gap": ("analytic_gap_ms_per_substep",),
    "analytic_gap_100bin": ("analytic_gap_100bin_ms_per_substep",),
    "coupled_1d_64bin": ("coupled_1d_64bin_ms_per_step", "coupled_1d_64bin_cell_steps_per_s"),
    "ensemble_sweep": ("ensemble_members", "ensemble_ms_per_step", "ensemble_member_steps_per_s"),
    "diff_grad": ("diffgrad_ms_per_step", "diffgrad_over_forward"),
}

#: phase 13a's cut lengths: each stage at its full width, a few steps
BENCH_CUTS = {
    "scalar_cn_1024": dict(length=10), "mkid_pulse": dict(total_steps=10),
    "coupled_full_scale": dict(length=3), "rooflines": dict(length=3, adi_length=3),
    "sharded_overhead": dict(length=3), "snapshot_overlap": dict(total_steps=20),
    "collisions_100bin": dict(length=2), "collisions_50bin": dict(length=3), "coupled_2d": dict(length=3),
    "masked_512": dict(length=10), "analytic_gap": dict(length=3), "analytic_gap_100bin": dict(length=2),
    "coupled_1d_64bin": dict(length=3), "ensemble_sweep": dict(length=3), "diff_grad": dict(n_steps=32, remat_chunk=16),
}


def bench_expect(name: str, kw: dict) -> dict:
    """Exact launch counts of one bench stage called with ``kw`` at full width.

    A timed stage runs a warm-up of W steps and two runs of L, s = W + 2L
    steps: C(dt/2) D C(dt/2) launches K3 twice a step; a merged chunk of k
    steps k + 1 times, its dt·g plane k times; K1/K2 one x and one y half
    a step; the ADI step of a wire one K10 launch (its y lines are single
    cells); an ensemble's two (x rows, y cols); the sharded step on one
    device two K7 (x, and the pencil y or the Wang local solve).
    """
    from qpsim_tpu_torch.bench import SNAPSHOT_RUNS, WARMUP_STEPS as w
    from qpsim_tpu_torch.solver.stepping import _plan_segments, _split_time

    length = kw.get("length", kw.get("total_steps", kw.get("n_steps")))
    s = w + 2 * length
    per = {
        "scalar_cn_1024": {"adi_sep_x": s, "adi_sep_y": s},
        "mkid_pulse": {"collision_step": 2 * s, "thomas": s},
        # exact: 2 a step, 1 with the plane; merged: chunks of W, L, L
        "coupled_full_scale": {"collision_step": 3 * s + 3, "collision_step_with_gen": 2 * s,
                               "adi_x_half": 2 * s, "adi_y_half": 2 * s},
        "rooflines": {"collision_step": s, "adi_sep_x": w + 2 * kw.get("adi_length", 0),
                      "adi_sep_y": w + 2 * kw.get("adi_length", 0)},
        # pencil, Wang, the plain coupled_2d denominator, merged pieces
        "sharded_overhead": {"collision_step": 7 * s + 3, "adi_lines": 6 * s, "adi_x_half": s, "adi_y_half": s},
        "collisions_100bin": {"collision_step_blocked": s},
        "collisions_50bin": {"collision_step": s},
        "coupled_2d": {"collision_step": 2 * s, "adi_x_half": s, "adi_y_half": s},
        "masked_512": {"adi_x_half": s, "adi_y_half": s},
        "analytic_gap": {"collision_step_analytic": s},
        "analytic_gap_100bin": {"collision_step_blocked_analytic": s},
        "coupled_1d_64bin": {"collision_step": 2 * s, "thomas": s},
        "ensemble_sweep": {"collision_step": 2 * s, "thomas": 2 * s, "thomas_cols": s},
    }.get(name)
    if name == "snapshot_overlap":  # a W-step warm-up call, two calls a label; merged stepping, the pulse on
        dt, n = 0.01, kw["total_steps"]
        calls = lambda steps, every: sum(g.length + 1 if g.length > 1 else 2 for g in _plan_segments(
            *_split_time(steps * dt, dt)[:2], dt, every))
        per = {"collision_step": calls(w, w) + sum(2 * calls(n, e or n) for _, e, _ in SNAPSHOT_RUNS),
               "collision_step_with_gen": w + 2 * n * len(SNAPSHOT_RUNS)}
    if name == "diff_grad":  # three forward calls; three value-and-gradient calls, each a forward and a backward
        fwd, back = remat_expect(kw["n_steps"], kw["remat_chunk"])  # two chunks: the two-level schedule
        per = {k: 6 * fwd.get(k, 0) + 3 * back.get(k, 0) for k in back}
    return zero_counts() | per


def bench_stages_at_width(card: str) -> dict:
    """13a: each stage at its full width, its lengths cut; returns the launches by stage."""
    from qpsim_tpu_torch import bench

    assert [n for n, _ in bench.STAGES] == list(BENCH_KEYS) == list(BENCH_CUTS)
    by_stage = {}
    for name, fn in bench.STAGES:
        kw = BENCH_CUTS[name]
        reset_counts()
        t0 = time.perf_counter()
        out = fn(**kw, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        by_stage[name] = read_counts()
        check_counts(f"13a {name} {kw} ({wall:.1f} s)", by_stage[name], bench_expect(name, kw))
        if set(out) != set(BENCH_KEYS[name]):
            raise AssertionError(f"13a {name}: keys {sorted(out)} != {sorted(BENCH_KEYS[name])}")
        for k, v in out.items():
            ok = v in ("bytes", "operations") if k.endswith("_bound_by") else bool(np.isfinite(v) and v > 0)
            if not ok:
                raise AssertionError(f"13a {name}: {k} = {v!r}")
        print(f"  13a {name}: {json.dumps(out)} — {card}", flush=True)
    return by_stage


def bench_shape_rows(card: str, counts: dict) -> list[dict]:
    """13b: the kernels at the shapes the bench runs first, each against its plain version."""
    from qpsim_tpu_torch import bench
    from qpsim_tpu_torch.ops import adi_sep_cuda as k1
    from qpsim_tpu_torch.ops.dos import diffusion_coefficient_of_energy
    from qpsim_tpu_torch.parallel.mesh import make_mesh
    from qpsim_tpu_torch.parallel.sharded import build_sharded_step
    from qpsim_tpu_torch.solver.diffusion_backends import ADIDiffusion, CudaADI

    rows = []
    d_of = lambda ne: diffusion_coefficient_of_energy(6.0, bench._physics(ne)[0], 180.0)
    # K10 on the 1 × 4096 × 64 wire's x lines: the ADIDiffusion x half's system, (64, 1, 4096) rows
    p = ADIDiffusion(bench._film_operator(np.ones((1, 4096), dtype=bool), d_of(64)), "cuda", F32).planes
    a_s = (0.025 * p.scale).reshape(-1, 1, 1)
    rhs = torch.rand((64, 1, 4096), device="cuda", dtype=F32)
    rows.append(thomas_row("thomas_wire_1x4096x64", (-a_s * p.ax_lo, 1.0 - a_s * p.ax_diag, -a_s * p.ax_hi, rhs),
                           counts["coupled_1d_64bin"]["thomas"], F32))
    # K3's column walk at 64 bins on that one-row film
    _, col, q, ph = bench._coupled_pieces(1, 4096, 64, 0.05, F32, "cuda")
    got, ref = col(q, ph), col.plain(q, ph)
    torch.cuda.synchronize()
    tol = TOL[("collision_step", F32)]
    check("collision_step NE=64 1 × 4096 float32 (column walk), q", scaled_err(got[0], ref[0]), tol)
    check("collision_step NE=64 1 × 4096 float32 (column walk), ph", scaled_err(got[1], ref[1]), tol)
    rows.append(dict(
        name="collision_step_wire_1x4096x64", route="cuda", source="qpsim_tpu_torch/csrc/offset_walk.cu",
        replaces="qpsim_tpu/ops/pallas_collisions.py:169", launches=counts["coupled_1d_64bin"]["collision_step"],
        max_abs_err=max(abs_err(got[0], ref[0]), abs_err(got[1], ref[1])), ms=time_ms(lambda: col(q, ph), 20),
        plain_ms=time_ms(lambda: col.plain(q, ph), 3),
        **bound(*collision_work(col.plan, q, ph, None, kernel_tensors(col.tables)), F32), library_ms=None,
    ))
    # K7 on the one-device mesh's 256-cell lines: the x half (swapped rows) and the pencil y half
    op = bench._film_operator(np.ones((256, 256), dtype=bool), d_of(16))
    raw = build_sharded_step(make_mesh(n_space=1, devices=[torch.device("cuda", 0)]), op, 0.05, dtype=F32).aux[0]
    n_k7 = counts["sharded_overhead"]["adi_lines"]  # x every step; pencil y in two of the three variants
    rows.append(sharded_line_row("adi_lines_1dev_x", torch.rand((16, 256, 256), device="cuda", dtype=F32),
                                 raw["axlT"][0], raw["axdT"][0], raw["axhT"][0], raw["scale"][0], n_k7 // 2, card))
    rows.append(sharded_line_row("adi_lines_1dev_y_pencil", torch.rand((16, 256, 256), device="cuda", dtype=F32),
                                 raw["aylC"][0], raw["aydC"][0], raw["ayhC"][0], raw["scale"][0], n_k7 // 3, card))
    # the rooflines stage's standalone ADI step at 1024² × 16: K1 (separable, standalone)
    adi = CudaADI(bench._film_operator(np.ones((1024, 1024), dtype=bool), d_of(16)), "cuda", F32)
    if not adi.separable:
        raise AssertionError("13b the standalone 1024² × 16 step should take K1")
    f = adi.make_step(0.05).factors
    u = torch.rand((16, 1024, 1024), device="cuda", dtype=F32) * 1e-5
    ux_ref, ux = k1.adi_sep_x_half_plain(u, f), k1.adi_sep_x(u, f)
    uy_ref, uy = k1.adi_sep_y_half_plain(ux_ref, f), k1.adi_sep_y(ux_ref, f)
    torch.cuda.synchronize()
    check("adi_sep_x 1024²×16 standalone float32", scaled_err(ux, ux_ref), TOL[("adi_sep", F32)])
    check("adi_sep_y 1024²×16 standalone float32", scaled_err(uy, uy_ref), TOL[("adi_sep", F32)])
    for name, line, err, kern, plain in (
        ("adi_sep_x", 237, abs_err(ux, ux_ref), k1.adi_sep_x, k1.adi_sep_x_half_plain),
        ("adi_sep_y", 280, abs_err(uy, uy_ref), k1.adi_sep_y, k1.adi_sep_y_half_plain),
    ):
        rows.append(dict(
            name=f"{name}_1024x16_standalone", route="cuda", source="qpsim_tpu_torch/csrc/adi_sep.cu",
            replaces=f"qpsim_tpu/ops/pallas_adi_sep.py:{line}", launches=counts["rooflines"][name],
            max_abs_err=err, ms=graph_ms(lambda: kern(u, f), 20), timing="graph",
            plain_ms=time_ms(lambda: plain(u, f), 3), **bound(*adi_sep_work(u, f, name[-1]), F32), library_ms=None,
        ))
    print_rows(rows, "the bench's new shapes, each row's own", card)
    return rows


def phase_bench_and_entry_points(card: str) -> list[dict]:
    print("== 13 the bench and the entry points: the 15 stages at full width, their new shapes against the "
          "plain versions, entry(), dryrun_multichip(4)", flush=True)
    from qpsim_tpu_torch import graft_entry

    counts = timed_phase(bench_stages_at_width, card)
    torch.cuda.empty_cache()
    rows = timed_phase(bench_shape_rows, card, counts)
    torch.cuda.empty_cache()

    # (c) entry(): one step of the 256² × 16 flagship, K3 twice and K2 once
    fn, (q0, ph0) = graft_entry.entry()
    reset_counts()
    q, ph = fn(q0, ph0)
    torch.cuda.synchronize()
    check_counts("13c entry() one step", read_counts(),
                 zero_counts() | {"collision_step": 2, "adi_x_half": 1, "adi_y_half": 1})
    q_ref, ph_ref = fn.plain(q0, ph0)
    check("13c entry() vs its step on the plain versions, q", scaled_err(q, q_ref), 1e-5)
    check("13c entry() vs its step on the plain versions, ph", scaled_err(ph, ph_ref), 1e-5)
    print(f"  13c entry() step: {time_ms(lambda: fn(q0, ph0), 20):.4f} ms (events), 256² × 16 float32 — {card}",
          flush=True)

    # (d) the dry run on four cells of the card (2 ensemble groups × 2 shards)
    reset_counts()
    t0 = time.perf_counter()
    graft_entry.dryrun_multichip(4)
    torch.cuda.synchronize()
    got = {k: v for k, v in read_counts().items() if v}
    if not (got.get("collision_step") and got.get("adi_lines")):
        raise AssertionError(f"13d the dry run launched {got}; it should run K3 and K7")
    print(f"  13d dryrun_multichip(4) on 4 cells of cuda:0: ok in {time.perf_counter() - t0:.1f} s, launches {got}",
          flush=True)
    return rows


def timed_phase(fn, *args):
    """Run one phase and print its wall time."""
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"  ({fn.__name__}: {time.perf_counter() - t0:.1f} s)", flush=True)
    return out


def main() -> int:
    card = timed_phase(phase_environment)
    timed_phase(phase_build)
    timed_phase(phase_kernels_vs_plain)
    main_frames: dict = {}
    rows = timed_phase(phase_main_path, card, main_frames)
    rows += timed_phase(phase_gap_maps, card)
    rows += timed_phase(phase_blocked_path, card)
    rows += timed_phase(phase_explicit_entry_points, card)
    timed_phase(phase_end_to_end_f64)
    rows += timed_phase(phase_scalar_path, card)
    rows += timed_phase(phase_other_diffusion_paths, card)
    rows += timed_phase(phase_photon_film, card)
    timed_phase(phase_photon_film_f64)
    validation_bins = timed_phase(phase_validation, card)
    rows += timed_phase(phase_setup_runner, card, rows)
    rows += timed_phase(phase_slice, card, main_frames)
    rows += timed_phase(phase_beyond_and_cli, card, validation_bins)
    rows += timed_phase(phase_sharding, card)
    rows += timed_phase(phase_bench_and_entry_points, card)
    for row in rows:  # how ms was timed: "graph" (a CUDA graph of the calls) or host-launched "events"
        row.setdefault("timing", "events")
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
