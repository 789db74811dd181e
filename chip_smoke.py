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
   walk), the fused ADI halves (K2) with one plane and with NB
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
   diagonals), 72 (ω rows shared by a difference and a sum), 100 and 256;
   the offset walks, explicit entry points on the same kernel: K8
   (uniform and G = 3 gap ids) at NE = 16, 72, 100 and 256 and with G = 9
   ids at 16, K9 at 16, 72 and the split 66 (there also against K3's plain
   version), and the line solve K7 (Thomas and Wang K = 32, one plane and
   NB planes, B = 1000; Thomas asked for on lines of 16385, where the
   kernel pads its chunks);
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
4c. beyond 64 bins: the coupled path at 100 energy bins (NW = 299), 40
   steps stored at the start and the end — uniform on the 1024²
   rectangle through K5 (two timed calls), the trap (K5 with gap ids) and
   a gradient (K6) on 512² (one each) — with exact launch counts and no
   K3/K4 launch; then K5,
   K5-gid (random ids, and the trap disc's coherent ids) and K6 timed
   against their plain versions at 1024² × 100, and K5 at 256 bins;
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
   plane and 100 + 100 K2 halves, steady ms/step over three calls beside
   the same film with neither photons nor custom generation, the set-up
   split (GDS raster, IC build, program build), a two-tone drive, the trap
   map (K3 gap ids) and the gradient (K4) under the per-pixel photon
   substep, the photon substep and the traced generation timed alone, and
   K3 with no plane and K2 on the film's planes against their plain
   versions; (8b) the layout at 4.03 µm (256²) in float64 against the
   plain path, uniform and gradient, and host-mode generation on 64²
   ("auto" → exact); (8c) ``run_fast_validation_suite(device="cuda")``
   in float64 and float32 with its figures and kernel counters;
9. a JSON line with the kernels' numbers, the card line, and a last JSON
   line ``{"ok": true, "device": {...}}``.

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

import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

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


#: H100 SXM data-sheet peaks: HBM bytes/s and float32 (non-tensor) and float64 FLOP/s
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {F32: 67e12, F64: 34e12}

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


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound(n_bytes: float, flops: float, dtype) -> dict:
    """bound_ms / bound_by of a kernel row from its bytes and operations."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return dict(bound_ms=1e3 * max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations")


def collision_work(plan, q, ph, gen, tensors, analytic=False) -> tuple[int, int]:
    """(bytes, operations) of one collision substep on these inputs.

    Bytes: q and n_ph in and out (n_ph out only when phonons update), the
    gen plane and every table once.  Operations per pixel: what the
    function needs, however often a kernel re-forms a term.  K^s₀, K^r₀
    and their ω rows are symmetric in (i, j), so each constant is formed
    once per unordered pair {i, j}:
      scattering, i ≠ j (NE(NE − 1)/2 pairs): K·n and K + K·n (2), the
        four gathers loss_i, loss_j, gain_i, gain_j (8), the phonon row's
        emission and absorption terms (4) and their sums into a, b (3);
      recombination, i ≤ j (NE(NE + 1)/2 pairs): k·s and k + k·s (2),
        the phonon row's k·q_i·q_j and k·p_i·p_j (4) and their sums (3);
        the gathers loss_i += k(1 + s)·q_j, gain_i += k·s·p_j take 4 per
        ordered pair (NE²);
    then 16 per bin (partner, gain, relaxation), 1 per bin for gen and 10
    per ω row.  The analytic forms add 10 per bin for ρ and, per
    unordered pair, 3 for the scattering constant and 2 for the
    recombination constant from Δ².
    """
    ne, nw = plan.num_energy_bins, plan.num_omega
    n_pix = q.shape[1] * q.shape[2]
    n_s = ne * (ne - 1) // 2 if plan.enable_scattering else 0
    n_r = ne * (ne + 1) // 2 if plan.enable_recombination else 0
    n_r_ordered = ne * ne if plan.enable_recombination else 0
    per_px = 10 * n_s + 2 * n_r + 4 * n_r_ordered + 16 * ne + (ne if gen is not None else 0)
    if plan.update_phonons:
        per_px += 7 * n_s + 7 * n_r + 10 * nw
    if analytic:
        per_px += 10 * ne + 3 * n_s + 2 * n_r
    state = nbytes(q, q, ph, gen) + (nbytes(ph) if plan.update_phonons else 0)
    return state + nbytes(*tensors), per_px * n_pix


def adi_work(u, planes) -> tuple[int, int]:
    """(bytes, operations) of one K2 half: u in, out, the 7 planes and the scale; ≈ 20 flops per element."""
    p = planes
    return nbytes(u, u, p.ax_lo, p.ax_hi, p.ax_diag, p.ay_lo, p.ay_hi, p.ay_diag, p.src, p.scale), 20 * u.numel()


def adi_sep_work(u, f, half: str) -> tuple[int, int]:
    """(bytes, operations) of one K1 half: u in, out, its packs; ≈ 15 flops per element."""
    packs = (f.xv, f.yv) + ((f.facx, f.ifx) if half == "x" else (f.facy, f.ify))
    return nbytes(u, u, *packs), 15 * u.numel()


def thomas_work(system) -> tuple[int, int]:
    """(bytes, operations) of the Thomas solve: a, b, c, r in, x out; ≈ 8 flops per element."""
    return nbytes(*system, system[3]), 8 * system[3].numel()


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


def kernel_tensors(tables, *planes):
    """What a K3/K4 launch reads besides the state (for byte counts): the
    pair walk's tables and ``planes`` (gap ids, Δ² and the Dynes
    constants), or beyond the register buckets the column walk's tables."""
    from qpsim_tpu_torch.ops.column_walk import ColumnTables

    if isinstance(tables, ColumnTables):
        return tables.kernel_tensors()
    return [*planes, *tables.kernel_tensors()]


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


def launch_tables():
    from qpsim_tpu_torch.ops import adi_cuda, adi_sep_cuda, collisions_cuda, tridiag_cuda

    return (collisions_cuda.LAUNCHES, adi_cuda.LAUNCHES, adi_sep_cuda.LAUNCHES, tridiag_cuda.LAUNCHES)


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
        o = re.search(r"Compiling entry function '.*?(column_walk_kernel)I([fd])Li(\d)ENS_\d+"
                      r"(TableConsts|AnalyticConsts)I[fd]E", line)
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
            name = (f"{o.group(1)}<{'float' if o.group(2) == 'f' else 'double'}, P={o.group(3)}, "
                    f"{o.group(4)}>")
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
    # the column walk's pixels per lane at 1024² and its dynamic shared
    # memory per block (q and partner of the tile), at K5/K6's columns
    from qpsim_tpu_torch.ops.column_walk import blocks_per_sm, column_pixels

    for ne in (65, 72, 100, 256):
        n_scat, n_rec = column_counts(ne)
        forms = []
        for dtype, size in ((F32, 4), (F64, 8)):
            pixels = column_pixels(dtype, ne, 1024 * 1024)
            smem = 2 * ne * 32 * pixels * size
            forms.append(f"{str(dtype)[6:]} P={pixels} {smem} B ({blocks_per_sm(smem)} block(s) "
                         "of 8 warps per SM by shared memory)")
        print(f"  column_walk_kernel at NE={ne} ({n_scat} + {n_rec} columns): {'; '.join(forms)}")
    sys.stdout.flush()


def phase_kernels_vs_plain() -> None:
    print("== 3 kernels against their plain versions on the card", flush=True)
    from qpsim_tpu_torch.ops import adi_cuda

    check_pair_walk()
    check_blocked()
    # K2: the main rectangle, the masked donut (zero coupling rows), each with
    # one plane and NB planes; ragged tiles in both halves on 250 × 255 (K = 1
    # along x, 2 along y) and 250 × 301 (K = 1 asked along x, 32 launched,
    # the last chunk padded); 24 × 16384, long enough rows for the x half's
    # two-pass form in both dtypes; lines of 16385 = 5·29·113 cells, whose
    # 32 padded chunks take two passes (x half; y half in float64)
    for name, geometry, nb, pixel_forms in (
        ("rectangle 1024²", rectangle(1024), 16, (False, True)),
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
    check_thomas()
    check_offset_walks()
    check_adi_lines()


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
    for ne, n, emax in ((1, (45, 50), 4.0), (2, (45, 50), 4.0),
                        (8, (45, 50), 4.0), (9, (45, 50), 4.0), (11, (45, 50), 4.0), (16, 256, 4.0),
                        (16, (45, 50), 5.0), (16, (45, 50), 9.0), (17, (45, 50), 4.0),
                        (32, (45, 50), 4.0), (33, (45, 50), 4.0), (50, 128, 4.0),
                        (64, (64, 50), 4.0)):
        grid = f"{n}²" if isinstance(n, int) else f"{n[0]}×{n[1]}"
        grid += "" if emax == 4.0 else f" E_max={emax:g}Δ"
        for kind, gamma, phonons in forms:
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
                for phonons in (True, False):
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
                            check(f"{name} NE={ne} {grid} P={column_pixels(dtype, ne, n_pix)} "
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
    for lead, lines, n in ((16, 1024, 1024), (1, 1000, 257), (2, 333, 1023), (1, 64, 16385)):
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
                     "thomas": 0, "thomas_cols": 0, "thomas_relayout": 0} | {k: 0 for k in EXPLICIT_COUNTERS}


#: the counters of the explicit entry points (K8, K9, K7), which no path of
#: ``run_2d_crank_nicolson`` launches
EXPLICIT_COUNTERS = ("collision_step_loop", "collision_step_loop_gid", "collision_step_rows",
                     "adi_lines")


def run_coupled_timed(label: str, kw: dict, expect_collision: str, card: str, calls: int = 3) -> dict:
    """``calls`` timed calls of a coupled configuration with exact launch
    counts and the physics checks; returns the launch counts of the first."""
    from qpsim_tpu_torch.solver.stepping import _plan_segments, _split_time

    full, rem, _ = _split_time(kw["total_time"], kw["dt"])
    segments = _plan_segments(full, rem, kw["dt"], kw["store_every"])
    steps = sum(s.length for s in segments)
    expect = coupled_expect(segments, expect_collision)
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    (times, frames, mass, clim, ef, _), first = timed_run(kw, steps)
    counts = read_counts()
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


def print_rows(rows, shape: str, card: str) -> None:
    for r in rows:
        print(f"  {r['name']}: kernel {r['ms']:.4f} ms ({r.get('timing', 'events')}), plain "
              f"{r['plain_ms']:.3f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}), max abs err {r['max_abs_err']:.3e} "
              f"({shape}, float32) — {card}")
    sys.stdout.flush()


def phase_main_path(card: str) -> list[dict]:
    print("== 4 main path: 1024² × 16 bins, 100 steps, float32, merged stepping", flush=True)
    import qpsim_tpu_torch
    from qpsim_tpu_torch.ops import adi_cuda

    dt, total, store_every = 0.05, 5.0, 25
    kw = dict(main_path_kwargs(1024), dt=dt, total_time=total, store_every=store_every)
    t0 = time.perf_counter()
    qpsim_tpu_torch.run_2d_crank_nicolson(**kw)  # warm-up
    torch.cuda.synchronize()
    print(f"  warm-up run {time.perf_counter() - t0:.2f} s", flush=True)
    counts = run_coupled_timed("uniform gap", kw, "collision_step", card)

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
        counts[map_name] = run_coupled_timed(f"{map_name} map", kw, collision, card, calls=2)

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
    print("== 4c beyond 64 bins: 100 bins, 40 steps, float32, merged stepping — uniform gap on "
          "1024², gap maps on 512² (cut from 1024²: their per-pixel D(E, x) fold grows with NE)",
          flush=True)
    dt, steps = 0.05, 40
    # stored only at the start and the end: each stored frame rebuilds 100
    # bins on the host.  No warm-up call: the kernels were built and run in
    # phases 3–4, and a 100-bin call spends ≈ 15 s of host set-up (1024²)
    counts = {"uniform": run_coupled_timed(
        "uniform gap 1024² × 100",
        dict(main_path_kwargs(1024), num_energy_bins=100, dt=dt, total_time=dt * steps,
             store_every=steps),
        "collision_step_blocked", card, calls=2)}
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
    # K5 at the 256-bin envelope: the kernel on 1024², its plain version
    # (whose time grows with the pixels) on 256², each checked on its own shape
    kern, plain, plan, tensors, q, ph, gen = collision_setup(256, 256, F32, blocked=True, pixel_chunk=1024)
    ref, plain_once = timed_once(lambda: plain(q, ph, dt, gen))
    got = kern(q, ph, dt, gen)
    torch.cuda.synchronize()
    check("collision_step_blocked NE=256 256² float32 gen=True phonons=True",
          max(scaled_err(got[0], ref[0]), scaled_err(got[1], ref[1])), blocked_tol(F32, 256))
    small_ms = time_ms(lambda: kern(q, ph, dt, gen), 5)
    del kern, plain, plan, tensors, q, ph, gen, ref, got
    kern, _, plan, tensors, q, ph, gen = collision_setup(256, 1024, F32, blocked=True)
    ms = time_ms(lambda: kern(q, ph, dt, gen), 3)
    b = bound(*collision_work(plan, q, ph, gen, tensors), F32)
    print(f"  collision_step_blocked NE=256 (NW 767): kernel {ms:.4f} ms at 1024², bound "
          f"{b['bound_ms']:.4f} ms ({b['bound_by']}); at 256²: kernel {small_ms:.4f} ms, plain "
          f"{plain_once:.3f} ms (one call) — float32, {card}", flush=True)
    del kern, plan, tensors, q, ph, gen
    torch.cuda.empty_cache()
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
    plain_adi = run(**kw, diffusion_backend="adi")
    assert_runs_close("(c) K1 path vs 'adi'", kernel, plain_adi, 1e-10, 1e-12)
    saved = get_default_solver()
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


def timed_film_calls(label, kw, expect, card, calls=3):
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
    print("== 8b the GDS film at 4.03 µm (256²), float64, 30 steps: IC, traced generation and photons "
          "against the plain path; host-mode generation on 64²", flush=True)
    import qpsim_tpu_torch

    run = qpsim_tpu_torch.run_2d_crank_nicolson
    mask, edges, bcs, _ = gds_film(4.03)
    if mask.shape != (256, 256):
        raise AssertionError(f"the 4.03 µm film is {mask.shape}, expected 256²")
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
        check_counts(f"256² {map_name}", read_counts(), film_expect(collision, 30, 3))
        assert_runs_close(f"256² {map_name}, photons + traced generation: kernels vs plain", a,
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


def phase_validation(card: str) -> None:
    print("== 8c run_fast_validation_suite(device='cuda'), float64 and float32", flush=True)
    import qpsim_tpu_torch

    for dtype in (F64, F32):
        reset_counts()
        t0 = time.perf_counter()
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
    rows = timed_phase(phase_main_path, card)
    rows += timed_phase(phase_gap_maps, card)
    rows += timed_phase(phase_blocked_path, card)
    rows += timed_phase(phase_explicit_entry_points, card)
    timed_phase(phase_end_to_end_f64)
    rows += timed_phase(phase_scalar_path, card)
    rows += timed_phase(phase_other_diffusion_paths, card)
    rows += timed_phase(phase_photon_film, card)
    timed_phase(phase_photon_film_f64)
    timed_phase(phase_validation, card)
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
