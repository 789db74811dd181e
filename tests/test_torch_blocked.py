"""The collision substep beyond 64 bins (K5, K5 with gap ids, K6) against ``qpsim_tpu``.

Float64 on the CPU, where the wrappers ``collision_step_blocked`` and
``collision_step_blocked_analytic`` run their plain versions (K3's and
K4's, the same function over more bins):

* against the JAX package's blocked Pallas kernels in interpret mode
  (``build_pallas_collision_step_blocked[_analytic]``) at that package's
  own tolerances (``tests/test_collisions.py``: q 1e-12, n_ph 1e-9);
* at NE = 65, where a pair diagonal splits two ω bins and the JAX blocked
  builder declines, against the JAX XLA integrator it runs instead;
* the CUDA kernel's tables and walk (``csrc/offset_walk.cu``: K9's
  columns per gap, tiles of 32·P pixels staged [NE][32·P], the
  register-blocked walk's dense tables and order, the warp-uniform gap-id
  test) through the NumPy
  transcription of ``tests/column_walk_transcription.py``, at NE = 72,
  whose ω rows carry differences and sums together, at NE = 17, 65 and 66
  (split diagonals) and at 100, with coherent and mixed gap ids, K6 BCS
  and Dynes, generation on and off and frozen phonons; the column grouping
  equal to K9's per gap;
* ``run_2d_crank_nicolson`` at NE = 72 on a 12-cell strip, uniform gap,
  a trap and a gradient, against the JAX engine on its blocked kernels
  (mass 1e-9, frames 1e-8, as ``tests/test_engine.py`` holds them);
* the dispatch (``collision_kernel_for``) at its boundaries, the wrapper
  the engine steps through, and beyond 256 bins K5 chosen on CUDA (the
  cap is gone: ``tests/test_torch_beyond_256.py``), plain on the CPU;
* the new modules under the port's no-JAX rule.
"""

import ast
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import qpsim_tpu as J  # noqa: E402
from qpsim_tpu.geometry.mask import extract_edge_segments  # noqa: E402
from qpsim_tpu.models.params import BoundaryCondition  # noqa: E402
from qpsim_tpu.ops.collisions import build_collision_plan_arrays as j_plan  # noqa: E402
from qpsim_tpu.ops.collisions import make_collision_step  # noqa: E402
from qpsim_tpu.ops.dos import dynes_density_of_states, thermal_phonon_occupation  # noqa: E402
from qpsim_tpu.ops.energy_grid import build_energy_grid  # noqa: E402
from qpsim_tpu.ops.kernels import recombination_kernel_base, scattering_kernel_base  # noqa: E402
from qpsim_tpu.ops.pallas_collisions import _uniform_pair_rows  # noqa: E402
from qpsim_tpu.ops.pallas_collisions_blocked import (  # noqa: E402
    build_pallas_collision_step_blocked,
    build_pallas_collision_step_blocked_analytic,
)
from qpsim_tpu.ops.phonon_map import build_phonon_frequency_map  # noqa: E402

import qpsim_tpu_torch as T  # noqa: E402
from qpsim_tpu_torch.interop import (  # noqa: E402
    analytic_tables_from_numpy,
    collision_tables_from_numpy,
    state_to_numpy,
    state_to_torch,
)
from qpsim_tpu_torch.models import params as tp  # noqa: E402
from qpsim_tpu_torch.ops import collisions_cuda  # noqa: E402
from qpsim_tpu_torch.ops.collisions import collision_step_analytic_plain, collision_step_plain  # noqa: E402
from qpsim_tpu_torch.ops import collisions_rows_cuda as t_rows  # noqa: E402
from qpsim_tpu_torch.ops.collisions_blocked_cuda import (  # noqa: E402
    build_column_tables,
    collision_step_blocked,
    collision_step_blocked_analytic,
)
from qpsim_tpu_torch.ops.column_walk import column_pixels  # noqa: E402
from qpsim_tpu_torch.solver import engine as t_engine  # noqa: E402
from qpsim_tpu_torch.solver.program_build import collision_kernel_for  # noqa: E402

from column_walk_transcription import transcribe  # noqa: E402

NY, NX = 2, 4
DT = 0.02
TAU_S, TAU_R, T_C = 440.0, 520.0, 1.2


def _setup(ne, *, gaps=(180.0,), scattering=True, recombination=True, phonons=True, seed=0,
           ny=NY, nx=NX):
    """Host physics from the JAX package, the port's plan from it, and a state."""
    E, dE = build_energy_grid(180.0, 1.0, 4.0, ne)
    pm = build_phonon_frequency_map(E)
    rng = np.random.default_rng(seed)
    gid = None if len(gaps) == 1 else rng.integers(0, len(gaps), (ny, nx)).astype(np.int32)
    rho = np.stack([dynes_density_of_states(E, g, 0.0) for g in gaps])
    Ks = np.stack([scattering_kernel_base(E, g, TAU_S, T_C) for g in gaps]) if scattering else None
    Kr = np.stack([recombination_kernel_base(E, g, TAU_R, T_C) for g in gaps]) if recombination else None
    plan = collision_tables_from_numpy(
        dE=dE, rho=rho, K_s0=Ks, K_r0=Kr, omega_bins=pm.omega_bins, idx_diff=pm.idx_diff,
        idx_sum=pm.idx_sum, diff_sign=pm.diff_sign, enable_scattering=scattering,
        enable_recombination=recombination, update_phonons=phonons, device="cpu",
        dtype=torch.float64, pixel_chunk=5, gap_id=gid,  # several chunks, one ragged
    )
    rho_px = rho[0][:, None, None] if gid is None else rho[gid].transpose(2, 0, 1)
    q = rng.uniform(0, 2e-3, (ne, ny, nx)) * rho_px
    ph = thermal_phonon_occupation(pm.omega_bins, 0.25)[:, None, None] * rng.uniform(
        0.5, 2.0, (pm.num_omega, ny, nx))
    return dict(E=E, dE=dE, pm=pm, rho=rho, Ks=Ks, Kr=Kr, gid=gid, plan=plan, q=q, ph=ph)


def _one(a):
    """A (1, ...) per-gap stack as the JAX builders take a uniform gap."""
    return None if a is None else (a[0] if a.shape[0] == 1 else a)


def _jax_blocked(s, phonons):
    return build_pallas_collision_step_blocked(
        E_bins=s["E"], dE=s["dE"], rho=_one(s["rho"]), K_s0=_one(s["Ks"]), K_r0=_one(s["Kr"]),
        pmap=s["pm"], dt=DT, update_phonons=phonons, tile=128, block=8, interpret=True,
        gap_id=s["gid"],  # block 8: half the interpret time of the default 16, same result
    )


def _port(step, *args, q, ph, gen=None):
    qt, pt = state_to_torch(q, ph, "cpu", torch.float64)
    g = None if gen is None else torch.as_tensor(gen)
    return state_to_numpy(*step(*args, qt, pt, DT, g))


def _close(got, want, rtol_q=1e-12, rtol_ph=1e-9):
    np.testing.assert_allclose(got[0], want[0], rtol=rtol_q, atol=1e-22)
    np.testing.assert_allclose(got[1], want[1], rtol=rtol_ph, atol=1e-22)


# ---------------------------------------------------------------- (a), (b) K5


@pytest.mark.parametrize(
    "ne,scattering,recombination,phonons",
    [(72, True, False, True), (72, False, True, True), (72, True, True, True),
     (72, True, True, False), (80, True, True, True)],
    ids=["scattering-72", "recombination-72", "both-72", "frozen_phonons-72", "both-80"],
)
def test_blocked_matches_jax_blocked_interpret(ne, scattering, recombination, phonons):
    s = _setup(ne, scattering=scattering, recombination=recombination, phonons=phonons, seed=ne)
    pal = _jax_blocked(s, phonons)
    assert pal is not None
    want = [np.asarray(a) for a in pal(jnp.asarray(s["q"]), jnp.asarray(s["ph"]))]
    tables = collisions_cuda.build_kernel_tables(s["plan"])
    got = _port(collision_step_blocked, s["plan"], tables, q=s["q"], ph=s["ph"])
    _close(got, want)
    if not phonons:
        np.testing.assert_array_equal(got[1], s["ph"])


def test_blocked_gap_ids_match_jax_blocked_interpret():
    s = _setup(80, gaps=(150.0, 165.0, 180.0), seed=81)
    assert len(np.unique(s["gid"])) == 3
    want = [np.asarray(a) for a in _jax_blocked(s, True)(jnp.asarray(s["q"]), jnp.asarray(s["ph"]))]
    tables = collisions_cuda.build_kernel_tables(s["plan"])
    _close(_port(collision_step_blocked, s["plan"], tables, q=s["q"], ph=s["ph"]), want)


# ---------------------------------------------------------------- (c) K6


def _analytic_setup(ne, gamma, *, phonons=True, seed=0, ny=NY, nx=NX):
    E, dE = build_energy_grid(180.0, 1.0, 4.0, ne)
    pm = build_phonon_frequency_map(E)
    rng = np.random.default_rng(seed)
    plane = rng.uniform(140.0, 195.0, (ny, nx))
    plan, tab = analytic_tables_from_numpy(
        E_bins=E, dE=dE, gap_plane=plane, omega_bins=pm.omega_bins, idx_diff=pm.idx_diff,
        idx_sum=pm.idx_sum, diff_sign=pm.diff_sign, tau_s=TAU_S, tau_r=TAU_R, T_c=T_C,
        dynes_gamma=gamma, update_phonons=phonons, device="cpu", dtype=torch.float64,
        pixel_chunk=5,
    )
    rho = np.stack([dynes_density_of_states(E, g, gamma) for g in plane.reshape(-1)]).T
    q = rng.uniform(0, 2e-3, (ne, ny, nx)) * rho.reshape(ne, ny, nx)
    ph = thermal_phonon_occupation(pm.omega_bins, 0.25)[:, None, None] * rng.uniform(
        0.5, 2.0, (pm.num_omega, ny, nx))
    return dict(E=E, dE=dE, pm=pm, plane=plane, plan=plan, tab=tab, q=q, ph=ph)


@pytest.mark.parametrize("gamma", [0.0, 0.12], ids=["bcs", "dynes"])
def test_blocked_analytic_matches_jax_blocked_analytic_interpret(gamma):
    s = _analytic_setup(72, gamma, seed=5)
    pal = build_pallas_collision_step_blocked_analytic(
        E_bins=s["E"], dE=s["dE"], gap_plane=s["plane"], pmap=s["pm"], dt=DT, tau_s=TAU_S,
        tau_r=TAU_R, T_c=T_C, dynes_gamma=gamma, update_phonons=True, tile=128, interpret=True,
    )
    assert pal is not None
    want = [np.asarray(a) for a in pal(jnp.asarray(s["q"]), jnp.asarray(s["ph"]))]
    tables = collisions_cuda.build_kernel_tables(s["plan"])
    got = _port(collision_step_blocked_analytic, s["plan"], s["tab"], tables, q=s["q"], ph=s["ph"])
    # the JAX package holds its analytic kernels at q 1e-11 (tests/test_torch_gap_maps.py)
    _close(got, want, rtol_q=1e-11)


# ---------------------------------------------------------------- (d) split ω diagonals


@pytest.mark.parametrize("gen", [False, True], ids=["no_gen", "gen"])
def test_split_omega_diagonals_match_the_xla_integrator(gen):
    s = _setup(65, seed=11)
    assert _uniform_pair_rows(np.asarray(s["E"]), s["pm"]) is None  # a diagonal splits
    assert _jax_blocked(s, True) is None  # so the JAX package declines its blocked kernel
    jp = j_plan(dE=s["dE"], rho_by_gap=s["rho"], K_r0_by_gap=s["Kr"], K_s0_by_gap=s["Ks"],
                gap_id=np.zeros((NY, NX), np.int32), pmap=s["pm"], enable_recombination=True,
                enable_scattering=True, update_phonons=True, pixel_chunk=5)
    g = np.random.default_rng(3).uniform(0, 1e-6, (NY, NX)) if gen else None
    q_in = s["q"] + (0.0 if g is None else g[None])  # the XLA step takes dt·g added
    want = [np.asarray(a) for a in make_collision_step(jp, DT)(jnp.asarray(q_in), jnp.asarray(s["ph"]))]
    tables = collisions_cuda.build_kernel_tables(s["plan"])
    _close(_port(collision_step_blocked, s["plan"], tables, q=s["q"], ph=s["ph"], gen=g), want,
           rtol_ph=1e-12)


# ---------------------------------------------------------------- the kernel's walk


def _pixels(tables, n_pix):
    """The pixels per lane of the float32 launch (the main path's)."""
    return column_pixels(torch.float32, tables.num_energy_bins, n_pix)


@pytest.mark.parametrize(
    "ne,gaps,gen,phonons",
    [(72, (180.0,), True, True), (65, (180.0,), False, True), (72, (150.0, 165.0, 180.0), True, True),
     (17, (180.0,), True, True), (66, (180.0,), True, True), (100, (180.0,), True, True),
     (100, (150.0, 165.0, 180.0), False, True), (65, (150.0, 180.0), True, False),
     (72, (180.0,), False, False)],
    ids=["shared_rows_gen", "split_diagonals", "gap_ids_gen", "17-split_gen", "66-split_gen",
         "100-gen", "100-gap_ids", "split_gap_ids_frozen_phonons", "shared_rows_frozen_phonons"],
)
def test_blocked_kernel_walk_reproduces_plain_version(ne, gaps, gen, phonons):
    tile = 32 * column_pixels(torch.float32, ne, 2)
    # two tiles, the second ragged; with gap ids the first tile's ids agree
    # (one table base) and the second's are mixed (a per-pixel gather)
    s = _setup(ne, gaps=gaps, phonons=phonons, seed=ne, ny=1, nx=tile + 38)
    plan = s["plan"]
    if len(gaps) > 1:
        gid = plan.gap_id.numpy()
        gid[:tile] = 1
        assert len(np.unique(gid[tile:])) == len(gaps)
    if ne == 72:  # ω rows that carry both a difference and a sum
        assert plan.num_omega < 3 * ne - 1
        assert np.intersect1d(s["pm"].idx_diff[s["pm"].diff_sign != 0], s["pm"].idx_sum).size > 0
    g = np.random.default_rng(4).uniform(0, 1e-6, s["q"].shape[1:]) if gen else None
    tables = build_column_tables(plan)
    if ne in (17, 65, 66):  # a split diagonal: more columns than offsets / anti-diagonals
        assert tables.n_scat > ne - 1 or tables.n_rec > 2 * ne - 1
        # walked as extra terms and per-row sums
        assert tables.x_scat.numel() + tables.x_rec.numel() > 0 and tables.slow_rows.numel() > 1
    if ne == 100:  # one column per offset and anti-diagonal: every touched row on a block task
        assert tables.x_scat.numel() == tables.x_rec.numel() == 0 and tables.slow_rows.numel() == 1
    want = _port(collision_step_plain, plan, q=s["q"], ph=s["ph"], gen=g)
    got = transcribe(tables, s["q"], s["ph"], g, DT, plan.update_phonons, _pixels(tables, tile + 38))
    _close(got, want, 1e-12, 1e-12)
    if not phonons:
        np.testing.assert_array_equal(got[1], s["ph"])


@pytest.mark.parametrize("ne,gamma", [(72, 0.0), (72, 0.12), (100, 0.0), (65, 0.12)],
                         ids=["bcs", "dynes", "100-bcs", "65-dynes"])
def test_blocked_analytic_kernel_walk_reproduces_plain_version(ne, gamma):
    s = _analytic_setup(ne, gamma, seed=9, ny=1, nx=38)  # one ragged tile
    tables = build_column_tables(s["plan"], s["tab"])
    g = np.random.default_rng(6).uniform(0, 1e-6, (1, 38))
    want = _port(collision_step_analytic_plain, s["plan"], s["tab"], q=s["q"], ph=s["ph"], gen=g)
    got = transcribe(tables, s["q"], s["ph"], g, DT, True, _pixels(tables, 38))
    _close(got, want, 1e-12, 1e-12)


@pytest.mark.parametrize("ne", [65, 100])
def test_blocked_column_grouping_equals_k9s_per_gap(ne):
    s = _setup(ne, gaps=(150.0, 165.0, 180.0), seed=ne)
    tables = build_column_tables(s["plan"])
    pm = s["pm"]
    for g in range(3):
        cols, tabs = t_rows._scattering_columns(s["Ks"][g], pm.idx_diff, ne, ne)
        np.testing.assert_array_equal(tables.scat_k.numpy(), [c[0] for c in cols])
        np.testing.assert_array_equal(tables.scat_row.numpy(), [c[1] for c in cols])
        np.testing.assert_allclose(tables.scat[g, :, :, 0].numpy(), s["dE"] * tabs[1], rtol=1e-15, atol=0)
        np.testing.assert_allclose(tables.scat[g, :, :, 1].numpy(), s["dE"] * tabs[3], rtol=1e-15, atol=0)
        cols, r_tab = t_rows._recombination_columns(s["Kr"][g], pm.idx_sum, ne, ne)
        np.testing.assert_array_equal(tables.rec_s.numpy(), [c[0] for c in cols])
        np.testing.assert_array_equal(tables.rec_row.numpy(), [c[1] for c in cols])
        np.testing.assert_allclose(tables.rec[g].numpy(), 2.0 * s["dE"] * r_tab, rtol=1e-15, atol=0)
    # the offset walk's e_up / a_up are e_dn / a_dn one offset further
    k = tables.scat_k.numpy()
    _, tabs = t_rows._scattering_columns(s["Ks"][0], pm.idx_diff, ne, ne)
    for c in range(0, tables.n_scat, 17):
        np.testing.assert_array_equal(tabs[0][: ne - k[c], c], tabs[1][k[c]:, c])
        np.testing.assert_array_equal(tabs[2][: ne - k[c], c], tabs[3][k[c]:, c])
    np.testing.assert_array_equal(tables.gid.numpy(), s["gid"].reshape(-1))  # the plan's ids


def test_blocked_wrappers_run_plain_on_cpu_and_launch_nothing():
    s = _setup(70, gaps=(160.0, 180.0), seed=2)
    tables = collisions_cuda.build_kernel_tables(s["plan"])
    qt, pt = state_to_torch(s["q"], s["ph"], "cpu", torch.float64)
    gen = torch.full(qt.shape[1:], 1e-7, dtype=torch.float64)
    before = dict(collisions_cuda.LAUNCHES)
    a = collision_step_blocked(s["plan"], tables, qt, pt, DT, gen)
    b = collision_step_plain(s["plan"], qt, pt, DT, gen)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
    sa = _analytic_setup(70, 0.0, seed=3)
    qa, pa = state_to_torch(sa["q"], sa["ph"], "cpu", torch.float64)
    ta = collisions_cuda.build_kernel_tables(sa["plan"])
    a = collision_step_blocked_analytic(sa["plan"], sa["tab"], ta, qa, pa, DT)
    b = collision_step_analytic_plain(sa["plan"], sa["tab"], qa, pa, DT)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
    assert collisions_cuda.LAUNCHES == before
    np.testing.assert_array_equal(qt.numpy(), s["q"])  # inputs untouched


# ---------------------------------------------------------------- (e) the slice end to end


def _strip_kwargs(pkg, **extra):
    mask = np.ones((1, 12), dtype=bool)
    edges = extract_edge_segments(mask)
    bc = BoundaryCondition if pkg == "jax" else tp.BoundaryCondition
    kw = dict(mask=mask, edges=edges, edge_conditions={e.edge_id: bc(kind="reflective") for e in edges},
              initial_field=np.full(mask.shape, 1e-5), diffusion_coefficient=6.0, dt=0.05,
              total_time=0.1, dx=1.0, energy_gap=180.0, num_energy_bins=72, energy_max_factor=4.0,
              enable_recombination=True, enable_scattering=True, bath_temperature=0.2)
    return dict(kw, **extra)


@pytest.mark.parametrize(
    "gap_expression",
    ["", "return 180.0 - 20.0 * (x < 0.4)", "return 140.0 + 30.0 * x"],
    ids=["uniform", "trap", "gradient"],
)
def test_engine_at_72_bins_matches_the_jax_blocked_kernels(gap_expression):
    extra = dict(gap_expression=gap_expression) if gap_expression else {}
    _, fa, ma, _, efa, _ = J.run_2d_crank_nicolson(**_strip_kwargs("jax", **extra), collision_backend="pallas")
    _, fb, mb, _, efb, _ = T.run_2d_crank_nicolson(**_strip_kwargs("torch", **extra), device="cpu")
    np.testing.assert_allclose(mb, ma, rtol=1e-9)
    for a, b in zip(fa, fb):
        np.testing.assert_allclose(np.nan_to_num(b), np.nan_to_num(a), atol=1e-18, rtol=1e-8)
    for a, b in zip(efa[-1], efb[-1]):
        np.testing.assert_allclose(np.nan_to_num(b), np.nan_to_num(a), atol=1e-18, rtol=1e-8)


# ---------------------------------------------------------------- (f) dispatch


@pytest.mark.parametrize(
    "ne,n_gaps,kernel",
    [(64, 1, "K3"), (65, 1, "K5"), (64, 8, "K3_gid"), (65, 8, "K5_gid"), (256, 2, "K5_gid"),
     (64, 9, "K4"), (65, 9, "K6"), (256, 9, "K6"), (256, 1, "K5"), (257, 1, "K5"), (257, 9, "K6")],
)
def test_collision_kernel_for_boundaries(ne, n_gaps, kernel):
    assert collision_kernel_for(ne, n_gaps) == kernel


@pytest.mark.parametrize(
    "ne,gap_expression,wrapper",
    [(72, "", "collision_step_blocked"), (72, "return 180.0 - 20.0 * (x < 0.4)", "collision_step_blocked"),
     (72, "return 140.0 + 30.0 * x", "collision_step_blocked_analytic"), (16, "", "collision_step"),
     (16, "return 140.0 + 30.0 * x", "collision_step_analytic")],
    ids=["uniform-72", "trap-72", "gradient-72", "uniform-16", "gradient-16"],
)
def test_engine_steps_through_the_dispatched_wrapper(monkeypatch, ne, gap_expression, wrapper):
    from qpsim_tpu_torch.ops import collisions_blocked_cuda

    calls = {}
    for code, (real, build_tables) in list(collisions_blocked_cuda.KERNEL_STEPS.items()):
        def spy(*args, _real=real):
            calls[_real.__name__] = calls.get(_real.__name__, 0) + 1
            return _real(*args)

        monkeypatch.setitem(collisions_blocked_cuda.KERNEL_STEPS, code, (spy, build_tables))
    extra = dict(gap_expression=gap_expression) if gap_expression else {}
    T.run_2d_crank_nicolson(**_strip_kwargs("torch", num_energy_bins=ne, **extra), device="cpu")
    assert list(calls) == [wrapper] and calls[wrapper] > 0


def test_beyond_the_cap_cuda_raises_and_the_cpu_runs_plain(monkeypatch):
    """Past 256 bins the engine on CUDA dispatches K5 (under "auto" and the JAX
    name "pallas") instead of raising; this machine then stops it before any
    tensor reaches the card.  On the CPU it runs the plain version."""
    from qpsim_tpu_torch.solver import program_build

    class Dispatched(Exception):
        pass

    def spy(ne, n_gaps):
        raise Dispatched(collision_kernel_for(ne, n_gaps))

    kw = _strip_kwargs("torch", num_energy_bins=257, total_time=0.05, enable_scattering=False)
    monkeypatch.setattr(t_engine, "_resolve_device", lambda device: torch.device("cuda"))
    monkeypatch.setattr(program_build, "collision_kernel_for", spy)
    for backend in ("auto", "pallas"):
        with pytest.raises(Dispatched, match="^K5$"):
            T.run_2d_crank_nicolson(**kw, dtype=torch.float64, collision_backend=backend)
    monkeypatch.undo()
    before = dict(collisions_cuda.LAUNCHES)
    out = T.run_2d_crank_nicolson(**kw, device="cpu")
    assert np.all(np.isfinite(out[1][-1])) and collisions_cuda.LAUNCHES == before


# ---------------------------------------------------------------- (g) no JAX


def test_blocked_modules_are_in_the_no_jax_scan_and_import_no_jax():
    port = Path(T.__file__).resolve().parent
    scanned = set(port.rglob("*.py"))  # the files tests/test_torch_host_layer.py scans
    for rel in ("ops/collisions_blocked_cuda.py", "ops/collisions_cuda.py", "solver/program_build.py"):
        path = port / rel
        assert path in scanned
        tree = ast.parse(path.read_text())
        names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
        names += [n.module or "" for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.level == 0]
        assert not [m for m in names if m.split(".")[0] in ("jax", "jaxlib", "qpsim_tpu")], rel
