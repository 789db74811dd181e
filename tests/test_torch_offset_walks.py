"""The offset-walk collision substeps (K8, K9) against ``qpsim_tpu``.

Float64 on the CPU, where a step built by ``build_collision_step_loop``
(K8) or ``build_collision_step_rows`` (K9) runs its plain version, the
column walk ``collision_step_loop_plain``:

* against the JAX package's Pallas builders in interpret mode
  (``build_pallas_collision_step_loop``, ``build_pallas_collision_step_rows``)
  at that package's own tolerances (``tests/test_collisions.py``: q 1e-12,
  n_ph 1e-9): K8 on a uniform gap and with G = 3 and G = 9 gap ids at NE
  9 and 16, K9 over the four channel combinations at NE 11 (a split ω
  diagonal); K8 with G = 300 against K3's plain version;
* ``None`` exactly where the JAX builders return it;
* the host helpers and tables copied from the JAX package, pinned equal;
* each walk against K3's plain version (``collision_step_plain``), the same
  function, at NE 100 and at split diagonals;
* the CUDA kernel's walk (``csrc/offset_walk.cu``: tiles of 32·P pixels
  staged [NE][32·P], the register-blocked walk's dense tables and order,
  per-row column lists) through the NumPy transcription of
  ``tests/column_walk_transcription.py``;
* the wrappers on the CPU launch nothing, and the modules import no JAX.
"""

import ast
import inspect
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import qpsim_tpu.ops.pallas_collisions as j_pc  # noqa: E402
import qpsim_tpu.ops.pallas_collisions_loop as j_loop  # noqa: E402
from qpsim_tpu.ops.dos import dynes_density_of_states, thermal_phonon_occupation  # noqa: E402
from qpsim_tpu.ops.energy_grid import build_energy_grid  # noqa: E402
from qpsim_tpu.ops.kernels import recombination_kernel_base, scattering_kernel_base  # noqa: E402
from qpsim_tpu.ops.pallas_collisions_rows import build_pallas_collision_step_rows  # noqa: E402
from qpsim_tpu.ops.phonon_map import build_phonon_frequency_map  # noqa: E402

import qpsim_tpu_torch as T  # noqa: E402
from qpsim_tpu_torch.interop import (  # noqa: E402
    collision_tables_from_numpy,
    phonon_map_from_numpy,
    state_to_numpy,
    state_to_torch,
)
from qpsim_tpu_torch.ops import collisions_cuda  # noqa: E402
from qpsim_tpu_torch.ops import collisions_loop_cuda as t_loop  # noqa: E402
from qpsim_tpu_torch.ops import collisions_rows_cuda as t_rows  # noqa: E402
from qpsim_tpu_torch.ops.column_walk import column_pixels  # noqa: E402
from qpsim_tpu_torch.ops.collisions import collision_step_plain  # noqa: E402

from column_walk_transcription import transcribe  # noqa: E402

NY, NX = 2, 6
DT = 0.02
TAU_S, TAU_R, T_C = 440.0, 520.0, 1.2


def _setup(ne, *, gaps=(180.0,), seed=0, ny=NY, nx=NX, e_max=4.0):
    """Host physics from the JAX package and a state."""
    E, dE = build_energy_grid(180.0, 1.0, e_max, ne)
    pm = build_phonon_frequency_map(E)
    rng = np.random.default_rng(seed)
    gid = None if len(gaps) == 1 else rng.integers(0, len(gaps), (ny, nx)).astype(np.int32)
    rho = np.stack([dynes_density_of_states(E, g, 0.0) for g in gaps])
    Ks = np.stack([scattering_kernel_base(E, g, TAU_S, T_C) for g in gaps])
    Kr = np.stack([recombination_kernel_base(E, g, TAU_R, T_C) for g in gaps])
    rho_px = rho[0][:, None, None] if gid is None else rho[gid].transpose(2, 0, 1)
    q = rng.uniform(0, 2e-3, (ne, ny, nx)) * rho_px
    ph = thermal_phonon_occupation(pm.omega_bins, 0.25)[:, None, None] * rng.uniform(
        0.5, 2.0, (pm.num_omega, ny, nx))
    one = lambda a: a[0] if len(gaps) == 1 else a
    return dict(E=E, dE=dE, pm=pm, tpm=phonon_map_from_numpy(pm.omega_bins, pm.idx_diff, pm.idx_sum,
                                                             pm.diff_sign),
                rho=one(rho), Ks=one(Ks), Kr=one(Kr), gid=gid, q=q, ph=ph)


def _args(s, *, scattering=True, recombination=True, phonons=True):
    return dict(E_bins=s["E"], dE=s["dE"], rho=s["rho"], K_s0=s["Ks"] if scattering else None,
                K_r0=s["Kr"] if recombination else None, dt=DT, update_phonons=phonons)


def _run(step, s):
    qt, pt = state_to_torch(s["q"], s["ph"], "cpu", torch.float64)
    return state_to_numpy(*step(qt, pt))


def _close(got, want, rtol_q=1e-12, rtol_ph=1e-9):
    np.testing.assert_allclose(got[0], want[0], rtol=rtol_q, atol=1e-22)
    np.testing.assert_allclose(got[1], want[1], rtol=rtol_ph, atol=1e-22)


def _k3_plain(s, *, scattering=True, recombination=True, phonons=True):
    """The same substep through K3's plain version (the port's gather integrator)."""
    rho = np.atleast_2d(s["rho"])
    plan = collision_tables_from_numpy(
        dE=s["dE"], rho=rho, K_s0=s["Ks"] if scattering else None,
        K_r0=s["Kr"] if recombination else None, omega_bins=s["pm"].omega_bins,
        idx_diff=s["pm"].idx_diff, idx_sum=s["pm"].idx_sum, diff_sign=s["pm"].diff_sign,
        enable_scattering=scattering, enable_recombination=recombination, update_phonons=phonons,
        device="cpu", dtype=torch.float64, gap_id=s["gid"])
    qt, pt = state_to_torch(s["q"], s["ph"], "cpu", torch.float64)
    return state_to_numpy(*collision_step_plain(plan, qt, pt, DT))


# ---------------------------------------------------------------- K8 against the JAX kernel


@pytest.mark.parametrize("ne", [9, 16])
@pytest.mark.parametrize("gaps", [(180.0,), (150.0, 165.0, 180.0)], ids=["uniform", "gap_ids"])
def test_loop_matches_jax_loop_interpret(ne, gaps):
    s = _setup(ne, gaps=gaps, seed=ne)
    pal = j_loop.build_pallas_collision_step_loop(**_args(s), pmap=s["pm"], tile=128, interpret=True,
                                                  gap_id=s["gid"])
    step = t_loop.build_collision_step_loop(**_args(s), pmap=s["tpm"], gap_id=s["gid"], device="cpu")
    assert pal is not None and step is not None
    assert step.counter == ("collision_step_loop" if len(gaps) == 1 else "collision_step_loop_gid")
    want = [np.asarray(a) for a in pal(jnp.asarray(s["q"]), jnp.asarray(s["ph"]))]
    _close(_run(step, s), want)


# ---------------------------------------------------------------- K9 against the JAX kernel


@pytest.mark.parametrize(
    "scattering,recombination,phonons",
    [(True, True, True), (True, False, True), (False, True, True), (True, True, False)],
    ids=["both", "scattering", "recombination", "frozen_phonons"],
)
def test_rows_matches_jax_rows_interpret_on_a_split_diagonal(scattering, recombination, phonons):
    s = _setup(11, seed=9)
    assert t_loop._uniform_pair_rows(np.asarray(s["E"]), s["tpm"]) is None  # NE 11 splits
    kw = _args(s, scattering=scattering, recombination=recombination, phonons=phonons)
    pal = build_pallas_collision_step_rows(**kw, pmap=s["pm"], tile=128, interpret=True)
    step = t_rows.build_collision_step_rows(**kw, pmap=s["tpm"], device="cpu")
    assert pal is not None and step is not None and step.counter == "collision_step_rows"
    want = [np.asarray(a) for a in pal(jnp.asarray(s["q"]), jnp.asarray(s["ph"]))]
    got = _run(step, s)
    _close(got, want)
    if not phonons:
        np.testing.assert_array_equal(got[1], s["ph"])


# ---------------------------------------------------------------- None and identity parity


def _nonuniform(s):
    E = s["E"].copy()
    E[3] += 0.3 * s["dE"]
    return dict(s, E=E, pm=build_phonon_frequency_map(E))


@pytest.mark.parametrize(
    "builder,ne,alter,declines",
    [("loop", 11, None, True), ("loop", 65, None, True), ("loop", 66, None, True),
     ("loop", 1, None, True), ("loop", 16, "nonuniform", True), ("loop", 16, None, False),
     ("rows", 73, None, True), ("rows", 72, None, False), ("rows", 1, None, True),
     ("rows", 16, "nonuniform", True), ("rows", 16, "per_gap_rho", True), ("rows", 66, None, False)],
)
def test_none_exactly_where_the_jax_builders_decline(builder, ne, alter, declines):
    s = _setup(ne)
    if alter == "nonuniform":
        s = _nonuniform(s)
    args = _args(s)
    if alter == "per_gap_rho":
        args["rho"] = np.stack([s["rho"], s["rho"]])
    tpm = phonon_map_from_numpy(s["pm"].omega_bins, s["pm"].idx_diff, s["pm"].idx_sum, s["pm"].diff_sign)
    if builder == "loop":
        jax_step = j_loop.build_pallas_collision_step_loop(**args, pmap=s["pm"], interpret=True)
        port = t_loop.build_collision_step_loop(**args, pmap=tpm, device="cpu")
    else:
        jax_step = build_pallas_collision_step_rows(**args, pmap=s["pm"], interpret=True)
        port = t_rows.build_collision_step_rows(**args, pmap=tpm, device="cpu")
    assert (jax_step is None) == declines
    assert (port is None) == declines


@pytest.mark.parametrize("builder", ["loop", "rows"])
def test_no_channel_is_the_identity(builder):
    s = _setup(16)
    build = t_loop.build_collision_step_loop if builder == "loop" else t_rows.build_collision_step_rows
    step = build(**_args(s, scattering=False, recombination=False), pmap=s["tpm"], device="cpu")
    q, ph = state_to_torch(s["q"], s["ph"], "cpu", torch.float64)
    out = step(q, ph)
    assert out[0] is q and out[1] is ph


def test_loop_nine_gap_ids_match_jax_loop_interpret():
    # the JAX builder blends any number of gaps; so does the port
    s = _setup(9, gaps=tuple(150.0 + 3.0 * g for g in range(9)), seed=1, ny=3, nx=8)
    assert len(np.unique(s["gid"])) == 9
    pal = j_loop.build_pallas_collision_step_loop(**_args(s), pmap=s["pm"], tile=128, interpret=True,
                                                  gap_id=s["gid"])
    step = t_loop.build_collision_step_loop(**_args(s), pmap=s["tpm"], gap_id=s["gid"], device="cpu")
    assert step.counter == "collision_step_loop_gid"
    want = [np.asarray(a) for a in pal(jnp.asarray(s["q"]), jnp.asarray(s["ph"]))]
    _close(_run(step, s), want)


def test_loop_300_gap_ids_equal_k3_plain_version():
    # more gaps than one byte can name
    s = _setup(9, gaps=tuple(140.0 + 0.1 * g for g in range(300)), seed=2, ny=4, nx=8)
    step = t_loop.build_collision_step_loop(**_args(s), pmap=s["tpm"], gap_id=s["gid"], device="cpu")
    np.testing.assert_array_equal(step.tables(torch.float64).gid.numpy(), s["gid"].reshape(-1))
    _close(_run(step, s), _k3_plain(s), 1e-12, 1e-12)


# ---------------------------------------------------------------- host helpers pinned equal


@pytest.mark.parametrize("ne", [9, 11, 16, 72])
def test_host_helpers_equal_the_jax_packages(ne):
    s = _setup(ne)
    e = np.asarray(s["E"])
    assert t_loop._grid_uniform(e) == j_pc._grid_uniform(e)
    assert t_loop._grid_uniform(_nonuniform(s)["E"]) == j_pc._grid_uniform(_nonuniform(s)["E"])
    assert t_loop._uniform_pair_rows(e, s["tpm"]) == j_pc._uniform_pair_rows(e, s["pm"])
    for n, m in ((ne, 8), (ne, 128), (2 * ne - 1, 128)):
        assert t_loop._round_up(n, m) == j_loop._round_up(n, m)
    ne_pad, kp, sp = j_loop._round_up(ne, 8), 128, j_loop._round_up(2 * ne - 1, 128)
    for a, b in zip(t_loop._offset_tables(s["Ks"], ne, ne_pad, kp),
                    j_loop._offset_tables(s["Ks"], ne, ne_pad, kp)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(t_loop._antidiag_table(s["Kr"], ne, ne_pad, sp),
                                  j_loop._antidiag_table(s["Kr"], ne, ne_pad, sp))


def test_loop_walk_tables_are_the_offset_tables_scaled():
    s = _setup(16, gaps=(150.0, 180.0), seed=3)
    step = t_loop.build_collision_step_loop(**_args(s), pmap=s["tpm"], gap_id=s["gid"], device="cpu")
    w = step.walk
    diff_row, sum_row = j_pc._uniform_pair_rows(np.asarray(s["E"]), s["pm"])
    np.testing.assert_array_equal(w.scat_k, np.arange(1, 16))
    np.testing.assert_array_equal(w.scat_row, diff_row[1:])
    np.testing.assert_array_equal(w.rec_row, sum_row)
    for g in range(2):
        for got, want in zip(w.scat, j_loop._offset_tables(s["Ks"][g], 16, 16, 16)):
            np.testing.assert_array_equal(got[g], s["dE"] * want[:, 1:])
        np.testing.assert_array_equal(w.rec[g], 2.0 * s["dE"] * j_loop._antidiag_table(s["Kr"][g], 16, 16, 31))
    np.testing.assert_array_equal(w.gap_id, s["gid"].reshape(-1))


@pytest.mark.parametrize("ne", [11, 16])
def test_rows_grouping_equals_the_jax_builders(ne):
    s = _setup(ne)
    pal = build_pallas_collision_step_rows(**_args(s), pmap=s["pm"], interpret=True)
    jv = inspect.getclosurevars(pal).nonlocals
    kv = inspect.getclosurevars(jv["kernel"]).nonlocals
    scat_cols, tabs = t_rows._scattering_columns(s["Ks"], s["pm"].idx_diff, ne, ne)
    rec_cols, r_tab = t_rows._recombination_columns(s["Kr"], s["pm"].idx_sum, ne, ne)
    assert scat_cols == kv["scat_cols"] and rec_cols == kv["rec_cols"]
    for got, name in zip(tabs, ("e_up", "e_dn", "a_up", "a_dn")):
        want = jv[name]
        np.testing.assert_array_equal(got, want[:ne, : len(scat_cols)])
        assert not want[ne:].any() and not want[:, len(scat_cols):].any()
    np.testing.assert_array_equal(r_tab, jv["r_tab"][:ne, : len(rec_cols)])
    if ne == 11:  # a split diagonal: more columns than offsets / anti-diagonals
        assert len(scat_cols) > ne - 1 or len(rec_cols) > 2 * ne - 1


# ---------------------------------------------------------------- the walks against K3's plain version


@pytest.mark.parametrize(
    "ne,gaps,builder",
    [(100, (180.0,), "loop"), (100, (150.0, 165.0, 180.0), "loop"), (100, (180.0,), "rows"),
     (66, (180.0,), "rows"), (72, (180.0,), "loop")],
    ids=["loop-100", "loop-100-gap_ids", "rows-100", "rows-66-split", "loop-72-shared_rows"],
)
def test_walk_equals_k3_plain_version(ne, gaps, builder):
    s = _setup(ne, gaps=gaps, seed=ne, ny=1, nx=3)
    if builder == "loop":
        step = t_loop.build_collision_step_loop(**_args(s), pmap=s["tpm"], gap_id=s["gid"], device="cpu")
    else:  # K9's columns without the builder's 72-bin cap
        step = t_loop.WalkStep(t_rows.rows_walk(**_args(s), pmap=s["tpm"]), "cpu", "collision_step_rows")
    got = _run(step, s)
    _close(got, _k3_plain(s), 1e-12, 1e-12)


# ---------------------------------------------------------------- the CUDA kernel's walk


def _walk_transcription(walk, tables, q, ph):
    """``csrc/offset_walk.cu`` in NumPy (``tests/column_walk_transcription.py``)
    at the float32 launch's pixels per lane, without a generation plane."""
    pixels = column_pixels(torch.float32, walk.num_energy_bins, np.size(q) // walk.num_energy_bins,
                           uniform=walk.gap_id is None)
    return transcribe(tables, q, ph, None, walk.dt, walk.update_phonons, pixels)


@pytest.mark.parametrize(
    "ne,gaps,builder,scattering,recombination,phonons",
    [(16, (180.0,), "loop", True, True, True), (16, (150.0, 165.0, 180.0), "loop", True, True, True),
     (16, (180.0,), "loop", False, True, True), (11, (180.0,), "rows", True, True, True),
     (11, (180.0,), "rows", True, False, False), (72, (180.0,), "loop", True, True, True),
     (100, (180.0,), "loop", True, True, True), (100, (150.0, 165.0, 180.0), "loop", True, True, True),
     (66, (180.0,), "rows", True, True, True), (72, (180.0,), "rows", True, True, False),
     (24, (180.0,), "loop", False, True, True)],
    ids=["loop", "loop-gap_ids", "loop-recombination", "rows-split", "rows-scattering-frozen",
         "loop-72-shared_rows", "loop-100", "loop-100-gap_ids", "rows-66-split",
         "rows-72-frozen", "loop-24-recombination"],
)
def test_kernel_walk_reproduces_the_plain_version(ne, gaps, builder, scattering, recombination, phonons):
    # a full tile of 32·P pixels and a ragged one
    tile = 32 * column_pixels(torch.float32, ne, 2)
    s = _setup(ne, gaps=gaps, seed=ne + 1, ny=1, nx=tile + (38 if ne < 72 else 6))
    kw = _args(s, scattering=scattering, recombination=recombination, phonons=phonons)
    if builder == "loop":
        step = t_loop.build_collision_step_loop(**kw, pmap=s["tpm"], gap_id=s["gid"], device="cpu")
    else:
        step = t_rows.build_collision_step_rows(**kw, pmap=s["tpm"], device="cpu")
    if ne == 72:  # ω rows that carry both a difference and a sum
        row_ptr, row_code = step.walk.row_lists()
        kinds = [set(row_code[a:b] & 1) for a, b in zip(row_ptr[:-1], row_ptr[1:])]
        assert {0, 1} in kinds
    tables = step.tables(torch.float64)
    got = _walk_transcription(step.walk, tables, s["q"], s["ph"])
    _close(got, _run(step, s), 1e-12, 1e-12)
    if not phonons:
        np.testing.assert_array_equal(got[1], s["ph"])


# ---------------------------------------------------------------- devices, launches, imports


def test_wrappers_run_plain_on_cpu_and_launch_nothing():
    s = _setup(16, gaps=(160.0, 180.0), seed=2)
    before = dict(collisions_cuda.LAUNCHES)
    step = t_loop.build_collision_step_loop(**_args(s), pmap=s["tpm"], gap_id=s["gid"], device="cpu")
    qt, pt = state_to_torch(s["q"], s["ph"], "cpu", torch.float64)
    a = step(qt, pt)
    b = t_loop.collision_step_loop_plain(step, qt, pt)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
    s1 = _setup(11, seed=4)
    rows = t_rows.build_collision_step_rows(**_args(s1), pmap=s1["tpm"], device="cpu")
    q1, p1 = state_to_torch(s1["q"], s1["ph"], "cpu", torch.float64)
    for x, y in zip(rows(q1, p1), t_rows.collision_step_rows_plain(rows, q1, p1)):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
    assert collisions_cuda.LAUNCHES == before
    assert before["collision_step_loop"] == before["collision_step_rows"] == 0
    np.testing.assert_array_equal(qt.numpy(), s["q"])  # inputs untouched


def test_steps_run_only_on_their_device():
    s = _setup(9)
    step = t_loop.build_collision_step_loop(**_args(s), pmap=s["tpm"])  # device="cuda", the default
    qt, pt = state_to_torch(s["q"], s["ph"], "cpu", torch.float64)
    with pytest.raises(ValueError, match="built for cuda"):
        step(qt, pt)
    cpu = t_loop.build_collision_step_loop(**_args(s), pmap=s["tpm"], device="cpu")
    with pytest.raises(ValueError, match=r"n_ph must be"):
        cpu(qt, pt[:-1])


def test_offset_walk_modules_are_in_the_no_jax_scan_and_import_no_jax():
    port = Path(T.__file__).resolve().parent
    scanned = set(port.rglob("*.py"))  # the files tests/test_torch_host_layer.py scans
    for rel in ("ops/collisions_loop_cuda.py", "ops/collisions_rows_cuda.py", "ops/column_walk.py",
                "interop.py"):
        path = port / rel
        assert path in scanned
        tree = ast.parse(path.read_text())
        names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
        names += [n.module or "" for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.level == 0]
        assert not [m for m in names if m.split(".")[0] in ("jax", "jaxlib", "qpsim_tpu")], rel
    assert (port / "csrc" / "offset_walk.cu").is_file()
