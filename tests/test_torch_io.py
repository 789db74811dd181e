"""The port's I/O layer against ``qpsim_tpu``'s, and checkpoint/resume on the port.

Files cross both ways: setups of several kinds (a plain one, a gap
expression, an initial-condition spec, custom generation, a photon drive,
a precompute sidecar), simulation JSONs, test suites with sidecar groups
and frame streams, each written by one package and read by the other.
Resume mirrors ``tests/test_checkpoint.py`` on the port, bit for bit, and
a run begun on the JAX package (orbax checkpoints) is resumed on the port.
Everything runs on the CPU in float64.
"""

import json

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from qpsim_tpu.fields import default_initial_condition  # noqa: E402
from qpsim_tpu.geometry.mask import create_intrinsic_geometry  # noqa: E402
from qpsim_tpu.io import storage as j_storage  # noqa: E402
from qpsim_tpu.io import stream as j_stream  # noqa: E402
from qpsim_tpu.io.precompute import precompute_arrays  # noqa: E402
from qpsim_tpu.models import params as jp  # noqa: E402
from qpsim_tpu.solver import stepping as j_stepping  # noqa: E402
from qpsim_tpu.solver.engine import run_2d_crank_nicolson as j_run  # noqa: E402

import qpsim_tpu_torch as T  # noqa: E402
from qpsim_tpu_torch.geometry.mask import extract_edge_segments  # noqa: E402
from qpsim_tpu_torch.io import paths as t_paths  # noqa: E402
from qpsim_tpu_torch.io import storage as t_storage  # noqa: E402
from qpsim_tpu_torch.io import stream as t_stream  # noqa: E402
from qpsim_tpu_torch.io.checkpoint import SimulationCheckpointer  # noqa: E402
from qpsim_tpu_torch.models import params as tp  # noqa: E402
from qpsim_tpu_torch.solver import stepping as t_stepping  # noqa: E402

# --------------------------------------------------------------------------- files


def _jax_setup(kind: str) -> jp.SetupData:
    geo = create_intrinsic_geometry(width=16, height=12)
    bcs = {e.edge_id: jp.BoundaryCondition(kind="dirichlet", value=0.5) for e in geo.edges}
    params = dict(diffusion_coefficient=6.0, dt=0.1, total_time=1.0, mesh_size=1.0,
                  energy_gap=180.0, energy_max_factor=4.0, num_energy_bins=8)
    ic = default_initial_condition()
    if kind == "gap_expression":
        params["gap_expression"] = "return 180.0 - 20.0 * (x < 0.5)"
    elif kind == "ic_spec":
        ic = jp.InitialConditionSpec(
            spatial_kind="gaussian", spatial_params={"amplitude": 1e-5, "x0": 0.3, "sigma": 0.2},
            energy_kind="fermi_dirac", phonon_spatial_kind="uniform",
            phonon_energy_kind="bose_einstein")
    elif kind == "custom_generation":
        params["external_generation"] = jp.ExternalGenerationSpec(
            mode="custom", custom_body="return 1e-6 * np.exp(-E / 300.0) * (t < 0.5)",
            custom_params={"g0": 2.0})
    elif kind == "photon_drive":
        params["photon_drive"] = [
            jp.PhotonDriveSpec(mode="photon", photon_energy=468.0, occupancy=2.0, coupling=2e-5,
                               window_start=0.1, window_duration=0.5),
            jp.PhotonDriveSpec(mode="none"),
            jp.PhotonDriveSpec(mode="photon", photon_energy=135.0, include_pair_breaking=False),
        ]
    return jp.SetupData(setup_id="abc123def456", name=f"My {kind} #1",
                        created_at="2026-08-16T00:00:00+00:00", geometry=geo,
                        boundary_conditions=bcs, parameters=jp.SimulationParameters(**params),
                        initial_condition=ic)


SETUP_KINDS = ["plain", "gap_expression", "ic_spec", "custom_generation", "photon_drive",
               "precompute_sidecar"]


@pytest.mark.parametrize("kind", SETUP_KINDS)
def test_setup_files_cross_both_ways(tmp_path, kind):
    setup = _jax_setup(kind)
    jax_path = j_storage.save_setup(setup, tmp_path / "jax" / "setup.json")
    ported = t_storage.load_setup(jax_path)
    assert isinstance(ported, tp.SetupData)
    assert t_storage.serialize_setup(ported) == j_storage.serialize_setup(j_storage.load_setup(jax_path))
    port_path = t_storage.save_setup(ported, tmp_path / "port" / "setup.json")
    assert port_path.read_text() == jax_path.read_text()  # byte-identical
    back = j_storage.load_setup(port_path)
    assert j_storage.serialize_setup(back) == t_storage.serialize_setup(ported)
    if kind == "precompute_sidecar":
        mask = np.asarray(setup.geometry.mask, dtype=bool)
        arrays = precompute_arrays(mask, setup.geometry.edges, setup.boundary_conditions,
                                   setup.parameters, include_collision_kernels=False)
        j_storage.save_precomputed(jax_path, arrays)
        assert t_storage.precomputed_exists(jax_path)
        assert t_storage.precompute_npz_path(jax_path) == j_storage.precompute_npz_path(jax_path)
        loaded = t_storage.load_precomputed(jax_path)
        assert sorted(loaded) == sorted(arrays)
        for k in arrays:
            np.testing.assert_array_equal(loaded[k], np.asarray(arrays[k]))
        t_storage.save_precomputed(port_path, loaded)
        again = j_storage.load_precomputed(port_path)
        for k in arrays:
            np.testing.assert_array_equal(again[k], np.asarray(arrays[k]))


def test_damaged_files_raise_value_error_like_the_jax_package(tmp_path):
    path = tmp_path / "bad.json"
    path.write_text(json.dumps({"setup_id": "x", "name": "n"}))
    for loader in (j_storage.load_setup, t_storage.load_setup):
        with pytest.raises(ValueError, match="Corrupt or invalid setup"):
            loader(path)
    (tmp_path / "bad.precompute.npz").write_bytes(b"PK\x03\x04 truncated")
    for loader in (j_storage.load_precomputed, t_storage.load_precomputed):
        with pytest.raises(ValueError, match="Corrupt precompute sidecar"):
            loader(path)


def _simulation(cls):
    frame = [[1.0, None], [None, -2.5]]
    return cls(simulation_id="sim0000000a1", setup_id="abc123def456", setup_name="My Setup",
               created_at="2026-08-16T00:00:00+00:00", times=[0.0, 0.5], frames=[frame, frame],
               mass_over_time=[1.0, 0.9], color_limits=[-2.5, 1.0],
               metadata={"energy_qp_total": [1.0, 2.0], "diagnostics_mode": "open_system"},
               energy_frames=[[frame], [frame]], energy_bins=[200.0],
               phonon_frames=[frame, frame], phonon_energy_frames=[[frame], [frame]],
               phonon_energy_bins=[10.0], phonon_metadata={"mode": "dynamic_local_coupled"})


def test_simulation_files_cross_both_ways(tmp_path):
    jax_path = j_storage.save_simulation(_simulation(jp.SimulationResultData), tmp_path / "a.json")
    ported = t_storage.load_simulation(jax_path)
    assert t_storage.serialize_simulation(ported) == j_storage.serialize_simulation(
        j_storage.load_simulation(jax_path))
    port_path = t_storage.save_simulation(ported, tmp_path / "b.json")
    assert port_path.read_text() == jax_path.read_text()
    assert T.load_simulation(port_path) == ported


def _suite(p):
    def case(cid, view):
        return p.TestCaseResultData(
            case_id=cid, title=cid.title(), boundary_label="Reflective", formula_latex="u=1",
            initial_condition_latex="u_0=1", description="d", x=[0.5, 1.5], times=[0.0, 1.0],
            simulated=[[1.0, 0.9], [0.8, None]], analytic=[[1.0, 0.9], [0.8, 0.7]],
            metadata={"geometry_id": view})
    groups = [
        p.TestGeometryGroupData(geometry_id="strip_1d_effective", title="Strip", description="s",
                                view_mode="line1d", preview_mask=[[0, 1], [1, 0]],
                                cases=[case("a", "strip_1d_effective"), case("b", "strip_1d_effective")]),
        p.TestGeometryGroupData(geometry_id="scattering/../odd id", title="Scat", description="t",
                                view_mode="timeseries", preview_mask=[[1]], cases=[case("c", "scattering")]),
    ]
    return p.TestSuiteData(suite_id="suite0000001", created_at="2026-08-16T00:00:00+00:00",
                           cases=[], geometry_groups=groups, metadata={"format_version": 3, "note": "x"})


def _suite_tree(path):
    root = path.parent
    return {str(f.relative_to(root)): f.read_text() for f in sorted(root.rglob("*.json"))}


def test_test_suite_files_cross_both_ways(tmp_path):
    assert t_storage.TEST_SUITE_FORMAT_VERSION == j_storage.TEST_SUITE_FORMAT_VERSION
    jax_path = j_storage.save_test_suite(_suite(jp), tmp_path / "jax" / "suite.json")
    ported = t_storage.load_test_suite(jax_path)
    assert len(ported.cases) == 3 and [g.case_count for g in ported.geometry_groups] == [2, 1]
    port_path = t_storage.save_test_suite(ported, tmp_path / "port" / "suite.json")
    # the manifest and its sidecar group files are byte-identical
    assert _suite_tree(port_path) == _suite_tree(jax_path)
    back = j_storage.load_test_suite(port_path)
    assert [c.case_id for c in back.cases] == ["a", "b", "c"]
    lazy = t_storage.load_test_suite(jax_path, load_group_cases=False)
    assert [len(g.cases) for g in lazy.geometry_groups] == [0, 0]
    group = t_storage.load_test_geometry_group(jax_path, "strip_1d_effective")
    assert [c.case_id for c in group.cases] == ["a", "b"]
    # the sidecar path-escape guard
    manifest = json.loads(jax_path.read_text())
    manifest["geometry_groups"][0]["group_file"] = "../escape.json"
    jax_path.write_text(json.dumps(manifest))
    for load_group in (j_storage.load_test_geometry_group, t_storage.load_test_geometry_group):
        with pytest.raises(ValueError, match="escapes suite directory"):
            load_group(jax_path, "strip_1d_effective")


def test_data_layout_is_the_jax_packages():
    from qpsim_tpu.io import paths as j_paths

    for name in ("BASE_DIR", "DATA_DIR", "SETUPS_DIR", "SIMULATIONS_DIR", "TEST_CASES_DIR"):
        assert getattr(t_paths, name) == getattr(j_paths, name)


# --------------------------------------------------------------------------- streams


def _write_stream(mod, directory, n_frames=3, light=False):
    rng = np.random.default_rng(7)
    frames = []
    with mod.FrameStreamWriter(directory, energy_bins=np.linspace(200, 600, 4),
                               metadata={"simulation_id": "s1", "setup_name": "x"}) as w:
        for i in range(n_frames):
            frame = rng.uniform(0, 1, (3, 5))
            frame[0, 0] = np.nan
            extra = (dict(energy_bin_sums=rng.uniform(0, 1, 4), phonon_bin_sums=rng.uniform(0, 1, 6))
                     if light else
                     dict(energy_frames=list(rng.uniform(0, 1, (4, 3, 5))),
                          phonon_frame=rng.uniform(0, 1, (3, 5)),
                          phonon_energy_frames=list(rng.uniform(0, 1, (6, 3, 5)))))
            w.write(i, 0.5 * i, frame=frame, mass=float(np.nansum(frame)), **extra)
            frames.append(frame)
    return frames


@pytest.mark.parametrize("light", [False, True], ids=["full", "light"])
def test_stream_writers_write_the_same_files(tmp_path, light):
    a = _write_stream(j_stream, tmp_path / "jax", light=light)
    b = _write_stream(t_stream, tmp_path / "port", light=light)
    ja = json.loads((tmp_path / "jax" / "manifest.json").read_text())
    tb = json.loads((tmp_path / "port" / "manifest.json").read_text())
    assert ja == tb
    for reader_mod, directory, frames in ((t_stream, tmp_path / "jax", a), (j_stream, tmp_path / "port", b)):
        r = reader_mod.load_frame_stream(directory)
        other = (j_stream if reader_mod is t_stream else t_stream).load_frame_stream(directory)
        assert (r.times, r.mass_over_time, r.color_limits) == (other.times, other.mass_over_time,
                                                               other.color_limits)
        for i, f in enumerate(frames):
            np.testing.assert_array_equal(r.frame(i), f)
            for acc in ("energy_frames", "phonon_frame", "phonon_energy_frames", "energy_bin_sums",
                        "phonon_bin_sums"):
                x, y = getattr(r, acc)(i), getattr(other, acc)(i)
                assert (x is None) == (y is None)
                if x is not None:
                    np.testing.assert_array_equal(x, y)
        res = r.to_result_data()
        assert res.simulation_id == "s1" and len(res.frames) == len(frames)


def test_stream_refuses_interrupted_and_damaged_like_the_jax_package(tmp_path):
    w = t_stream.FrameStreamWriter(tmp_path / "s")
    w.write(0, 0.0, frame=np.ones((2, 2)), mass=4.0)
    for mod in (t_stream, j_stream):
        with pytest.raises(ValueError, match="not a finalized frame stream"):
            mod.load_frame_stream(tmp_path / "s")
    w.write(2, 1.0, frame=np.ones((2, 2)), mass=4.0)
    with pytest.raises(ValueError, match="non-contiguous"):
        w.finalize()
    with pytest.raises(ValueError, match="empty frame stream"):
        t_stream.FrameStreamWriter(tmp_path / "e").finalize()


@pytest.mark.parametrize("shape,store_every,bins,ph", [((64, 64), 10, 0, False),
                                                       ((1024, 1024), 10, 16, True),
                                                       ((33, 7), 3, 100, False)])
def test_estimate_history_memory_is_the_jax_packages(shape, store_every, bins, ph):
    kw = dict(grid_shape=shape, dt=0.05, total_time=5.0, store_every=store_every,
              num_energy_bins=bins, record_phonons=ph)
    assert t_stream.estimate_history_memory(**kw) == j_stream.estimate_history_memory(**kw)


def _engine_problem(pkg, **over):
    mask = np.ones((3, 8), dtype=bool)
    mask[0, 0] = False
    edges = extract_edge_segments(mask)
    bc = (jp if pkg == "jax" else tp).BoundaryCondition
    init = np.zeros(mask.shape)
    init[mask] = 1e-4 * (1.0 + 0.3 * np.sin(np.arange(mask.sum())))
    kw = dict(mask=mask, edges=edges, edge_conditions={e.edge_id: bc(kind="reflective") for e in edges},
              initial_field=init, diffusion_coefficient=6.0, dt=0.05, total_time=0.6, dx=1.0,
              store_every=3, energy_gap=180.0, energy_min_factor=1.0, energy_max_factor=3.0,
              num_energy_bins=5, enable_recombination=True, enable_scattering=True,
              bath_temperature=0.2, strang_mode="exact")
    kw.update(over)
    return kw


@pytest.mark.parametrize("detail", ["full", "integrated"])
def test_engine_streams_cross_both_ways(tmp_path, detail):
    """Each engine streams through its own writer; the other package reads it."""
    runs = {}
    for pkg, run, mod in (("jax", j_run, j_stream), ("port", T.run_2d_crank_nicolson, t_stream)):
        ph: dict = {}
        extra = {"device": "cpu"} if pkg == "port" else {}
        with mod.FrameStreamWriter(tmp_path / pkg) as w:
            out = run(**_engine_problem(pkg), frame_sink=w, phonon_history_out=ph,
                      snapshot_detail=detail, **extra)
        assert out[1] == [] and out[4] is None
        assert ph["phonon_metadata"]["streamed"] is True
        runs[pkg] = out
    port_reads_jax = t_stream.load_frame_stream(tmp_path / "jax")
    jax_reads_port = j_stream.load_frame_stream(tmp_path / "port")
    assert port_reads_jax.times == jax_reads_port.times == runs["jax"][0]
    np.testing.assert_allclose(jax_reads_port.mass_over_time, port_reads_jax.mass_over_time, rtol=1e-12)
    np.testing.assert_allclose(runs["port"][3], runs["jax"][3], rtol=1e-12)
    assert jax_reads_port.color_limits == runs["port"][3]  # manifest and engine agree, bit for bit
    assert (jax_reads_port.has_energy_frames, jax_reads_port.has_phonon_frames) == (
        port_reads_jax.has_energy_frames, port_reads_jax.has_phonon_frames)
    for i in range(len(port_reads_jax)):
        np.testing.assert_allclose(jax_reads_port.frame(i), port_reads_jax.frame(i), rtol=1e-10)
        for acc in ("energy_frames", "phonon_energy_frames", "energy_bin_sums", "phonon_bin_sums"):
            x, y = getattr(jax_reads_port, acc)(i), getattr(port_reads_jax, acc)(i)
            assert (x is None) == (y is None), acc
            if x is not None:
                np.testing.assert_allclose(x, y, rtol=1e-10, atol=1e-300)


def test_widen_color_limits_has_one_definition():
    assert t_stepping.widen_color_limits is t_stream.widen_color_limits
    for lo, hi in ((0.0, 1.0), (2.0, 2.0), (1.0, 1.0 + 1e-13)):
        assert t_stream.widen_color_limits(lo, hi) == j_stream.widen_color_limits(lo, hi)
        assert t_stepping._limits_from_running([lo, hi]) == j_stepping._limits_from_running([lo, hi])


# --------------------------------------------------------------------------- checkpoints


def test_checkpointer_files_are_plain_tensors_in_their_dtype(tmp_path):
    ck = SimulationCheckpointer(tmp_path / "ck")
    q32 = np.arange(6, dtype=np.float32).reshape(1, 2, 3)
    ck.save_step(0, step=0, time_ns=0.0, q=q32, ph=torch.ones(2, 2, 3, dtype=torch.float32))
    ck.save_step(1, step=3, time_ns=0.15, q=q32.astype(np.float64) + 1)
    ck.save_step(2, step=6, time_ns=0.3, q=torch.as_tensor(q32) + 2)
    assert ck.all_steps() == [0, 1, 2]
    assert not list((tmp_path / "ck").glob("*.tmp"))
    raw = torch.load(tmp_path / "ck" / "step_000000.pt", weights_only=True)
    assert raw["q"].dtype == torch.float32 and raw["step"] == 0 and isinstance(raw["time_ns"], float)
    first = ck.restore(0)
    assert first["q"].dtype == np.float32 and first["ph"].shape == (2, 2, 3)
    np.testing.assert_array_equal(first["q"], q32)
    assert ck.restore(1)["q"].dtype == np.float64 and "ph" not in ck.restore(1)
    assert ck.latest()["step"] == 6 and ck.latest()["stored_idx"] == 2
    assert [p["step"] for p in ck.load_through(1)] == [0, 3]
    ck.discard_from(1)
    assert ck.all_steps() == [0]
    assert SimulationCheckpointer(tmp_path / "empty").latest() is None


class _Listed:
    """A checkpointer stand-in: stored steps and the discards asked of it."""

    def __init__(self, steps):
        self.steps = list(steps)
        self.restored = []

    def all_steps(self):
        return list(range(len(self.steps)))

    def restore(self, i):
        self.restored.append(i)
        return {"stored_idx": i, "step": self.steps[i], "time_ns": 0.05 * self.steps[i]}

    def discard_from(self, i):
        self.steps = self.steps[:i]


@pytest.mark.parametrize("steps,plan", [
    ([], (12, 0.0, 3)), ([0, 3, 6], (12, 0.0, 3)), ([0, 3, 5], (12, 0.0, 3)),
    ([0, 3, 6, 9, 12], (6, 0.0, 3)), ([0, 2, 4], (12, 0.0, 3)), ([0, 3, 6, 7], (7, 0.0, 3)),
    ([0, 3, 6, 7], (7, 0.02, 3)), ([0, 25, 50, 62], (100, 0.0, 25)),
])
def test_usable_resume_prefix_decides_as_the_jax_package(steps, plan):
    full, rem, every = plan
    results = []
    for mod in (j_stepping, t_stepping):
        ck = _Listed(steps)
        usable = mod._usable_resume_prefix(ck, mod._plan_segments(full, rem, 0.05, every))
        results.append(([u["step"] for u in usable], ck.steps, ck.restored))
    assert results[0] == results[1]


def _compare(a, b):
    """Bit-exact, as ``tests/test_checkpoint.py``'s ``_compare``."""
    np.testing.assert_allclose(a[0], b[0], atol=0)
    assert a[2] == b[2]
    assert len(a[1]) == len(b[1])
    for fa, fb in zip(a[1], b[1]):
        np.testing.assert_array_equal(np.nan_to_num(fa), np.nan_to_num(fb))
    if a[4] is not None or b[4] is not None:
        for ta, tb in zip(a[4], b[4]):
            for ba, bb in zip(ta, tb):
                np.testing.assert_array_equal(np.nan_to_num(ba), np.nan_to_num(bb))


def _port_problem(**over):
    kw = _engine_problem("port", **over)
    kw.update(mask=np.ones((2, 10), dtype=bool), initial_field=np.full((2, 10), 1e-4))
    kw["edges"] = extract_edge_segments(kw["mask"])
    kw["edge_conditions"] = {e.edge_id: tp.BoundaryCondition(kind="reflective") for e in kw["edges"]}
    kw.pop("strang_mode")
    kw["device"] = "cpu"
    return kw


_SCALAR_DROP = ("energy_gap", "energy_min_factor", "energy_max_factor", "num_energy_bins",
                "enable_recombination", "enable_scattering")

RESUME_CASES = {
    # name: (engine keywords, interrupted horizon, stored steps after the interruption)
    "aligned": ({}, 0.3, [0, 3, 6]),
    "unaligned": ({}, 0.25, [0, 3, 5]),
    "scalar": ({"scalar": True}, 0.3, [0, 3, 6]),
    "fused_generation": ({"external_generation": tp.ExternalGenerationSpec(
        mode="pulse", pulse_start=0.1, pulse_duration=0.2, pulse_rate=2e-5)}, 0.3, [0, 3, 6]),
    "light": ({"snapshot_detail": "integrated"}, 0.3, [0, 3, 6]),
    "light_float32": ({"snapshot_detail": "integrated", "dtype": torch.float32}, 0.25, [0, 3, 5]),
    "float32_streamed": ({"dtype": torch.float32, "stream": True}, 0.25, [0, 3, 5]),
}


@pytest.mark.parametrize("case", list(RESUME_CASES))
def test_resume_reproduces_uninterrupted_run(tmp_path, case):
    over, horizon, interrupted_steps = RESUME_CASES[case]
    over = dict(over)
    kw = _port_problem()
    if over.pop("scalar", False):
        for k in _SCALAR_DROP:
            kw.pop(k)
    stream = over.pop("stream", False)
    kw.update(over)
    run = T.run_2d_crank_nicolson
    baseline = run(**kw)

    ck = SimulationCheckpointer(tmp_path / "ck")
    run(**{**kw, "total_time": horizon}, checkpointer=ck)
    assert [ck.restore(i)["step"] for i in ck.all_steps()] == interrupted_steps
    if stream:
        with t_stream.FrameStreamWriter(tmp_path / "s") as w:
            resumed = run(**kw, checkpointer=SimulationCheckpointer(tmp_path / "ck"), frame_sink=w)
        r = t_stream.load_frame_stream(tmp_path / "s")
        assert resumed[1] == [] and r.times == baseline[0] and r.mass_over_time == baseline[2]
        assert resumed[3] == baseline[3]
        for i, f in enumerate(baseline[1]):
            np.testing.assert_array_equal(r.frame(i), f)
            np.testing.assert_array_equal(np.stack(baseline[4][i]), r.energy_frames(i))
    else:
        resumed = run(**kw, checkpointer=SimulationCheckpointer(tmp_path / "ck"))
        _compare(baseline, resumed)
    # the interrupted run's forced final store was replaced by this run's aligned ones
    assert [ck.restore(i)["step"] for i in ck.all_steps()] == [0, 3, 6, 9, 12]


def test_resume_with_longer_history_and_complete_run(tmp_path):
    kw = _port_problem()
    run = T.run_2d_crank_nicolson
    ck = SimulationCheckpointer(tmp_path / "ck")
    first = run(**kw, checkpointer=ck)
    # fresh checkpointer: one stored index per stored frame, the latest the final state
    assert len(ck.all_steps()) == len(first[0])
    latest = ck.latest()
    assert latest["step"] == 12
    np.testing.assert_allclose(latest["time_ns"], 0.6, atol=1e-12)
    final = np.asarray(first[4][-1])
    np.testing.assert_array_equal(np.nan_to_num(final), latest["q"] * (final == final))
    # a complete run into the same checkpoints is a no-op replay
    _compare(first, run(**kw, checkpointer=SimulationCheckpointer(tmp_path / "ck")))
    # a shorter horizon replays only the prefix its own plan stores
    short = {**kw, "total_time": 0.3}
    _compare(run(**short), run(**short, checkpointer=SimulationCheckpointer(tmp_path / "ck")))


def test_a_run_begun_on_the_jax_package_resumes_on_the_port(tmp_path):
    ocp = pytest.importorskip("orbax.checkpoint")
    del ocp
    from qpsim_tpu.io.checkpoint import SimulationCheckpointer as JaxCheckpointer

    jkw = _engine_problem("jax")
    baseline = j_run(**jkw)
    jck = JaxCheckpointer(tmp_path / "orbax")
    j_run(**{**jkw, "total_time": 0.25}, checkpointer=jck)
    jck.finalize()
    ck = SimulationCheckpointer(tmp_path / "port")
    for i in jck.all_steps():
        payload = jck.restore(i)
        ck.save_step(i, step=payload["step"], time_ns=payload["time_ns"], q=payload["q"], ph=payload["ph"])
    resumed = T.run_2d_crank_nicolson(**_engine_problem("port"), device="cpu", checkpointer=ck)
    assert resumed[0] == baseline[0]
    np.testing.assert_allclose(resumed[2], baseline[2], rtol=1e-12, atol=0)
    for fa, fb in zip(resumed[1], baseline[1]):
        np.testing.assert_array_equal(np.isnan(fa), np.isnan(fb))
        np.testing.assert_allclose(np.nan_to_num(fa), np.nan_to_num(fb), rtol=1e-10, atol=0)
    for ta, tb in zip(resumed[4], baseline[4]):
        for ba, bb in zip(ta, tb):
            np.testing.assert_allclose(np.nan_to_num(ba), np.nan_to_num(bb), rtol=1e-10, atol=1e-300)
    # the replayed prefix (steps 0 and 3) is the JAX run's own state, reduced alike
    np.testing.assert_array_equal(np.nan_to_num(resumed[1][1]), np.nan_to_num(baseline[1][1]))
    assert [ck.restore(i)["step"] for i in ck.all_steps()] == [0, 3, 6, 9, 12]
