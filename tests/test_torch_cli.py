"""The port's command line (``python -m qpsim_tpu_torch``) beside ``qpsim_tpu``'s, on the CPU.

Each of the 13 ported subcommands through ``qpsim_tpu_torch.cli.main([...,
"--device", "cpu"])`` (``--device`` only where the command computes) and
``qpsim_tpu.cli.main`` on the same small setup, in float64:

* ``run`` and ``sweep``: the saved simulations equal at 1e-10, the exit
  codes and summaries equal; ``run --space-shards n`` saves the same
  simulation sharded, and refuses n = 0 and more shards than devices
  with exit code 2 and the JAX message before anything is written;
* ``precompute``, ``export-gds`` and ``gen-tests``: the files equal byte
  for byte (``gen-tests`` on a small suite in place of the generator's,
  with the arguments it was given);
* ``view`` and ``view-tests``: the same PNG files, byte for byte, from the
  same saved inputs; ``compare``, ``gds-info``, ``qubit-sweep`` and
  ``validate``: the same verdicts, numbers (1e-10) and exit codes;
* ``profile``: a trace written on the CPU;
* ``info``, the parser (every JAX option of these subcommands, its default
  and choices), the CUDA check (exit code 2 naming ``--device cpu``).
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from qpsim_tpu import cli as jcli
from qpsim_tpu.io.storage import save_setup as j_save_setup
from qpsim_tpu.io.storage import save_test_suite as j_save_test_suite
from qpsim_tpu.models import params as jp

from qpsim_tpu_torch import cli as tcli
from qpsim_tpu_torch.io.storage import load_simulation

COMMANDS = ("info", "validate", "run", "sweep", "precompute", "gen-tests", "gds-info", "export-gds",
            "compare", "profile", "view", "view-tests", "qubit-sweep", "bench")


def _setup(export_phonons=True, gap_expression=""):
    from qpsim_tpu.fields import default_initial_condition
    from qpsim_tpu.geometry.mask import create_intrinsic_geometry

    geo = create_intrinsic_geometry(width=16, height=10)
    params = jp.SimulationParameters(
        diffusion_coefficient=6.0, dt=0.05, total_time=0.3, mesh_size=1.0, store_every=2,
        energy_gap=180.0, energy_min_factor=1.0, energy_max_factor=3.0, num_energy_bins=6,
        enable_recombination=True, enable_scattering=True, bath_temperature=0.2,
        export_phonon_history=export_phonons, gap_expression=gap_expression,
        external_generation=jp.ExternalGenerationSpec(mode="pulse", pulse_start=0.0, pulse_duration=0.1,
                                                      pulse_rate=1e-5))
    ic = default_initial_condition()
    ic.spatial_kind = "uniform"
    ic.spatial_params = {"value": 1e-4}
    return jp.SetupData(
        setup_id="deadbeef0001", name="cli test", created_at="2026-08-16T00:00:00+00:00", geometry=geo,
        boundary_conditions={e.edge_id: jp.BoundaryCondition(kind="reflective") for e in geo.edges},
        parameters=params, initial_condition=ic)


def _both(argv_jax, argv_port, capsys):
    """(rc, stdout, stderr) of each package's main."""
    rc_j = jcli.main(argv_jax)
    out_j = capsys.readouterr()
    rc_t = tcli.main(argv_port)
    out_t = capsys.readouterr()
    return (rc_j, out_j.out, out_j.err), (rc_t, out_t.out, out_t.err)


def _close(a, b, rtol=1e-10):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    assert a.shape == b.shape
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    scale = max(float(np.nanmax(np.abs(a))) if a.size else 0.0, 1e-300)
    assert float(np.nanmax(np.abs(a - b))) / scale <= rtol if a.size else True


def _same_simulation(a, b):
    assert a.times == pytest.approx(b.times, rel=1e-12, abs=1e-15)
    _close(a.mass_over_time, b.mass_over_time)
    assert len(a.frames) == len(b.frames)
    _close(a.frames, b.frames)
    for attr in ("energy_frames", "phonon_frames"):
        va, vb = getattr(a, attr), getattr(b, attr)
        assert (va is None) == (vb is None), attr
        if va is not None:
            _close(va, vb)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The setup run once by each package's ``run`` (shared by the commands that read it)."""
    d = tmp_path_factory.mktemp("runs")
    setup_path = j_save_setup(_setup(), d / "s.json")
    rc_j = jcli.main(["run", str(setup_path), "--output", str(d / "jax.json")])
    rc_t = tcli.main(["run", str(setup_path), "--output", str(d / "port.json"), "--device", "cpu"])
    return dict(dir=d, setup=setup_path, rc=(rc_j, rc_t), jax=d / "jax.json", port=d / "port.json")


def _pngs(root: Path) -> dict:
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*.png"))}


# ---------------------------------------------------------------- parser


def test_parser_holds_every_jax_option_plus_device():
    jsub = next(a for a in jcli.build_parser()._actions if a.dest == "command").choices
    tsub = next(a for a in tcli.build_parser()._actions if a.dest == "command").choices
    assert sorted(tsub) == sorted(COMMANDS)
    assert set(jsub) == set(tsub)
    for name in COMMANDS:
        t_actions = {a.dest: a for a in tsub[name]._actions}
        for a in jsub[name]._actions:
            t = t_actions.get(a.dest)
            assert t is not None, (name, a.dest)
            assert t.option_strings == a.option_strings, (name, a.dest)
            if a.dest != "help":
                assert t.default == a.default, (name, a.dest)
                assert set(a.choices or ()) <= set(t.choices or ()), (name, a.dest)
        assert ("device" in t_actions) == (name in tcli.COMPUTES), name
        if name in tcli.COMPUTES:
            assert t_actions["device"].default == "cuda"
            assert t_actions["device"].choices == ("cuda", "cpu")


def test_info_and_the_cuda_check(capsys, tmp_path):
    (rc_j, out_j, _), (rc_t, out_t, _) = _both(["info"], ["info"], capsys)
    assert rc_j == rc_t == 0
    assert out_t.startswith("qpsim_tpu_torch ") and f"torch {torch.__version__}" in out_t
    assert "nvcc: " in out_t and "kernel library: " in out_t and "source hash " in out_t
    raster = [line for line in out_j.splitlines() if line.startswith("native GDS rasterizer")]
    assert raster and raster[0] in out_t.splitlines()
    if not torch.cuda.is_available():
        setup_path = j_save_setup(_setup(), tmp_path / "s.json")
        for argv in (["validate"], ["run", str(setup_path), "--output", str(tmp_path / "x.json")],
                     ["qubit-sweep"], ["gen-tests", "--output", str(tmp_path / "t.json")]):
            assert tcli.main(argv) == 2
            assert "--device cpu" in capsys.readouterr().err
        assert not list(tmp_path.glob("x*")) and not list(tmp_path.glob("t*"))


# ---------------------------------------------------------------- run, sweep, validate


def test_run_saves_the_same_simulation(runs):
    assert runs["rc"] == (0, 0)
    _same_simulation(load_simulation(runs["jax"]), load_simulation(runs["port"]))


@pytest.mark.parametrize("shards", ["2", "0", "devices+99"])
def test_run_space_shards_raises_before_writing(shards, tmp_path, capsys):
    """``run --space-shards n`` beside the JAX CLI: n = 2 (of the 8 CPU
    devices both packages count here) runs sharded and saves the same
    simulation; 0 and the device count + 99 exit 2 with the JAX message
    before anything is written."""
    import jax

    n = len(jax.devices()) + 99 if shards == "devices+99" else int(shards)
    setup_path = j_save_setup(_setup(), tmp_path / "s.json")
    argv = lambda pkg: ["run", str(setup_path), "--space-shards", str(n), "--output",
                        str(tmp_path / pkg / "sim.json"), "--checkpoint-dir", str(tmp_path / pkg / "ck")]
    (rc_j, out_j, err_j), (rc_t, out_t, err_t) = _both(argv("jax"), argv("port") + ["--device", "cpu"], capsys)
    assert rc_t == rc_j
    if n < 1 or n > len(jax.devices()):
        assert rc_t == 2 and err_t == err_j and "--space-shards" in err_t
        assert out_t == out_j
        assert not (tmp_path / "port").exists()
        return
    assert rc_t == 0
    assert f"space-sharded over {n} device(s)" in out_t.splitlines()
    assert f"space-sharded over {n} device(s)" in out_j.splitlines()
    _same_simulation(load_simulation(tmp_path / "port" / "sim.json"), load_simulation(tmp_path / "jax" / "sim.json"))


def test_run_streamed_integrated(tmp_path, capsys):
    from qpsim_tpu.io.stream import load_frame_stream as j_load_stream
    from qpsim_tpu_torch.io.stream import load_frame_stream

    setup_path = j_save_setup(_setup(export_phonons=False), tmp_path / "s.json")
    common = ["run", str(setup_path), "--no-save", "--snapshot-detail", "integrated"]
    (rc_j, out_j, _), (rc_t, out_t, _) = _both(
        common + ["--stream-dir", str(tmp_path / "js")],
        common + ["--stream-dir", str(tmp_path / "ts"), "--device", "cpu"], capsys)
    assert rc_j == rc_t == 0
    assert "frames streamed to" in out_j and "frames streamed to" in out_t
    a, b = j_load_stream(tmp_path / "js"), load_frame_stream(tmp_path / "ts")
    assert a.count == b.count and a.times == pytest.approx(b.times, rel=1e-12)
    for i in range(a.count):
        _close(a.frame(i), b.frame(i))


def test_sweep_matches(tmp_path, capsys):
    setup_path = j_save_setup(_setup(export_phonons=False), tmp_path / "s.json")
    vary = ["--vary", "bath_temperature=0.1,0.2", "--vary", "external_generation.pulse_rate=1e-5,2e-5",
            "--mode", "zip"]
    (rc_j, out_j, _), (rc_t, out_t, _) = _both(["sweep", str(setup_path), *vary, "--dry-run"],
                                               ["sweep", str(setup_path), *vary, "--dry-run"], capsys)
    assert rc_j == rc_t == 0 and out_j == out_t
    (rc_j, _, _), (rc_t, _, _) = _both(
        ["sweep", str(setup_path), *vary, "--out-dir", str(tmp_path / "j")],
        ["sweep", str(setup_path), *vary, "--out-dir", str(tmp_path / "t"), "--device", "cpu"], capsys)
    assert rc_j == rc_t == 0
    sj = json.loads((tmp_path / "j" / "sweep_summary.json").read_text())
    st = json.loads((tmp_path / "t" / "sweep_summary.json").read_text())
    assert sj["n_variants"] == st["n_variants"] == 2 and sj["n_failed"] == st["n_failed"] == 0
    for a, b in zip(sj["variants"], st["variants"]):
        assert a["overrides"] == b["overrides"]
        for key in ("mass_initial", "mass_peak", "mass_final"):
            _close(a[key], b[key])
        _same_simulation(load_simulation(a["result_path"]), load_simulation(b["result_path"]))
    # a bad axis: the same error and exit code
    (rc_j, _, err_j), (rc_t, _, err_t) = _both(["sweep", str(setup_path), "--vary", "nope=1,2"],
                                               ["sweep", str(setup_path), "--vary", "nope=1,2"], capsys)
    assert rc_j == rc_t == 2 and err_j == err_t


def test_validate_json_matches(capsys):
    (rc_j, out_j, _), (rc_t, out_t, _) = _both(["validate", "--json"], ["validate", "--json", "--device", "cpu"],
                                               capsys)
    assert rc_j == rc_t == 0
    a, b = json.loads(out_j), json.loads(out_t)
    assert a.keys() == b.keys() and a["overall_passed"] and b["overall_passed"]
    for name, section in a.items():
        if not isinstance(section, dict):
            continue
        assert section.keys() == b[name].keys(), name
        for key, value in section.items():
            if isinstance(value, (bool, str)) or value is None:
                assert b[name][key] == value, (name, key)
            elif np.asarray(value).dtype.kind in "fi":
                # a drift of 1e-16 against 2e-16 is no disagreement: roundoff-level values absolute
                np.testing.assert_allclose(b[name][key], value, rtol=1e-10, atol=1e-12, err_msg=f"{name}.{key}")


# ---------------------------------------------------------------- files


def test_precompute_sidecar_is_byte_equal(tmp_path, capsys):
    for pkg in ("j", "t"):
        (tmp_path / pkg).mkdir()
        j_save_setup(_setup(gap_expression="return 180.0 + 10.0 * x"), tmp_path / pkg / "s.json")
    (rc_j, out_j, _), (rc_t, out_t, _) = _both(
        ["precompute", str(tmp_path / "j" / "s.json"), "--kernels"],
        ["precompute", str(tmp_path / "t" / "s.json"), "--kernels"], capsys)
    assert rc_j == rc_t == 0 and out_j.replace("/j/", "/t/") == out_t
    assert (tmp_path / "j" / "s.precompute.npz").read_bytes() == (tmp_path / "t" / "s.precompute.npz").read_bytes()


def test_export_gds_and_gds_info(tmp_path, capsys):
    setup_path = j_save_setup(_setup(), tmp_path / "s.json")
    (rc_j, out_j, _), (rc_t, out_t, _) = _both(
        ["export-gds", str(setup_path), str(tmp_path / "j.gds"), "--layer", "3"],
        ["export-gds", str(setup_path), str(tmp_path / "t.gds"), "--layer", "3"], capsys)
    assert rc_j == rc_t == 0 and out_j.replace("j.gds", "t.gds") == out_t
    assert (tmp_path / "j.gds").read_bytes() == (tmp_path / "t.gds").read_bytes()
    (rc_j, out_j, _), (rc_t, out_t, _) = _both(["gds-info", str(tmp_path / "j.gds")],
                                               ["gds-info", str(tmp_path / "j.gds")], capsys)
    assert rc_j == rc_t == 0 and out_j == out_t and "layer 3:" in out_t
    (rc_j, _, err_j), (rc_t, _, err_t) = _both(["gds-info", str(tmp_path / "none.gds")],
                                               ["gds-info", str(tmp_path / "none.gds")], capsys)
    assert rc_j == rc_t == 2 and err_j == err_t


def _suite(models):
    """A small suite built from one package's dataclasses (``models``: its ``models.params``)."""
    def case(cid, mode, sim, ana, times):
        return models.TestCaseResultData(
            case_id=cid, title=cid, boundary_label="b", formula_latex="f", initial_condition_latex="i",
            description="d", x=[0.5, 1.5, 2.5], times=times, simulated=sim, analytic=ana,
            metadata={"view_mode": mode})

    line = case("line_a", "line1d", [[1.0, 0.5, 0.2], [0.9, 0.45, 0.18]],
                [[1.0, 0.5, 0.2], [0.91, 0.45, 0.18]], [0.0, 0.1])
    ts = case("ts_a", "timeseries", [[0.5, 0.4, 0.3]], [[0.5, 0.41, 0.3]], [0.0])
    return models.TestSuiteData(suite_id="s1", created_at="2026-08-16T00:00:00+00:00", geometry_groups=[
        models.TestGeometryGroupData(geometry_id="strip", title="1D", description="", view_mode="line1d",
                                     preview_mask=[[1, 1, 1]], cases=[line], case_count=1),
        models.TestGeometryGroupData(geometry_id="ode", title="ODE", description="", view_mode="timeseries",
                                     preview_mask=[[1]], cases=[ts], case_count=1)])


def test_gen_tests_writes_the_same_file(tmp_path, capsys, monkeypatch):
    """The command's wiring and file: each package's generator is replaced by
    one that records its arguments and returns the same small suite (the
    generators themselves are held to each other in
    ``tests/test_torch_testcases.py``; the real suite takes ≈ 50 s here)."""
    import qpsim_tpu.testcases.generator as j_gen
    import qpsim_tpu_torch.models.params as t_models
    import qpsim_tpu_torch.testcases.generator as t_gen

    calls = []
    monkeypatch.setattr(j_gen, "generate_test_suite", lambda **kw: calls.append(kw) or _suite(jp))
    monkeypatch.setattr(t_gen, "generate_test_suite", lambda **kw: calls.append(kw) or _suite(t_models))
    args = ["gen-tests", "--nx", "20", "--total-time", "0.4", "--store-every", "4"]
    (rc_j, out_j, _), (rc_t, out_t, _) = _both(args + ["--output", str(tmp_path / "j.json")],
                                               args + ["--output", str(tmp_path / "t.json"), "--device", "cpu"],
                                               capsys)
    assert rc_j == rc_t == 0 and out_j.replace("j.json", "t.json") == out_t
    assert calls == [dict(nx=20, total_time=0.4, store_every=4), dict(nx=20, total_time=0.4, store_every=4,
                                                                      device="cpu")]
    # the manifest and its group files beside it, in j/ and t/
    files = lambda stem: {str(f.relative_to(tmp_path / stem)): f.read_bytes()
                          for f in sorted((tmp_path / stem).rglob("*")) if f.is_file()}
    assert (tmp_path / "j.json").read_bytes() == (tmp_path / "t.json").read_bytes()
    assert len(files("j")) == 2 and files("j") == files("t")


# ---------------------------------------------------------------- view, compare, profile, qubit


def test_view_writes_the_same_images(runs, capsys):
    d = runs["dir"]
    args = ["--frames", "0,-1", "--phonons", "--bin", "0", "--mkid", "4.0", "--gif"]
    (rc_j, out_j, _), (rc_t, out_t, _) = _both(["view", str(runs["port"]), "--out", str(d / "vj"), *args],
                                               ["view", str(runs["port"]), "--out", str(d / "vt"), *args],
                                               capsys)
    assert rc_j == rc_t == 0 and out_j.replace("/vj", "/vt") == out_t
    a, b = _pngs(d / "vj"), _pngs(d / "vt")
    assert len(a) == 8 and a == b  # 2 frames, 2 phonon, 2 bin-0, mass, mkid
    assert (d / "vj" / "movie.gif").read_bytes() == (d / "vt" / "movie.gif").read_bytes()
    # the same error and exit code for a bin that does not exist
    (rc_j, _, err_j), (rc_t, _, err_t) = _both(["view", str(runs["port"]), "--out", str(d / "x"), "--bin", "99"],
                                               ["view", str(runs["port"]), "--out", str(d / "x"), "--bin", "99"],
                                               capsys)
    assert rc_j == rc_t == 2 and err_j == err_t


def test_view_tests_writes_the_same_images(tmp_path, capsys):
    manifest = j_save_test_suite(_suite(jp), tmp_path / "suite.json")
    (rc_j, _, _), (rc_t, _, _) = _both(
        ["view-tests", str(manifest), "--out", str(tmp_path / "j"), "--frames", "all"],
        ["view-tests", str(manifest), "--out", str(tmp_path / "t"), "--frames", "all"], capsys)
    assert rc_j == rc_t == 0
    a, b = _pngs(tmp_path / "j"), _pngs(tmp_path / "t")
    assert len(a) == 3 and a == b
    (rc_j, _, err_j), (rc_t, _, err_t) = _both(
        ["view-tests", str(manifest), "--out", str(tmp_path / "x"), "--group", "nope"],
        ["view-tests", str(manifest), "--out", str(tmp_path / "x"), "--group", "nope"], capsys)
    assert rc_j == rc_t == 2 and err_j == err_t


def test_compare_verdicts_match(runs, capsys):
    (rc_j, out_j, _), (rc_t, out_t, _) = _both(["compare", str(runs["jax"]), str(runs["port"]), "--rtol", "1e-10"],
                                               ["compare", str(runs["jax"]), str(runs["port"]), "--rtol", "1e-10"],
                                               capsys)
    assert rc_j == rc_t == 0 and out_j == out_t and "MATCH" in out_t
    perturbed = runs["dir"] / "perturbed.json"
    payload = json.loads(runs["port"].read_text())
    for row in payload["frames"][-1]:
        for i, v in enumerate(row):
            if v is not None:
                row[i] = v * 1.5
    perturbed.write_text(json.dumps(payload))
    (rc_j, out_j, _), (rc_t, out_t, _) = _both(["compare", str(runs["jax"]), str(perturbed)],
                                               ["compare", str(runs["jax"]), str(perturbed)], capsys)
    assert rc_j == rc_t == 1 and out_j == out_t and "DIFFER" in out_t


def test_profile_writes_a_trace_on_the_cpu(tmp_path, capsys):
    setup_path = j_save_setup(_setup(export_phonons=False), tmp_path / "s.json")
    rc = tcli.main(["profile", str(setup_path), "--steps", "4", "--trace-dir", str(tmp_path / "trace"),
                    "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0 and "ms/step" in out and "4 steps" in out
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert trace["traceEvents"]
    assert "Self CPU" in (tmp_path / "trace" / "key_averages.txt").read_text()
    # bad --steps: the same clean error and exit code as the JAX package's
    (rc_j, _, err_j), (rc_t, _, err_t) = _both(["profile", str(setup_path), "--steps", "0"],
                                               ["profile", str(setup_path), "--steps", "0", "--device", "cpu"],
                                               capsys)
    assert rc_j == rc_t == 2 and err_j == err_t


def test_qubit_sweep_matches(capsys):
    args = ["qubit-sweep", "--temps", "0.05", "0.25", "5", "--json"]
    (rc_j, out_j, _), (rc_t, out_t, _) = _both(args, args + ["--device", "cpu"], capsys)
    assert rc_j == rc_t == 0
    a, b = json.loads(out_j), json.loads(out_t)
    assert len(a) == len(b) == 5
    for ra, rb in zip(a, b):
        assert ra["regime"] == rb["regime"] and ra["T_K"] == rb["T_K"]
        for key in ("x_L", "x_Rgt", "x_Rlt", "p1", "mu_ueV", "parity_hz"):
            _close(rb[key], ra[key])  # μ near zero is a difference: scaled by the row's largest
    (rc_j, out_j, _), (rc_t, out_t, _) = _both(["qubit-sweep", "--temps", "0.05", "0.25", "3"],
                                               ["qubit-sweep", "--temps", "0.05", "0.25", "3", "--device", "cpu"],
                                               capsys)
    assert rc_j == rc_t == 0 and out_j.splitlines()[0] == out_t.splitlines()[0]
