"""The port's ``run_setup`` against ``qpsim_tpu.runner.run_setup``, float64 on the CPU.

One setup per case, built with the JAX package's models and carried into
the port through the port's own deserializer; each case runs through both
runners: full detail in memory, streamed, integrated detail (streamed), a
precompute sidecar, the scalar branch, and a checkpointed run resumed.
Frames are held to rtol 1e-10, mass to 1e-12, the energy bookkeeping to
1e-10 of its scale; the diagnostics mode and the metadata keys are equal.
"""

import dataclasses

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from qpsim_tpu.fields import default_initial_condition  # noqa: E402
from qpsim_tpu.geometry.mask import create_intrinsic_geometry  # noqa: E402
from qpsim_tpu.io import storage as j_storage  # noqa: E402
from qpsim_tpu.io.precompute import precompute_arrays  # noqa: E402
from qpsim_tpu.models import params as jp  # noqa: E402
from qpsim_tpu.runner import run_setup as j_run_setup  # noqa: E402

import qpsim_tpu_torch as T  # noqa: E402
from qpsim_tpu_torch.io import storage as t_storage  # noqa: E402
from qpsim_tpu_torch.io.stream import load_frame_stream  # noqa: E402


def _setup(*, gen="none", bc="reflective", gap_expression="", energy_gap=180.0, export=False,
           total_time=0.6):
    geo = create_intrinsic_geometry(width=14, height=10)
    bcs = {e.edge_id: jp.BoundaryCondition(kind=bc, value=0.0 if bc == "dirichlet" else None)
           for e in geo.edges}
    generation = jp.ExternalGenerationSpec()
    if gen == "pulse":
        generation = jp.ExternalGenerationSpec(mode="pulse", pulse_start=0.1, pulse_duration=0.2,
                                               pulse_rate=2e-5)
    params = jp.SimulationParameters(
        diffusion_coefficient=6.0, dt=0.05, total_time=total_time, mesh_size=1.0, store_every=3,
        energy_gap=energy_gap, energy_min_factor=1.0, energy_max_factor=3.0, num_energy_bins=5,
        enable_recombination=True, enable_scattering=True, bath_temperature=0.2,
        gap_expression=gap_expression, external_generation=generation,
        export_phonon_history=export)
    ic = default_initial_condition()
    ic = dataclasses.replace(ic, spatial_params={**ic.spatial_params, "amplitude": 1e-4})
    return jp.SetupData(setup_id="abc123def456", name="runner case", created_at="2026-08-16T00:00:00+00:00",
                        geometry=geo, boundary_conditions=bcs, parameters=params, initial_condition=ic)


def _port(setup):
    return t_storage.deserialize_setup(j_storage.serialize_setup(setup))


def _frames(result):
    return [np.asarray(j_storage.frame_from_jsonable(f)) for f in result.frames]


def _assert_close_series(a, b, rtol):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    scale = max(np.max(np.abs(b)), 1e-300)
    np.testing.assert_allclose(a, b, rtol=0, atol=rtol * scale)


def _assert_results_match(port, jax):
    assert port.times == jax.times
    np.testing.assert_allclose(port.mass_over_time, jax.mass_over_time, rtol=1e-12, atol=0)
    assert len(port.frames) == len(jax.frames)
    for fa, fb in zip(_frames(port), _frames(jax)):
        np.testing.assert_array_equal(np.isnan(fa), np.isnan(fb))
        np.testing.assert_allclose(np.nan_to_num(fa), np.nan_to_num(fb), rtol=1e-10, atol=0)
    assert (port.energy_frames is None) == (jax.energy_frames is None)
    for ta, tb in zip(port.energy_frames or [], jax.energy_frames or []):
        for ba, bb in zip(ta, tb):
            x, y = j_storage.frame_from_jsonable(ba), j_storage.frame_from_jsonable(bb)
            np.testing.assert_allclose(np.nan_to_num(x), np.nan_to_num(y), rtol=1e-10, atol=1e-300)
    assert port.energy_bins == jax.energy_bins
    pm, jm = port.metadata, jax.metadata
    assert sorted(pm) == sorted(jm)
    assert pm["diagnostics_mode"] == jm["diagnostics_mode"]
    for key in ("energy_qp_total", "energy_phonon_total"):
        _assert_close_series(pm[key], jm[key], 1e-10)
    # the residual is a difference of totals: held at 1e-10 of the totals' scale
    total_scale = max(np.max(np.abs(jm["energy_qp_total"])), np.max(np.abs(jm["energy_phonon_total"])))
    np.testing.assert_allclose(pm["energy_exchange_residual"], jm["energy_exchange_residual"], rtol=0,
                               atol=1e-10 * total_scale)
    assert port.phonon_energy_bins == jax.phonon_energy_bins
    assert port.phonon_metadata == jax.phonon_metadata
    assert (port.phonon_frames is None) == (jax.phonon_frames is None)


CASES = {
    "closed": dict(),
    "open_pulse": dict(gen="pulse"),
    "dirichlet_export": dict(bc="dirichlet", export=True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_run_setup_matches_the_jax_package(tmp_path, case):
    setup = _setup(**CASES[case])
    jax_result, jax_path = j_run_setup(setup, save_path=tmp_path / "jax.json")
    port_result, port_path = T.run_setup(_port(setup), save_path=tmp_path / "port.json", device="cpu")
    assert port_path == str(tmp_path / "port.json")
    _assert_results_match(port_result, jax_result)
    # the saved JSON loads in both packages and holds the same run
    _assert_results_match(j_storage.load_simulation(port_path), T.load_simulation(jax_path))
    expected = {"closed": "conservation_residual"}.get(case, "open_system")
    assert port_result.metadata["diagnostics_mode"] == expected


@pytest.mark.parametrize("detail", ["full", "integrated"])
def test_run_setup_streamed_matches_the_jax_package(tmp_path, detail):
    setup = _setup(gen="pulse", export=True)
    results = {}
    for pkg, fn, s in (("jax", j_run_setup, setup), ("port", T.run_setup, _port(setup))):
        extra = {"device": "cpu"} if pkg == "port" else {}
        results[pkg], _ = fn(s, save=False, stream_dir=tmp_path / pkg, snapshot_detail=detail, **extra)
        assert results[pkg].frames == [] and results[pkg].metadata["streamed_frames_dir"] == str(tmp_path / pkg)
    port, jax = results["port"], results["jax"]
    for key in ("energy_qp_total", "energy_phonon_total"):
        _assert_close_series(port.metadata[key], jax.metadata[key], 1e-10)
    assert port.metadata["diagnostics_mode"] == jax.metadata["diagnostics_mode"]
    assert sorted(port.metadata) == sorted(jax.metadata)
    assert port.phonon_metadata == jax.phonon_metadata and port.times == jax.times
    rp, rj = load_frame_stream(tmp_path / "port"), load_frame_stream(tmp_path / "jax")
    assert rp.times == rj.times and rp.count == rj.count
    np.testing.assert_allclose(rp.mass_over_time, rj.mass_over_time, rtol=1e-12, atol=0)
    for key in ("energy_qp_total", "energy_phonon_total", "energy_exchange_residual"):
        assert key in rp.metadata
    assert rp.metadata["diagnostics_mode"] == rj.metadata["diagnostics_mode"]
    assert rp.phonon_energy_bins.tolist() == rj.phonon_energy_bins.tolist()
    for i in range(rp.count):
        np.testing.assert_allclose(np.nan_to_num(rp.frame(i)), np.nan_to_num(rj.frame(i)), rtol=1e-10)
    # the streamed result loads as a whole through the port's reader
    whole = rp.to_result_data()
    assert len(whole.frames) == rp.count and whole.setup_id == setup.setup_id


def test_run_setup_with_a_precompute_sidecar(tmp_path):
    setup = _setup(gap_expression="return 180.0 - 15.0 * (x < 0.5)")
    setup_path = j_storage.save_setup(setup, tmp_path / "setup.json")
    mask = np.asarray(setup.geometry.mask, dtype=bool)
    j_storage.save_precomputed(setup_path, precompute_arrays(
        mask, setup.geometry.edges, setup.boundary_conditions, setup.parameters,
        include_collision_kernels=False))
    jax_result, _ = j_run_setup(setup, setup_path=setup_path, save=False)
    port_setup = T.load_setup(setup_path)
    port_result, _ = T.run_setup(port_setup, setup_path=setup_path, save=False, device="cpu")
    _assert_results_match(port_result, jax_result)
    assert "precompute_stale_reason" not in port_result.metadata
    # a stale sidecar (another gap) is reported by both, with the same reason
    stale = dataclasses.replace(setup, parameters=dataclasses.replace(setup.parameters, energy_gap=175.0))
    jax_stale, _ = j_run_setup(stale, setup_path=setup_path, save=False)
    port_stale, _ = T.run_setup(_port(stale), setup_path=setup_path, save=False, device="cpu")
    assert port_stale.metadata["precompute_stale_reason"] == jax_stale.metadata["precompute_stale_reason"]
    _assert_results_match(port_stale, jax_stale)


def test_run_setup_scalar_branch_streamed(tmp_path):
    setup = _setup(energy_gap=0.0)
    jax_result, _ = j_run_setup(setup, save=False)
    port_result, _ = T.run_setup(_port(setup), save=False, device="cpu")
    _assert_results_match(port_result, jax_result)
    # checkpoint_dir is ignored by the scalar branch, as in the JAX package
    streamed, _ = T.run_setup(_port(setup), save=False, device="cpu", stream_dir=tmp_path / "s",
                              checkpoint_dir=tmp_path / "ck")
    assert not (tmp_path / "ck").exists()
    r = load_frame_stream(tmp_path / "s")
    assert r.times == port_result.times and r.mass_over_time == port_result.mass_over_time
    for i, f in enumerate(_frames(port_result)):
        np.testing.assert_array_equal(r.frame(i), f)


def test_run_setup_checkpointed_resume_is_bit_exact(tmp_path):
    setup = _port(_setup(gen="pulse"))
    baseline, _ = T.run_setup(setup, save=False, device="cpu")
    short = dataclasses.replace(setup, parameters=dataclasses.replace(setup.parameters, total_time=0.25))
    T.run_setup(short, save=False, device="cpu", checkpoint_dir=tmp_path / "ck",
                stream_dir=tmp_path / "s", snapshot_detail="integrated")
    resumed, _ = T.run_setup(setup, save=False, device="cpu", checkpoint_dir=tmp_path / "ck",
                             stream_dir=tmp_path / "s", snapshot_detail="integrated")
    r = load_frame_stream(tmp_path / "s")
    assert r.times == baseline.times
    np.testing.assert_allclose(r.mass_over_time, baseline.mass_over_time, rtol=1e-12)
    light, _ = T.run_setup(setup, save=False, device="cpu", stream_dir=tmp_path / "s2",
                           snapshot_detail="integrated")
    r2 = load_frame_stream(tmp_path / "s2")
    assert r.mass_over_time == r2.mass_over_time  # bit for bit
    for i in range(r.count):
        np.testing.assert_array_equal(r.frame(i), r2.frame(i))
        np.testing.assert_array_equal(r.energy_bin_sums(i), r2.energy_bin_sums(i))
        np.testing.assert_array_equal(r.phonon_bin_sums(i), r2.phonon_bin_sums(i))
    assert resumed.metadata["energy_qp_total"] == light.metadata["energy_qp_total"]


def test_run_setup_errors_match_the_jax_package(tmp_path):
    setup = _setup()
    with pytest.raises(ValueError) as jax_err:
        j_run_setup(setup, save=False, snapshot_detail="integrated")
    with pytest.raises(ValueError) as port_err:
        T.run_setup(_port(setup), save=False, snapshot_detail="integrated", device="cpu")
    assert str(port_err.value) == str(jax_err.value)
    # a generation expression that turns negative
    negative = jp.ExternalGenerationSpec(mode="custom", custom_body="return -1e-6 * (t > 0.1) + 0.0 * x")
    bad = dataclasses.replace(setup, parameters=dataclasses.replace(
        setup.parameters, external_generation=negative))
    with pytest.raises(ValueError) as jax_err:
        j_run_setup(bad, save=False)
    with pytest.raises(ValueError) as port_err:
        T.run_setup(_port(bad), save=False, device="cpu")
    assert str(port_err.value) == str(jax_err.value)
    # mesh= runs: the port's rows-sharded run against the JAX package's on a
    # mesh of the same size (two shards of the 10 × 14 film)
    import jax
    from qpsim_tpu.parallel.mesh import make_mesh as j_make_mesh

    from qpsim_tpu_torch.parallel.mesh import make_mesh as t_make_mesh

    j_mesh = j_make_mesh(n_space=2, devices=jax.devices()[:2])
    t_mesh = t_make_mesh(devices=[torch.device("cpu")] * 2)
    _assert_results_match(T.run_setup(_port(setup), save=False, mesh=t_mesh)[0],
                          j_run_setup(setup, save=False, mesh=j_mesh)[0])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            T.run_setup(_port(setup), save=False, stream_dir=tmp_path / "never")
        assert not (tmp_path / "never").exists()
    # a failed save is reported, not raised
    blocker = tmp_path / "file"
    blocker.write_text("x")
    result, saved = T.run_setup(_port(setup), save_path=blocker / "sub" / "r.json", device="cpu")
    assert saved is None and "save_error" in result.metadata
