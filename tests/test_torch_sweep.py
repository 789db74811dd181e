"""The port's sweeps against ``qpsim_tpu.sweep``, float64 on the CPU.

``parse_vary``, ``build_variants`` and ``apply_overrides`` give equal
outputs (and equal errors); a 2 × 2 ``run_sweep`` gives the JAX package's
summary apart from paths, and ``resume=True`` skips finished variants and
refuses changed settings.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from qpsim_tpu import sweep as j_sweep  # noqa: E402
from qpsim_tpu.fields import default_initial_condition  # noqa: E402
from qpsim_tpu.geometry.mask import create_intrinsic_geometry  # noqa: E402
from qpsim_tpu.io import storage as j_storage  # noqa: E402
from qpsim_tpu.models import params as jp  # noqa: E402

from qpsim_tpu_torch import sweep as t_sweep  # noqa: E402
from qpsim_tpu_torch.io import storage as t_storage  # noqa: E402

VARY_SPECS = [
    "bath_temperature=0.1,0.2", "tau_0=100:400:4", "num_energy_bins=4,8", "store_every=2:6:3",
    "enable_scattering=true,off", "external_generation.pulse_rate=1e-6,2e-6",
    "photon_drive.occupancy=0.5:2:2", "dynes_gamma=0:1e-4:1", "dt= 0.05 , 0.1 ,",
]
VARY_ERRORS = [
    "bath_temperature", "bath_temperature=", "nonsense=1", "external_generation.mode=1",
    "photon_drive.mode=2", "num_energy_bins=4.5", "enable_scattering=maybe", "tau_0=abc",
    "tau_0=1:2", "tau_0=1:2:0", "dt=,",
]


@pytest.mark.parametrize("spec", VARY_SPECS)
def test_parse_vary_is_the_jax_packages(spec):
    assert t_sweep.parse_vary(spec) == j_sweep.parse_vary(spec)


@pytest.mark.parametrize("spec", VARY_ERRORS)
def test_parse_vary_errors_are_the_jax_packages(spec):
    with pytest.raises(ValueError) as jax_err:
        j_sweep.parse_vary(spec)
    with pytest.raises(ValueError) as port_err:
        t_sweep.parse_vary(spec)
    assert str(port_err.value) == str(jax_err.value)


def _setup(drive=None):
    geo = create_intrinsic_geometry(width=12, height=8)
    bcs = {e.edge_id: jp.BoundaryCondition(kind="reflective") for e in geo.edges}
    ic = default_initial_condition()
    ic = dataclasses.replace(ic, spatial_params={**ic.spatial_params, "amplitude": 1e-4})
    params = jp.SimulationParameters(
        diffusion_coefficient=6.0, dt=0.05, total_time=0.3, mesh_size=1.0, store_every=3,
        energy_gap=180.0, energy_min_factor=1.0, energy_max_factor=3.0, num_energy_bins=4,
        enable_recombination=True, enable_scattering=True, bath_temperature=0.1, tau_s=300.0,
        tau_r=500.0, photon_drive=drive or jp.PhotonDriveSpec(),
        external_generation=jp.ExternalGenerationSpec(mode="pulse", pulse_start=0.05,
                                                      pulse_duration=0.1, pulse_rate=1e-5))
    return jp.SetupData(setup_id="sweep0000001", name="sweep case", created_at="2026-08-16T00:00:00+00:00",
                        geometry=geo, boundary_conditions=bcs, parameters=params, initial_condition=ic)


def _port(setup):
    return t_storage.deserialize_setup(j_storage.serialize_setup(setup))


@pytest.mark.parametrize("mode", ["product", "zip"])
def test_build_variants_and_overrides_are_the_jax_packages(mode):
    setup = _setup()
    axes = [j_sweep.parse_vary("tau_0=200,300"), j_sweep.parse_vary("external_generation.pulse_rate=1e-6,2e-6"),
            j_sweep.parse_vary("photon_drive.occupancy=0.5,1.0")]
    jax_variants = j_sweep.build_variants(setup, axes, mode)
    port_variants = t_sweep.build_variants(_port(setup), axes, mode)
    assert [o for o, _ in port_variants] == [o for o, _ in jax_variants]
    assert len(port_variants) == (8 if mode == "product" else 2)
    for (_, a), (_, b) in zip(port_variants, jax_variants):
        assert t_storage.serialize_setup(a) == j_storage.serialize_setup(b)
        # a tau_0 override re-resolves tau_s and tau_r from it
        assert a.parameters.tau_s == a.parameters.tau_r == a.parameters.tau_0


def test_sweep_errors_are_the_jax_packages():
    two_tone = _setup(drive=[jp.PhotonDriveSpec(mode="photon", photon_energy=400.0),
                             jp.PhotonDriveSpec(mode="photon", photon_energy=500.0)])
    cases = [
        (_setup(), [], "product"),
        (_setup(), [("tau_0", [1.0, 2.0]), ("dt", [0.1])], "zip"),
        (_setup(), [("tau_0", [1.0])], "diagonal"),
        (two_tone, [("photon_drive.occupancy", [1.0])], "product"),
        (_setup(), [("dt", [-0.1])], "product"),
    ]
    for setup, axes, mode in cases:
        with pytest.raises(ValueError) as jax_err:
            j_sweep.build_variants(setup, axes, mode)
        with pytest.raises(ValueError) as port_err:
            t_sweep.build_variants(_port(setup), axes, mode)
        assert str(port_err.value) == str(jax_err.value)


def _strip_paths(summary):
    out = json.loads(json.dumps(summary))
    out.pop("summary_path")
    for record in out["variants"]:
        record.pop("result_path", None)
    return out


def test_run_sweep_matches_the_jax_package_and_resumes(tmp_path):
    setup = _setup()
    axes = [("bath_temperature", [0.1, 0.2]), ("dynes_gamma", [0.0, 1e-4])]
    jax_summary = j_sweep.run_sweep(setup, axes, out_dir=tmp_path / "jax")
    seen: list[str] = []
    port_summary = t_sweep.run_sweep(_port(setup), axes, out_dir=tmp_path / "port", device="cpu",
                                     progress=seen.append)
    assert seen == ["[1/4] bath_temperature=0.1_dynes_gamma=0", "[2/4] bath_temperature=0.1_dynes_gamma=0.0001",
                    "[3/4] bath_temperature=0.2_dynes_gamma=0", "[4/4] bath_temperature=0.2_dynes_gamma=0.0001"]
    a, b = _strip_paths(port_summary), _strip_paths(jax_summary)
    for ra, rb in zip(a.pop("variants"), b.pop("variants")):
        assert sorted(ra) == sorted(rb) and ra["overrides"] == rb["overrides"]
        for key in ("final_time", "mass_initial", "mass_final", "mass_peak", "energy_qp_final",
                    "energy_phonon_final"):
            np.testing.assert_allclose(ra[key], rb[key], rtol=1e-10, err_msg=key)
    assert a == b
    assert [p.name for p in sorted((tmp_path / "port").glob("0*.json"))] == [
        p.name for p in sorted((tmp_path / "jax").glob("0*.json"))]
    assert json.loads((tmp_path / "port" / "sweep_summary.json").read_text())["n_variants"] == 4

    # resume: finished variants are read back, not re-run
    calls = []
    from qpsim_tpu_torch import runner

    real = runner.run_setup
    try:
        runner.run_setup = lambda *a, **k: calls.append(1) or real(*a, **k)
        again = t_sweep.run_sweep(_port(setup), axes, out_dir=tmp_path / "port", device="cpu", resume=True)
    finally:
        runner.run_setup = real
    assert calls == [] and all(r["resumed"] for r in again["variants"])
    assert [r["mass_final"] for r in again["variants"]] == [r["mass_final"] for r in port_summary["variants"]]
    # a damaged result is re-run; changed settings are refused
    damaged = sorted((tmp_path / "port").glob("001_*.json"))[0]
    damaged.write_text("{")
    rerun = t_sweep.run_sweep(_port(setup), axes, out_dir=tmp_path / "port", device="cpu", resume=True)
    assert [r.get("resumed", False) for r in rerun["variants"]] == [True, False, True, True]
    assert rerun["variants"][1]["mass_final"] == port_summary["variants"][1]["mass_final"]
    with pytest.raises(ValueError, match="run_kwargs changed"):
        t_sweep.run_sweep(_port(setup), axes, out_dir=tmp_path / "port", device="cpu", resume=True,
                          strang_mode="exact")
    edited = _port(dataclasses.replace(setup, parameters=dataclasses.replace(setup.parameters, dt=0.1)))
    with pytest.raises(ValueError, match="setup_hash changed"):
        t_sweep.run_sweep(edited, axes, out_dir=tmp_path / "port", device="cpu", resume=True)


def test_a_failing_variant_is_recorded_and_the_sweep_goes_on(tmp_path):
    setup = _setup()
    axes = [("external_generation.pulse_rate", [1e-5, 50.0])]  # the second breaks the Pauli gate
    jax_summary = j_sweep.run_sweep(setup, axes, out_dir=tmp_path / "jax", save_results=False)
    port_summary = t_sweep.run_sweep(_port(setup), axes, out_dir=tmp_path / "port", save_results=False,
                                     device="cpu")
    assert port_summary["n_failed"] == jax_summary["n_failed"] == 1
    assert port_summary["variants"][1]["error"].split(":")[0] == "ValueError"
    assert jax_summary["variants"][1]["error"].split(":")[0] == "ValueError"
    assert port_summary["variants"][0]["result_path"] is None
