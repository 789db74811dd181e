"""The photon drive and custom generation of the port against ``qpsim_tpu``, float64 on the CPU.

* the photon substeps (uniform gap and per pixel) against
  ``qpsim_tpu.ops.photon_drive`` at ≤ 1e-13, and the thermal state as
  their fixed point at ≤ 1e-12;
* engine runs with frames rtol 1e-10 and mass 1e-12, ``strang_mode``
  pinned on both sides: photon scattering and pair breaking in a window,
  two tones, the trap and a continuous gap map, a pulse with photons (the
  generation plane unfused), custom generation traced (merged) and
  evaluated on the host (exact);
* the traced-or-host classification of custom expressions, pinned to the
  JAX package's ``GenerationProgram.host_mode``;
* the inert-drive and merged-with-host-generation errors.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import qpsim_tpu as J  # noqa: E402
from qpsim_tpu.constants import K_B_UEV_PER_K  # noqa: E402
from qpsim_tpu.geometry.mask import create_intrinsic_geometry, mask_from_lists  # noqa: E402
from qpsim_tpu.models import params as jp  # noqa: E402
from qpsim_tpu.ops import generation as j_gen  # noqa: E402
from qpsim_tpu.ops import photon_drive as j_photon  # noqa: E402
from qpsim_tpu.ops.dos import dynes_density_of_states, fermi_dirac_occupation  # noqa: E402
from qpsim_tpu.ops.energy_grid import build_energy_grid  # noqa: E402

import qpsim_tpu_torch as T  # noqa: E402
from qpsim_tpu_torch.models import params as tp  # noqa: E402
from qpsim_tpu_torch.ops import generation as t_gen  # noqa: E402
from qpsim_tpu_torch.ops import photon_drive as t_photon  # noqa: E402

GAP = 180.0
NE = 12


def _grid(ne=NE):
    E, dE = build_energy_grid(GAP, 1.0, 4.0, ne)
    return E, dE, dynes_density_of_states(E, GAP, 0.0)


# ------------------------------------------------------------------ substeps


@pytest.mark.parametrize("omega_kind", ["scatter", "pair", "both", "pair_edge"])
@pytest.mark.parametrize("windowed", [False, True], ids=["amp1", "amp0"])
def test_photon_substep_matches_jax(omega_kind, windowed):
    E, dE, rho = _grid()
    omega = {"scatter": 3 * dE, "pair": 2.6 * GAP, "both": 2 * GAP + 5 * dE,
             "pair_edge": 2 * E[-1]}[omega_kind]
    kw = dict(E_bins=E, dE=dE, gap=GAP, rho=rho, omega=omega, coupling=2e-2, occupancy=1.5)
    pj, pt = j_photon.build_photon_drive_plan(**kw), t_photon.build_photon_drive_plan(**kw)
    for name in ("kp_up", "kp_dn", "km_pair", "rho"):
        np.testing.assert_array_equal(getattr(pt, name), getattr(pj, name))
    assert (pt.k_offset, pt.s_index, pt.omega_eff_pair) == (pj.k_offset, pj.s_index, pj.omega_eff_pair)
    rng = np.random.default_rng(3)
    q = rho[:, None, None] * rng.uniform(0, 0.4, (NE, 6, 7))
    w = (rng.uniform(size=(6, 7)) > 0.25).astype(float)
    amp = 0.0 if windowed else 1.0
    a = np.asarray(j_photon.make_photon_substep(pj, 0.05)(jnp.asarray(q), jnp.asarray(amp), jnp.asarray(w)))
    b = t_photon.make_photon_substep(pt, 0.05, device="cpu")(torch.tensor(q), amp, torch.tensor(w)).numpy()
    assert np.max(np.abs(b - a)) <= 1e-13 * np.max(np.abs(a))


@pytest.mark.parametrize("omega_kind", ["scatter", "pair", "both"])
def test_per_pixel_photon_substep_matches_jax(omega_kind):
    E, dE, _ = _grid()
    omega = {"scatter": 4 * dE, "pair": 2.6 * GAP, "both": 2 * GAP + 5 * dE}[omega_kind]
    kw = dict(E_bins=E, dE=dE, omega=omega, coupling=3e-2, occupancy=0.7)
    pj, pt = j_photon.build_photon_drive_plan_analytic(**kw), t_photon.build_photon_drive_plan_analytic(**kw)
    for name in ("ind_up", "inv_up", "ind_dn", "inv_dn", "ind_pair", "inv_pair"):
        np.testing.assert_array_equal(getattr(pt, name), getattr(pj, name))
    rng = np.random.default_rng(5)
    gaps = rng.uniform(150.0, 220.0, (6, 7))  # the threshold 2Δ(x) crosses ω in the film
    rho = np.stack([dynes_density_of_states(E, g, 0.0) for g in gaps.ravel()], axis=1).reshape(NE, 6, 7)
    q = rho * rng.uniform(0, 0.4, (NE, 6, 7))
    w = np.ones((6, 7))
    a = j_photon.make_photon_substep_per_pixel(pj, 0.05)(
        jnp.asarray(q), jnp.asarray(1.0), jnp.asarray(w), jnp.asarray(gaps**2), jnp.asarray(rho))
    b = t_photon.make_photon_substep_per_pixel(pt, 0.05, device="cpu")(
        torch.tensor(q), 1.0, torch.tensor(w), torch.tensor(gaps**2), torch.tensor(rho))
    assert np.max(np.abs(b.numpy() - np.asarray(a))) <= 1e-13 * np.max(np.abs(np.asarray(a)))


@pytest.mark.parametrize("channel", ["scattering", "pair_breaking"])
def test_thermal_state_is_a_fixed_point(channel):
    E, dE, rho = _grid(24)
    temp = 0.25
    kT = K_B_UEV_PER_K * temp
    n_eq = (rho * fermi_dirac_occupation(E, temp))[:, None]
    if channel == "scattering":
        omega = 4 * dE
        plan = t_photon.build_photon_drive_plan(
            E_bins=E, dE=dE, gap=GAP, rho=rho, omega=omega, coupling=1e-2,
            occupancy=1.0 / np.expm1(omega / kT), include_pair_breaking=False)
    else:
        probe = t_photon.build_photon_drive_plan(
            E_bins=E, dE=dE, gap=GAP, rho=rho, omega=2.5 * GAP, coupling=1e-2, occupancy=1.0,
            include_scattering=False)
        omega = probe.omega_eff_pair
        plan = t_photon.build_photon_drive_plan(
            E_bins=E, dE=dE, gap=GAP, rho=rho, omega=omega, coupling=1e-2,
            occupancy=1.0 / np.expm1(omega / kT), include_scattering=False)
    out = t_photon.make_photon_substep(plan, 0.1, device="cpu")(torch.tensor(n_eq), 1.0).numpy()
    assert np.max(np.abs(out - n_eq)) <= 1e-12 * np.max(n_eq)


# ------------------------------------------------------------------ engine runs


def _film(width=20, height=10):
    geo = create_intrinsic_geometry(width=width, height=height)
    mask = mask_from_lists(geo.mask)
    return mask, geo.edges, {e.edge_id: jp.BoundaryCondition(kind="reflective") for e in geo.edges}


def _photon(pkg, **kw):
    return (jp if pkg == "jax" else tp).PhotonDriveSpec(mode="photon", **kw)


def _gen(pkg, **kw):
    return (jp if pkg == "jax" else tp).ExternalGenerationSpec(**kw)


#: each case: engine keywords built per package (the spec classes differ)
_CASES = {
    "pair_and_scatter_window": lambda pkg: dict(
        photon_drive=_photon(pkg, photon_energy=2.6 * GAP, occupancy=2.0, coupling=2e-4,
                             window_start=0.1, window_duration=0.25)),
    "two_tone": lambda pkg: dict(
        photon_drive=[
            _photon(pkg, photon_energy=2.6 * GAP, occupancy=2.0, coupling=2e-4,
                    window_start=0.1, window_duration=0.25),
            _photon(pkg, photon_energy=4 * 45.0, occupancy=0.5, coupling=1e-3,
                    include_pair_breaking=False)]),
    "trap_map": lambda pkg: dict(
        gap_expression="return 180.0 - 20.0 * (((x - 0.5)**2 + (y - 0.5)**2) < 0.04)",
        photon_drive=_photon(pkg, photon_energy=2.6 * GAP, occupancy=2.0, coupling=2e-4)),
    "gradient_map": lambda pkg: dict(
        gap_expression="return 170.0 + 20.0 * x + 2.0 * y",
        photon_drive=_photon(pkg, photon_energy=2.6 * GAP, occupancy=2.0, coupling=2e-4,
                             window_start=0.05, window_duration=0.2)),
    "pulse_with_photons": lambda pkg: dict(
        external_generation=_gen(pkg, mode="pulse", pulse_start=0.1, pulse_duration=0.2,
                                 pulse_rate=2e-5),
        photon_drive=_photon(pkg, photon_energy=2.6 * GAP, occupancy=2.0, coupling=2e-4)),
    "custom_traced": lambda pkg: dict(
        external_generation=_gen(
            pkg, mode="custom",
            custom_body="np.exp(-((x-0.3)**2 + (y-0.5)**2)/0.02) * np.exp(-E/300.0)"
                        " * np.where((t >= 0.1) & (t < 0.3), 1e-5, 0.0)")),
    "custom_traced_with_photons": lambda pkg: dict(
        external_generation=_gen(pkg, mode="custom",
                                 custom_body="params.get('a', 1.0) * 2e-6 * (1.0 + x)",
                                 custom_params={"a": 3.0}),
        photon_drive=_photon(pkg, photon_energy=2.6 * GAP, occupancy=2.0, coupling=2e-4)),
    "custom_host": lambda pkg: dict(
        external_generation=_gen(pkg, mode="custom",
                                 custom_body="2e-6 * (1.0 + x) if t >= 0.1 else 0.0"),
        photon_drive=_photon(pkg, photon_energy=2.6 * GAP, occupancy=2.0, coupling=2e-4,
                             window_start=0.1, window_duration=0.25)),
}

#: (case, strang mode): merged and exact each against the same on the other side
_RUNS = [
    ("pair_and_scatter_window", "exact"), ("pair_and_scatter_window", "merged"),
    ("two_tone", "merged"), ("trap_map", "merged"), ("gradient_map", "exact"),
    ("pulse_with_photons", "merged"), ("custom_traced", "merged"),
    ("custom_traced_with_photons", "exact"), ("custom_host", "exact"),
    ("custom_host", "auto"),
]


def _run_both(extra, strang, **over):
    mask, edges, bcs = _film()
    init = np.zeros(mask.shape)
    init[mask] = 1e-6 * (1.0 + 0.5 * np.sin(np.arange(mask.sum()) * 0.3))
    kw = dict(
        mask=mask, edges=edges, edge_conditions=bcs, initial_field=init,
        diffusion_coefficient=6.0, dt=0.05, total_time=0.42, dx=1.0, store_every=3,
        energy_gap=GAP, energy_max_factor=4.0, num_energy_bins=8,
        enable_recombination=True, enable_scattering=True, bath_temperature=0.1,
        strang_mode=strang,
    )
    kw.update(over)
    ja = J.run_2d_crank_nicolson(**kw, **extra("jax"))
    tb = T.run_2d_crank_nicolson(**kw, **extra("torch"), device="cpu")
    return ja, tb


def assert_runs_match(a, b):
    times_a, frames_a, mass_a, clim_a, ef_a, _ = a
    times_b, frames_b, mass_b, clim_b, ef_b, _ = b
    assert times_b == times_a
    np.testing.assert_allclose(mass_b, mass_a, rtol=1e-12, atol=0)
    assert len(frames_b) == len(frames_a)
    for fa, fb in zip(frames_a, frames_b):
        np.testing.assert_array_equal(np.isnan(fb), np.isnan(fa))
        np.testing.assert_allclose(np.nan_to_num(fb), np.nan_to_num(fa), rtol=1e-10, atol=1e-18)
    for row_a, row_b in zip(ef_a, ef_b):
        for fa, fb in zip(row_a, row_b):
            np.testing.assert_allclose(np.nan_to_num(fb), np.nan_to_num(fa), rtol=1e-10, atol=1e-18)
    np.testing.assert_allclose(clim_b, clim_a, rtol=1e-10)


@pytest.mark.parametrize("case,strang", _RUNS, ids=[f"{c}-{s}" for c, s in _RUNS])
def test_engine_matches_jax(case, strang):
    a, b = _run_both(_CASES[case], strang)
    assert_runs_match(a, b)
    assert b[2][-1] != b[2][0]  # the drive or the generation moved the mass


def test_photon_drive_without_collisions_or_diffusion_matches_jax():
    for over in (dict(enable_recombination=False, enable_scattering=False),
                 dict(enable_diffusion=False)):
        a, b = _run_both(_CASES["pair_and_scatter_window"], "merged", **over)
        assert_runs_match(a, b)


def _error(fn, **kw):
    mask, edges, bcs = _film(8, 4)
    init = np.zeros(mask.shape)
    init[mask] = 1e-6
    with pytest.raises(ValueError) as info:
        fn(mask=mask, edges=edges, edge_conditions=bcs, initial_field=init,
           diffusion_coefficient=6.0, dt=0.05, total_time=0.2, dx=1.0, energy_gap=GAP,
           energy_max_factor=4.0, num_energy_bins=8, enable_scattering=True, **kw)
    return str(info.value)


def test_inert_drive_raises_the_jax_error():
    # ω = 10 µeV: no scattering offset on the grid, below the pair threshold
    msg = _error(T.run_2d_crank_nicolson, device="cpu",
                 photon_drive=_photon("torch", photon_energy=10.0, coupling=1e-3))
    assert "inert" in msg
    assert msg == _error(J.run_2d_crank_nicolson,
                         photon_drive=_photon("jax", photon_energy=10.0, coupling=1e-3))


def test_merged_with_host_generation_raises_the_jax_error():
    msg = _error(T.run_2d_crank_nicolson, device="cpu", strang_mode="merged",
                 **_CASES["custom_host"]("torch"))
    assert "strang_mode='merged'" in msg
    assert msg == _error(J.run_2d_crank_nicolson, strang_mode="merged",
                         **_CASES["custom_host"]("jax"))


# ------------------------------------------------------------------ traced or host

#: expressions the JAX rule traces and expressions it leaves to the host
_EXPRESSIONS = [
    "1e-6",
    "np.exp(-E / 300.0) * x",
    "np.where(t > 0.2, 1e-6, 0.0) * np.ones_like(x)",
    "1e-6 * abs(t - 0.1) + np.maximum(y - 0.5, 0.0)",
    "params.get('a', 2.0) * np.clip(x, 0.2, 0.8) * np.heaviside(t - 0.1, 1.0)",
    "1e-6 * x.size / len(E) + np.sqrt(E) * 0.0",
    "1e-6 * math.exp(E.shape[0] * 0.0)",
    "1e-6 * pow(t, 2) + np.tanh(x) * 1e-7",
    # host: a Python number or truth value taken from the traced time
    "1e-6 if t < 0.2 else 0.0",
    "math.exp(-t) * 1e-6",
    "float(t) * 1e-6",
    "1e-6 * min(t, 0.5)",
    "1e-6 * int(t > 0.1)",
    "1e-6 * bool(t > 0.1)",
    # host: a shape that depends on the values (a tracer has none)
    "x[x >= 0.0] * 1e-6",
    # host: a shape the (NE, P) plane does not take
    "np.arange(3) * 1e-6",
    "np.ones_like(np.arange(5)) * x[0, :2]",
]


@pytest.mark.parametrize("body", _EXPRESSIONS)
def test_traced_or_host_as_the_jax_package_decides(body):
    mask = np.ones((3, 5), dtype=bool)
    mask[0, 0] = False
    E, _, _ = _grid(4)
    spec_j = jp.ExternalGenerationSpec(mode="custom", custom_body=body, custom_params={"a": 1.5})
    spec_t = tp.ExternalGenerationSpec(mode="custom", custom_body=body, custom_params={"a": 1.5})
    gj = j_gen.build_generation_program(spec_j, E, mask, jnp.float64)
    gt = t_gen.build_generation_program(spec_t, E, mask, "cpu", torch.float64)
    assert gt.host_mode == gj.host_mode
    if not gj.host_mode:  # and the traced values agree
        for t in (0.05, 0.25):
            a = np.asarray(gj.traced_fn(jnp.asarray(t)))
            b = gt.traced_fn(torch.tensor(t, dtype=torch.float64)).numpy()
            np.testing.assert_allclose(b, a, rtol=1e-14, atol=1e-300)
    else:  # host evaluation is the same function
        for t in (0.05, 0.25):
            try:
                a = j_gen.evaluate_generation_host(spec_j, E, int(mask.sum()), t, mask)
            except Exception as exc:  # noqa: BLE001 — the same refusal on both sides
                with pytest.raises(type(exc)):
                    t_gen.evaluate_generation_host(spec_t, E, int(mask.sum()), t, mask)
                continue
            b = t_gen.evaluate_generation_host(spec_t, E, int(mask.sum()), t, mask)
            np.testing.assert_array_equal(b, a)


def _recording_compiler(monkeypatch, fail_off_meta: bool):
    """Replace the expression compiler by one that records where it evaluates.

    With ``fail_off_meta`` it raises a device out-of-memory error on any
    tensor that is not on the meta device, standing in for a failing card.
    """
    seen = []

    def compile_safe_expression(body, variable_names, backend):
        def fn(E, x, y, t, params):
            seen.append((E.device.type, x.device.type, y.device.type, t.device.type, type(t)))
            if fail_off_meta and E.device.type != "meta":
                raise torch.cuda.OutOfMemoryError("out of memory on the device")
            return 1e-6 * E * x + y * t

        return fn

    monkeypatch.setattr(t_gen, "compile_safe_expression", compile_safe_expression)
    return seen


def test_traceability_probe_runs_on_the_meta_device(monkeypatch):
    # the probe checks shapes only, as jax.eval_shape does: nothing of it is
    # evaluated on the run's device
    seen = _recording_compiler(monkeypatch, fail_off_meta=False)
    E, _, _ = _grid(4)
    spec = tp.ExternalGenerationSpec(mode="custom", custom_body="unused")
    g = t_gen.build_generation_program(spec, E, np.ones((3, 5), dtype=bool), "cpu", torch.float64)
    assert not g.host_mode
    assert seen == [("meta",) * 4 + (t_gen._TracerProbe,)]
    out = g.traced_fn(torch.tensor(0.1, dtype=torch.float64))
    assert out.device.type == "cpu" and out.shape == (4, 3, 5)


def test_a_device_error_is_raised_and_never_selects_host_mode(monkeypatch):
    _recording_compiler(monkeypatch, fail_off_meta=True)
    E, _, _ = _grid(4)
    spec = tp.ExternalGenerationSpec(mode="custom", custom_body="unused")
    g = t_gen.build_generation_program(spec, E, np.ones((3, 5), dtype=bool), "cpu", torch.float64)
    assert not g.host_mode
    with pytest.raises(torch.cuda.OutOfMemoryError):
        g.traced_fn(torch.tensor(0.1, dtype=torch.float64))


def test_float32_times_on_the_device_match_the_host_times():
    # the traced generation reads t0 + k·dt formed on the device; the windows
    # read the same arithmetic on the host: both in the state dtype
    dt, t0, n = 0.05, np.float32(1.2345678), 40
    host = [t0 + np.float32(k) * np.float32(dt) for k in range(n)]
    dev = (torch.arange(n, dtype=torch.float32) * dt
           + torch.full((), float(t0), dtype=torch.float32)).numpy()
    np.testing.assert_array_equal(dev, np.asarray(host, dtype=np.float32))
