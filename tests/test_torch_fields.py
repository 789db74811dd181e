"""The port's initial-condition builders (``fields``) against ``qpsim_tpu.fields``, float64 on the CPU.

The builders are host numpy copies: every kind is pinned bit-equal
(``np.array_equal``).  Engine runs with ``initial_condition_spec`` — every
phonon kind and the full-custom states — match the JAX package's frames
at rtol 1e-10 and mass at 1e-12; the default initial state, now formed on
the device, still reproduces the JAX package's first frame exactly.
"""

import dataclasses

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import qpsim_tpu as J  # noqa: E402
from qpsim_tpu import fields as jf  # noqa: E402
from qpsim_tpu.geometry.mask import create_intrinsic_geometry, mask_from_lists  # noqa: E402
from qpsim_tpu.models import params as jp  # noqa: E402
from qpsim_tpu.ops.energy_grid import build_energy_grid  # noqa: E402
from qpsim_tpu.ops.phonon_map import build_phonon_frequency_map  # noqa: E402

import qpsim_tpu_torch as T  # noqa: E402
from qpsim_tpu_torch import fields as tf  # noqa: E402
from qpsim_tpu_torch.models import params as tp  # noqa: E402
from test_torch_photon_drive import assert_runs_match  # noqa: E402

GAP = 180.0

#: IC specs by name, as keyword dicts (the spec classes of the two packages differ)
_SPECS = {
    "default": {},
    "gaussian_fermi_dirac": dict(
        spatial_kind="gaussian", spatial_params={"amplitude": 2.0, "x0": 0.3, "y0": 0.6, "sigma": 0.2},
        energy_kind="fermi_dirac", energy_params={"temperature": 0.3},
        phonon_spatial_kind="uniform", phonon_spatial_params={"value": 1.5},
        phonon_energy_kind="bose_einstein", phonon_energy_params={"temperature": 0.2}),
    "point_uniform": dict(
        spatial_kind="point", spatial_params={"value": 3.0, "x0": 0.0, "y0": 0.0},
        energy_kind="uniform", energy_params={"value": 2.0},
        phonon_spatial_kind="gaussian", phonon_energy_kind="uniform",
        phonon_energy_params={"value": 0.01}),
    "custom_vectorised": dict(
        spatial_kind="custom", spatial_custom_body="return np.exp(-x / 0.3) * (1.0 + y)",
        energy_kind="custom", energy_custom_body="return np.exp(-(E - gap) / 100.0)",
        phonon_spatial_kind="custom", phonon_spatial_custom_body="return 1.0 + x * y",
        phonon_energy_kind="custom",
        phonon_energy_custom_body="return params.get('a', 1.0) * np.exp(-E / 200.0)",
        phonon_energy_custom_params={"a": 0.05}),
    "custom_per_pixel": dict(  # a Python conditional on x: the per-pixel fallback
        spatial_kind="custom", spatial_custom_body="return 2.0 if x < 0.5 else 1.0",
        energy_kind="custom", energy_custom_body="return 1.0 if E < 2.0 * gap else 0.5",
        phonon_spatial_kind="custom", phonon_spatial_custom_body="return 1.0 if y < 0.5 else 2.0",
        phonon_energy_kind="custom", phonon_energy_custom_body="return 0.01 if E < 300.0 else 0.0"),
    "full_custom": dict(
        qp_full_custom_enabled=True,
        qp_full_custom_body="return 1e-6 * np.exp(-((x-0.5)**2 + (y-0.5)**2) / 0.05) * np.exp(-E / 500.0)",
        phonon_full_custom_enabled="yes",
        phonon_full_custom_body="return 0.01 * np.exp(-E / 300.0) * (1.0 + 0.0 * x)"),
    "full_custom_per_pixel": dict(
        qp_full_custom_enabled=True,
        qp_full_custom_body="return 1e-6 if (x < 0.5 and E < 400.0) else 2e-7",
        phonon_full_custom_enabled=True,
        phonon_full_custom_body="return 0.02 if y < 0.5 else 0.01"),
}


def _mask():
    geo = create_intrinsic_geometry(width=14, height=9)
    return mask_from_lists(geo.mask), geo.edges


@pytest.mark.parametrize("name", list(_SPECS))
def test_builders_are_bit_equal(name):
    mask, _ = _mask()
    E, _ = build_energy_grid(GAP, 1.0, 4.0, 8)
    omega = build_phonon_frequency_map(E).omega_bins
    sj, st = jp.InitialConditionSpec(**_SPECS[name]), tp.InitialConditionSpec(**_SPECS[name])
    cj, ct = jf.canonicalize_initial_condition(sj), tf.canonicalize_initial_condition(st)
    assert dataclasses.asdict(ct) == dataclasses.asdict(cj)
    pairs = [
        (jf.build_initial_field(mask, sj), tf.build_initial_field(mask, st)),
        (jf.build_initial_phonon_spatial_field(mask, sj), tf.build_initial_phonon_spatial_field(mask, st)),
        (jf.build_initial_energy_weights(E, GAP, 0.05, sj, 0.1),
         tf.build_initial_energy_weights(E, GAP, 0.05, st, 0.1)),
        (jf.build_initial_qp_energy_state(mask, E, sj), tf.build_initial_qp_energy_state(mask, E, st)),
        (jf.build_initial_phonon_energy_weights(omega, sj, 0.1),
         tf.build_initial_phonon_energy_weights(omega, st, 0.1)),
        (jf.build_initial_phonon_energy_state(mask, omega, sj, 0.1),
         tf.build_initial_phonon_energy_state(mask, omega, st, 0.1)),
    ]
    for a, b in pairs:
        if a is None:
            assert b is None
        else:
            assert np.array_equal(b, a)


def test_default_initial_condition_and_errors_match():
    assert dataclasses.asdict(tf.default_initial_condition()) == dataclasses.asdict(
        jf.default_initial_condition())
    mask, _ = _mask()
    E, _ = build_energy_grid(GAP, 1.0, 4.0, 8)
    bad = [dict(spatial_kind="spiral"), dict(energy_kind="maxwell"),
           dict(phonon_energy_kind="custom", phonon_energy_custom_body="return -1.0"),
           dict(qp_full_custom_enabled=True, qp_full_custom_body="return np.ones_like(E) * -1.0")]
    for kw in bad:
        msgs = []
        for mod, cls in ((jf, jp.InitialConditionSpec), (tf, tp.InitialConditionSpec)):
            spec = cls(**kw)
            with pytest.raises(ValueError) as info:
                mod.build_initial_field(mask, spec)
                mod.build_initial_energy_weights(E, GAP, 0.0, spec, 0.1)
                mod.build_initial_qp_energy_state(mask, E, spec)
                mod.build_initial_phonon_energy_weights(E, spec, 0.1)
            msgs.append(str(info.value))
        assert msgs[1] == msgs[0]


@pytest.mark.parametrize("name", list(_SPECS))
def test_engine_with_initial_condition_matches_jax(name):
    mask, edges = _mask()
    bcs = {e.edge_id: jp.BoundaryCondition(kind="reflective") for e in edges}
    E, _ = build_energy_grid(GAP, 1.0, 4.0, 8)
    sj, st = jp.InitialConditionSpec(**_SPECS[name]), tp.InitialConditionSpec(**_SPECS[name])
    # as a caller builds a run from a spec: the QP field and weights from it too
    init = 1e-6 * jf.build_initial_field(mask, sj)
    weights = jf.build_initial_energy_weights(E, GAP, 0.0, sj, 0.1)
    kw = dict(
        mask=mask, edges=edges, edge_conditions=bcs, initial_field=init, energy_weights=weights,
        diffusion_coefficient=6.0, dt=0.05, total_time=0.3, dx=1.0, store_every=2,
        energy_gap=GAP, energy_max_factor=4.0, num_energy_bins=8,
        enable_recombination=True, enable_scattering=True, bath_temperature=0.1,
        strang_mode="merged",
    )
    a = J.run_2d_crank_nicolson(**kw, initial_condition_spec=sj)
    b = T.run_2d_crank_nicolson(**kw, initial_condition_spec=st, device="cpu")
    assert_runs_match(a, b)
    # the first frame is the initial state itself
    assert np.array_equal(np.nan_to_num(b[1][0]), np.nan_to_num(a[1][0]))


@pytest.mark.parametrize("detail", ["full", "integrated"])
def test_default_initial_state_reproduces_the_first_frame(detail):
    mask, edges = _mask()
    bcs = {e.edge_id: jp.BoundaryCondition(kind="reflective") for e in edges}
    rng = np.random.default_rng(4)
    init = np.where(mask, rng.uniform(1e-7, 1e-5, mask.shape), 0.0)
    kw = dict(
        mask=mask, edges=edges, edge_conditions=bcs, initial_field=init,
        diffusion_coefficient=6.0, dt=0.05, total_time=0.1, dx=1.0, store_every=1,
        energy_gap=GAP, energy_max_factor=4.0, num_energy_bins=8, dynes_gamma=0.02,
        enable_recombination=True, enable_scattering=True, bath_temperature=0.1,
        snapshot_detail=detail,
    )
    ha, hb = {}, {}
    a = J.run_2d_crank_nicolson(**kw, phonon_history_out=ha)
    b = T.run_2d_crank_nicolson(**kw, phonon_history_out=hb, device="cpu")
    assert np.array_equal(np.nan_to_num(b[1][0]), np.nan_to_num(a[1][0]))
    np.testing.assert_allclose(b[2][0], a[2][0], rtol=1e-15)
    assert np.array_equal(np.nan_to_num(hb["phonon_frames"][0]), np.nan_to_num(ha["phonon_frames"][0]))
    if detail == "full":
        for fa, fb in zip(a[4][0], b[4][0]):
            assert np.array_equal(np.nan_to_num(fb), np.nan_to_num(fa))
