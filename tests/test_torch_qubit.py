"""The gap-asymmetric junction model against ``qpsim_tpu.qubit``, float64 on the CPU.

Temperature sweeps (photons on and off, rates rebuilt by detailed balance
or kept, explicit L-side rates), single steady states, RK4 evolution, the
chemical potentials and rates, to 1e-10 relative, with the same regime
strings; ``detailed_balance_rates`` (host floats) to 1e-13.  The port solves a
sweep's temperatures in one batched Newton iteration; the JAX package loops
over them.  Entry points run on the card unless asked for the CPU.
"""

from dataclasses import replace

import numpy as np
import pytest
import torch

from qpsim_tpu import qubit as jq

from qpsim_tpu_torch import qubit as tq

_RATES = dict(l_00=3.0, l_11=2.0, l_10=5.0, l_01=1.0)
#: the JAX package's own test device (tests/test_qubit_junction.py)
_DEVICE = dict(gap_L=190.0, gap_R=180.0, omega_10=20.0, cooper_pairs_L=1.0e9, gamma_ph=3.0e-7, tau_R=5e4)


def _both(**kw):
    kw = {**_DEVICE, **kw}
    return (jq.JunctionParams(rates=jq.TunnelingRates(**_RATES), **kw),
            tq.JunctionParams(rates=tq.TunnelingRates(**_RATES), **kw))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want))) / max(float(np.max(np.abs(want))), 1e-300)


@pytest.mark.parametrize(
    "photons_on,rebalance,extra,temps",
    [(True, True, {}, np.linspace(0.02, 0.28, 9)),  # the JAX package's crossover sweep
     (False, True, {}, np.array([0.1, 0.17, 0.26])),  # equilibrium (μ ≈ 0) where Newton resolves it
     (True, False, {}, np.array([0.05, 0.15, 0.25])),
     (True, True, dict(generation="balanced", tau_E=5e3), np.array([0.03, 0.12, 0.22]))],
    ids=["photons", "no_photons", "fixed_rates", "balanced"],
)
def test_temperature_sweep_matches(photons_on, rebalance, extra, temps):
    jp, tp = _both(**extra)
    want = jq.temperature_sweep(jp, temps, photons_on=photons_on, rebalance_rates=rebalance)
    got = tq.temperature_sweep(tp, temps, photons_on=photons_on, rebalance_rates=rebalance, device="cpu")
    np.testing.assert_array_equal(got["temperatures_K"], want["temperatures_K"])
    for key in ("states", "p1", "parity_rate_per_ns"):
        assert _rel(got[key], want[key]) <= 1e-10, key
    # μ is near zero at equilibrium: hold it against its scale, k_B·T ≈ 10 µeV
    assert float(np.max(np.abs(got["mu_ueV"] - np.asarray(want["mu_ueV"])))) <= 1e-9
    assert got["regimes"] == want["regimes"]


def test_explicit_l_rates_and_detailed_balance_are_equal():
    jp, tp = _both()
    l_rates = dict(l_00=2e-3, l_11=5e-4, l_10=1e-3, l_01=2e-4)
    for T in (0.05, 0.2):
        a = tq.detailed_balance_rates(tp, T, **l_rates).__dict__
        b = jq.detailed_balance_rates(jp, T, **l_rates).__dict__
        assert a.keys() == b.keys()
        for k in a:  # thermal densities through torch's exp/erf and XLA's: ulps apart
            assert abs(a[k] - b[k]) <= 1e-13 * abs(b[k]), k
    temps = np.array([0.08, 0.2])
    want = jq.temperature_sweep(jp, temps, l_rates=l_rates)
    got = tq.temperature_sweep(tp, temps, l_rates=l_rates, device="cpu")
    assert _rel(got["states"], want["states"]) <= 1e-10
    assert got["regimes"] == want["regimes"]


def test_steady_state_rates_and_potentials_match():
    jp, tp = _both()
    T = 0.12
    jp = replace(jp, rates=jq.detailed_balance_rates(jp, T, **_RATES))
    tp = replace(tp, rates=tq.detailed_balance_rates(tp, T, **_RATES))
    for photons_on in (True, False):
        want = np.asarray(jq.steady_state(jp, T, photons_on=photons_on))
        got = tq.steady_state(tp, T, photons_on=photons_on, device="cpu")
        assert got.shape == (4,) and _rel(got.numpy(), want) <= 1e-10
        assert float(np.max(np.abs(tq.chemical_potentials(tp, T, got).numpy()
                                   - np.asarray(jq.chemical_potentials(jp, T, want))))) <= 1e-9
        assert _rel(tq.parity_switching_rate(tp, got).numpy(), jq.parity_switching_rate(jp, want)) <= 1e-10
        assert _rel(tq.qp_relaxation_rate(tp, got).numpy(), jq.qp_relaxation_rate(jp, want)) <= 1e-10
        off = want * np.array([1.3, 0.7, 1.1, 0.9])  # away from the fixed point, where d/dt is ~0
        assert _rel(tq.junction_rhs(tp, T, torch.as_tensor(off), photons_on=photons_on).numpy(),
                    jq.junction_rhs(jp, T, off, photons_on=photons_on)) <= 1e-12
    for mu in ([0.1, 0.2, -0.3], [3.0, 3.0, 3.1], [2.0, 5.0, 5.2], [1.0, 4.0, 9.0]):
        assert tq.classify_regime(mu) == jq.classify_regime(mu)
    for T in (0.05, 0.3):
        for a, b in zip(tq.thermal_densities(tp, T), jq.thermal_densities(jp, T)):
            assert _rel(a.numpy(), b) <= 1e-13
        for balanced in (False, True):
            for a, b in zip(tq.thermal_generation(tp, T, balanced=balanced),
                            jq.thermal_generation(jp, T, balanced=balanced)):
                assert _rel(a.numpy(), b) <= 1e-13


def test_evolve_matches():
    jp, tp = _both()
    y0 = [1e-6, 2e-6, 5e-7, 0.1]
    for store_every in (1, 4):
        ta, ya = jq.evolve(jp, 0.15, y0, 10.0, 24, store_every=store_every)
        tb, yb = tq.evolve(tp, 0.15, y0, 10.0, 24, store_every=store_every, device="cpu")
        np.testing.assert_array_equal(tb.numpy(), np.asarray(ta))
        assert yb.shape == np.asarray(ya).shape and _rel(yb.numpy(), ya) <= 1e-10


def test_entry_points_run_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tp = _both()
    for call in (lambda: tq.steady_state(tp, 0.1), lambda: tq.evolve(tp, 0.1, [0, 0, 0, 0], 1.0, 2),
                 lambda: tq.temperature_sweep(tp, [0.1])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
