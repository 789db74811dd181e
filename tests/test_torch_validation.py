"""The port's validation suite against ``qpsim_tpu.validation``, on the CPU.

In float64 every gate gives the JAX package's ``passed`` flag and its
figures within 1e-12 absolute or 1e-9 relative; in float32 the suite
passes at the f32 tiers (``docs/f32_tiers.md``).  The gates drive the
port's public engine, so the recombination gate runs the collision step
at one energy bin.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
from qpsim_tpu import validation as jv  # noqa: E402

import qpsim_tpu_torch as T  # noqa: E402
from qpsim_tpu_torch import validation as tv  # noqa: E402

_GATES = ["detailed_balance", "photon_detailed_balance", "thermal_stability", "pure_diffusion",
          "pure_scattering", "pure_recombination"]


def _close(a, b, path=""):
    if isinstance(a, dict):
        assert set(b) == set(a), path
        for k in a:
            _close(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (bool, np.bool_, str)):
        assert b == a, path
    else:
        a, b = float(a), float(b)
        assert abs(b - a) <= max(1e-12, 1e-9 * abs(a)), (path, a, b)


@pytest.mark.parametrize("gate", _GATES)
def test_gate_matches_jax(gate):
    assert jax.config.jax_enable_x64  # the JAX side at its float64 tiers
    p = jv.SimulationParameters(**jv._SUITE_DEFAULTS)
    fn_j, fn_t = getattr(jv, f"validate_{gate}"), getattr(tv, f"validate_{gate}")
    extra = {} if gate == "detailed_balance" else dict(device="cpu")
    a, b = fn_j(p), fn_t(p, **extra)
    assert b["passed"] is a["passed"] or b["passed"] == a["passed"]
    _close(a, b)


def test_suite_matches_jax_and_passes():
    a = jv.run_fast_validation_suite()
    b = T.run_fast_validation_suite(device="cpu")
    assert isinstance(b, T.ValidationReport)
    assert b.overall_passed and a.overall_passed
    assert {k: v["passed"] for k, v in b.sections().items()} == {
        k: v["passed"] for k, v in a.sections().items()}
    _close(a.as_dict(), b.as_dict())


def test_suite_passes_in_float32_at_the_f32_tiers():
    r = T.run_fast_validation_suite(device="cpu", dtype=torch.float32)
    assert r.overall_passed, r.as_dict()
    assert r.thermal_stability["tolerance"] == 1e-4
    assert r.pure_diffusion["tolerance"] == 1e-6
    assert r.photon_detailed_balance["tolerance"] == 1e-5


def test_suite_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(RuntimeError, match="CUDA"):
        T.run_fast_validation_suite()
