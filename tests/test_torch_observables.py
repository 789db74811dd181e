"""The resonator observables against ``qpsim_tpu.observables``, float64 on the CPU.

The numpy functions (``occupation_from_spectral``,
``mattis_bardeen_conductivity``, ``mkid_response_trace``) are the JAX
package's copies and are held bit-equal.  The differentiable
Mattis–Bardeen function is torch, with its own ``jnp.interp``
(``observables.interp``): values and gradients — through the occupation
and through the gap, at the grid's first edge and off it — within 1e-12
of ``jax.grad``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qpsim_tpu import observables as jo
from qpsim_tpu.ops.energy_grid import build_energy_grid

from qpsim_tpu_torch import observables as to


def _grid(ne=12, gap=180.0, emax=4.0):
    return build_energy_grid(gap, 1.0, emax, ne)


def test_constants_and_numpy_functions_are_bit_equal():
    assert to.PLANCK_UEV_PER_GHZ == jo.PLANCK_UEV_PER_GHZ
    E, _ = _grid()
    rng = np.random.default_rng(0)
    n = rng.uniform(0.0, 1e-3, (E.size, 3, 4))
    for gamma in (0.0, 0.05):
        np.testing.assert_array_equal(to.occupation_from_spectral(n, E, 180.0, gamma),
                                      jo.occupation_from_spectral(n, E, 180.0, gamma))
    f = rng.uniform(0.0, 1e-2, E.size)
    for hnu in (5.0 * jo.PLANCK_UEV_PER_GHZ, 200.0):
        assert to.mattis_bardeen_conductivity(f, E, 180.0, hnu) == jo.mattis_bardeen_conductivity(f, E, 180.0, hnu)
    for bad in (0.0, 400.0):
        with pytest.raises(ValueError):
            to.mattis_bardeen_conductivity(f, E, 180.0, bad)


def test_mkid_response_trace_is_bit_equal():
    E, _ = _grid(ne=8)
    rng = np.random.default_rng(1)
    mask = np.ones((5, 6), dtype=bool)
    mask[1:3, 2:4] = False
    frames = []
    for k in range(4):
        stack = rng.uniform(0.0, 1e-4 * (k + 1), (E.size, 5, 6))
        stack[:, ~mask] = np.nan
        frames.append(list(stack))
    weights = rng.uniform(0.5, 1.5, mask.shape)
    for kw in (dict(), dict(weights=weights, readout_ghz=6.0, alpha=0.3, reference_index=1, dynes_gamma=0.02)):
        a = to.mkid_response_trace(frames, E, 180.0, **kw)
        b = jo.mkid_response_trace(frames, E, 180.0, **kw)
        assert a == b


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_interp_matches_jnp_interp_values_and_gradients(dtype):
    xp = np.array([1.0, 2.0, 2.0, 3.5, 5.0], dtype=dtype)  # a repeated node: dx = 0
    fp = np.array([0.3, -1.0, 0.7, 2.0, 0.1], dtype=dtype)
    x = np.array([0.2, 1.0, 1.5, 2.0, 2.7, 3.5, 4.999, 5.0, 5.2], dtype=dtype)
    left, right = dtype(-0.5), dtype(0.0)
    want = np.asarray(jnp.interp(x, xp, fp, left=left, right=right))
    tx, tf = torch.tensor(x, requires_grad=True), torch.tensor(fp, requires_grad=True)
    got = to.interp(tx, torch.tensor(xp), tf, torch.tensor(left), torch.tensor(right))
    tol = 1e-6 if dtype == np.float32 else 1e-15
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=tol, atol=tol)
    w = np.linspace(0.5, 1.5, x.size).astype(dtype)
    gx, gf = jax.grad(lambda a, b: jnp.sum(jnp.interp(a, xp, b, left=left, right=right) * w),
                      argnums=(0, 1))(x, fp)
    (got * torch.tensor(w)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), rtol=tol, atol=tol)
    np.testing.assert_allclose(tf.grad.numpy(), np.asarray(gf), rtol=tol, atol=tol)


@pytest.mark.parametrize("gap", [180.0, 176.5, 171.0], ids=["nominal", "below", "far_below"])
@pytest.mark.parametrize("ghz", [5.0, 12.0])
def test_traced_mattis_bardeen_matches_jax_values_and_gradients(gap, ghz):
    E, _ = _grid()
    f = np.random.default_rng(2).uniform(0.0, 1e-3, E.size)
    hnu = ghz * jo.PLANCK_UEV_PER_GHZ
    j_fn = lambda ff, gg: jo.mattis_bardeen_conductivity_traced(ff, E, gg, hnu)
    want = [float(v) for v in j_fn(jnp.asarray(f), jnp.asarray(gap))]
    tf = torch.tensor(f, requires_grad=True)
    tg = torch.tensor(gap, dtype=torch.float64, requires_grad=True)
    got = to.mattis_bardeen_conductivity_traced(tf, E, tg, hnu)
    for a, b in zip(got, want):
        assert abs(float(a.detach()) - b) <= 1e-12 * abs(b)
    # the same integrals as the numpy form at the grid's own gap
    if gap == 180.0:
        np.testing.assert_allclose([float(v.detach()) for v in got], to.mattis_bardeen_conductivity(f, E, gap, hnu),
                                   rtol=1e-12)
    for i in range(2):
        gf, gg = jax.grad(lambda ff, gg: j_fn(ff, gg)[i], argnums=(0, 1))(jnp.asarray(f), jnp.asarray(gap))
        tf.grad = tg.grad = None
        got = to.mattis_bardeen_conductivity_traced(tf, E, tg, hnu)
        got[i].backward()
        assert np.all(np.isfinite(tf.grad.numpy())) and np.isfinite(float(tg.grad))
        np.testing.assert_allclose(tf.grad.numpy(), np.asarray(gf), rtol=1e-12, atol=1e-12 * np.abs(gf).max())
        assert abs(float(tg.grad) - float(gg)) <= 1e-12 * max(abs(float(gg)), 1e-300)


def test_traced_mattis_bardeen_takes_a_batch_of_occupations():
    E, _ = _grid()
    f = np.random.default_rng(3).uniform(0.0, 1e-3, (4, E.size))
    hnu = 5.0 * jo.PLANCK_UEV_PER_GHZ
    s1, s2 = to.mattis_bardeen_conductivity_traced(torch.as_tensor(f), E, torch.tensor(176.0, dtype=torch.float64),
                                                    hnu)
    want = jax.vmap(lambda ff: jnp.stack(jo.mattis_bardeen_conductivity_traced(ff, E, 176.0, hnu)))(jnp.asarray(f))
    assert s1.shape == s2.shape == (4,)
    np.testing.assert_allclose(torch.stack([s1, s2], -1).numpy(), np.asarray(want), rtol=1e-12)
