"""The differentiable simulation against ``qpsim_tpu.diff``, float64 on the CPU.

``qpsim_tpu_torch.diff.make_differentiable_sim`` is held to the JAX
package's: every observable (values ≤ 1e-10) and the gradients of one loss
over all of them (≤ 1e-8 relative) with respect to D0, τ_s, τ_r, a traced
gap, the pulse rate and the photon coupling and occupancy, in the three
remat modes, by ``.backward()`` and by ``torch.autograd.grad`` (the JAX
reference computed once, without remat); the solve
counts of each mode; members of a batch against lone calls; the fits
against the JAX package's (optax's Adam and torch's round differently: the
fitted values within 1e-6).  K10's gradient itself is held in
``tests/test_torch_tridiag_grad.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from qpsim_tpu import diff as jd  # noqa: E402

from qpsim_tpu_torch import diff as td  # noqa: E402
from qpsim_tpu_torch.ops import tridiag_cuda  # noqa: E402

F64 = torch.float64


def _close(got, want, tol):
    scale = max(float(np.max(np.abs(want))), 1e-300)
    assert float(np.max(np.abs(got - want))) / scale <= tol


# ---------------------------------------------------------------- the differentiable simulation

_MASK = np.ones((5, 8), dtype=bool)
_MASK[2, 3:5] = False  # a cutout: a real 2D masked geometry
_FIELD = np.where(_MASK, np.random.default_rng(1).uniform(0.5e-4, 1.5e-4, _MASK.shape), 0.0)
_SIM = dict(
    mask=_MASK, num_energy_bins=5, energy_max_factor=3.0, dt=0.5, n_steps=6, initial_field=_FIELD,
    bath_temperature=0.1, phonon_feedback=True,
    observables=("total", "spatial", "phonon_spectrum", "phonon_total", "mkid"), store_every=3,
    pulse_window=(1.0, 1.0), photon_omega=2.6 * 180.0, photon_window=(0.5, 1.5),
)
_PARAMS = {"D0": 6.0, "tau_s": 440.0, "tau_r": 300.0, "gap": 178.0, "pulse_rate": 2e-5,
           "photon_coupling": 1e-3, "photon_occupancy": 2.0}
_W = np.random.default_rng(2).uniform(0.5, 1.5, (3, *_MASK.shape))


def _loss(out, xp):
    """One scalar over every observable, each term of order one or more."""
    w = jnp.asarray(_W) if xp is jnp else torch.as_tensor(_W)
    return (xp.sum(out["spatial"] * w) / 1e-4 + xp.sum(out["total"]) / 1e-4
            + xp.sum(out["phonon_total"]) / 10 + 1e3 * xp.sum(out["mkid_df"])
            + 1e3 * xp.sum(out["mkid_dq"]) + xp.sum(out["phonon_spectrum"]))


@pytest.fixture(scope="module")
def jax_reference():
    sim = jd.make_differentiable_sim(**_SIM, remat=False)
    p = {k: jnp.asarray(v) for k, v in _PARAMS.items()}
    grads = jax.grad(lambda q: _loss(sim(q), jnp))(p)
    return {k: np.asarray(v) for k, v in sim(p).items()}, {k: float(v) for k, v in grads.items()}


@pytest.mark.parametrize("remat,chunk", [(False, None), (True, None), (True, 4)],
                         ids=["plain", "remat", "two_level"])
def test_sim_matches_jax_values_and_gradients(jax_reference, remat, chunk):
    want, want_g = jax_reference
    sim = td.make_differentiable_sim(**_SIM, remat=remat, remat_chunk=chunk, device="cpu")
    p = {k: torch.tensor(v, dtype=F64, requires_grad=True) for k, v in _PARAMS.items()}
    out = sim(p)
    assert set(out) == set(want)
    for k, v in out.items():
        assert v.shape == want[k].shape, k
        _close(v.detach().numpy(), want[k], 1e-10)
    assert np.abs(out["spatial"].detach().numpy()[:, ~_MASK]).max() == 0.0
    loss = _loss(out, torch)
    # torch.autograd.grad (jax.grad's form) and .backward() through every remat mode
    grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()), retain_graph=True)))
    loss.backward()
    for k, g in want_g.items():
        assert abs(float(grads[k]) - g) <= 1e-8 * abs(g), k
        assert abs(float(p[k].grad) - g) <= 1e-8 * abs(g), k


def test_remat_modes_solve_counts():
    """Solves per half-step: 2 without remat (forward, transposed), 3 with
    remat (a recompute), 4 two-level (the chunk's recompute too)."""
    counts = {}
    calls = [0]
    solve = tridiag_cuda._solve

    def counting(*args, **kw):
        calls[0] += 1
        return solve(*args, **kw)

    tridiag_cuda._solve = counting
    try:
        for remat, chunk in ((False, None), (True, None), (True, 5)):
            sim = td.make_differentiable_sim(nx=8, num_energy_bins=4, energy_max_factor=3.0, dt=0.5,
                                             n_steps=10, remat=remat, remat_chunk=chunk, device="cpu")
            p = {k: torch.tensor(v, dtype=F64, requires_grad=True) for k, v in
                 dict(D0=6.0, tau_s=440.0, tau_r=300.0).items()}
            calls[0] = 0
            total = sim(p)["total"]
            fwd = calls[0]
            total.sum().backward()
            counts[(remat, chunk)] = (fwd, calls[0] - fwd)
    finally:
        tridiag_cuda._solve = solve
    n = 10  # steps, 2 halves each
    assert counts[(False, None)] == (2 * n, 2 * n)
    assert counts[(True, None)] == (2 * n, 4 * n)
    assert counts[(True, 5)] == (2 * n, 6 * n)


def test_batched_members_match_lone_calls_with_one_solve_per_half_step():
    sim = td.make_differentiable_sim(nx=10, num_energy_bins=5, energy_max_factor=3.0, dt=0.5, n_steps=5,
                                     observables=("total", "spatial", "mkid"), store_every=5, device="cpu")
    tau_r = torch.tensor([250.0, 300.0, 500.0], dtype=F64, requires_grad=True)
    calls = [0]
    solve = tridiag_cuda._solve

    def counting(*args, **kw):
        calls[0] += 1
        return solve(*args, **kw)

    tridiag_cuda._solve = counting
    try:
        out = sim({"D0": 6.0, "tau_s": 440.0, "tau_r": tau_r, "gap": torch.tensor([178.0, 180.0, 176.0])})
    finally:
        tridiag_cuda._solve = solve
    assert calls[0] == 2 * 5  # every member's lines in each half's one solve
    out["total"][:, -1].sum().backward()
    for m in range(3):
        tr = torch.tensor(float(tau_r[m].detach()), dtype=F64, requires_grad=True)
        lone = sim({"D0": 6.0, "tau_s": 440.0, "tau_r": tr, "gap": [178.0, 180.0, 176.0][m]})
        for k, v in lone.items():
            _close(out[k][m].detach().numpy(), v.detach().numpy(), 1e-13)
        lone["total"][-1].backward()
        assert abs(float(tau_r.grad[m]) - float(tr.grad)) <= 1e-12 * abs(float(tr.grad))


_DECAY = dict(nx=12, num_energy_bins=5, energy_max_factor=3.0, dt=2.0, n_steps=8, n0=0.5,
              bath_temperature=0.0, phonon_feedback=False)


def test_fit_parameters_matches_jax():
    jfn = jd.make_differentiable_decay(**_DECAY)
    tfn = td.make_differentiable_decay(**_DECAY, device="cpu")
    true = {"D0": 6.0, "tau_s": 440.0, "tau_r": 250.0}
    observed = np.asarray(jfn({k: jnp.asarray(v) for k, v in true.items()}))
    _close(tfn(true).numpy(), observed, 1e-10)
    fixed = {"D0": 6.0, "tau_s": 440.0}
    want = jd.fit_parameters(observed, {"tau_r": 600.0}, decay_fn=lambda p: jfn({**fixed, **p}),
                             learning_rate=0.08, n_iters=12)
    got = td.fit_parameters(observed, {"tau_r": 600.0}, decay_fn=lambda p: tfn({**fixed, **p}),
                            learning_rate=0.08, n_iters=12)
    assert got["tau_r"] < 600.0 * 0.5  # it moved towards 250
    assert abs(got["tau_r"] - want["tau_r"]) <= 1e-6 * want["tau_r"]


def test_fit_ensemble_matches_jax():
    jfn = jd.make_differentiable_decay(**_DECAY)
    tfn = td.make_differentiable_decay(**_DECAY, device="cpu")
    true_r = np.array([250.0, 500.0, 350.0])
    observed = np.stack([np.asarray(jfn({"D0": 6.0, "tau_s": 440.0, "tau_r": t})) for t in true_r])
    init = {"D0": np.full(3, 6.0), "tau_s": np.full(3, 440.0), "tau_r": np.full(3, 400.0)}
    want = jd.fit_ensemble(observed, init, decay_fn=jfn, learning_rate=0.1, n_iters=8)
    got = td.fit_ensemble(observed, init, decay_fn=tfn, learning_rate=0.1, n_iters=8)
    for k in init:
        assert got[k].shape == (3,)
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6)


def test_sim_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        td.make_differentiable_sim(nx=4, num_energy_bins=3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        td.make_differentiable_decay(nx=4, num_energy_bins=3)
