"""The collision substep: plain version against ``qpsim_tpu``, kernel tables on the CPU.

Float64 on the CPU.  The plain PyTorch version is held against the XLA
integrator (``make_collision_step``) and against the Pallas kernel in
interpret mode, whose Taylor-expm1 hybrid (relative error ≲ 1e-10) sets the
looser tolerance there.  The CUDA kernel itself runs only on the card; its
tables and its walk (ordered pairs for the QP update, per-ω-row pair lists
for the phonons) are checked here by a NumPy transcription of the kernel.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from qpsim_tpu.ops.collisions import build_collision_plan_arrays as j_plan  # noqa: E402
from qpsim_tpu.ops.collisions import make_collision_step  # noqa: E402
from qpsim_tpu.ops.dos import dynes_density_of_states, thermal_phonon_occupation  # noqa: E402
from qpsim_tpu.ops.energy_grid import build_energy_grid  # noqa: E402
from qpsim_tpu.ops.kernels import recombination_kernel_base, scattering_kernel_base  # noqa: E402
from qpsim_tpu.ops.pallas_collisions import (  # noqa: E402
    _uniform_pair_rows,
    build_pallas_collision_step,
)
from qpsim_tpu.ops.phonon_map import build_phonon_frequency_map  # noqa: E402

from qpsim_tpu_torch.interop import (  # noqa: E402
    collision_tables_from_numpy,
    state_to_numpy,
    state_to_torch,
)
from qpsim_tpu_torch.ops import collisions_cuda  # noqa: E402
from qpsim_tpu_torch.ops.collisions import collision_step_plain  # noqa: E402

GAP = 180.0
DT = 0.02


def _setup(ne, *, scattering=True, recombination=True, phonons=True, seed=0, ny=4, nx=32):
    """Host physics from the JAX package, the port's plan from it, and a state."""
    E, dE = build_energy_grid(GAP, 1.0, 4.0, ne)
    pm = build_phonon_frequency_map(E)
    rho = dynes_density_of_states(E, GAP, 0.0)
    Ks = scattering_kernel_base(E, GAP, 440.0, 1.2) if scattering else None
    Kr = recombination_kernel_base(E, GAP, 520.0, 1.2) if recombination else None
    plan = collision_tables_from_numpy(
        dE=dE, rho=rho, K_s0=Ks, K_r0=Kr, omega_bins=pm.omega_bins, idx_diff=pm.idx_diff,
        idx_sum=pm.idx_sum, diff_sign=pm.diff_sign, enable_scattering=scattering,
        enable_recombination=recombination, update_phonons=phonons, device="cpu",
        dtype=torch.float64, pixel_chunk=48,  # several chunks, one ragged
    )
    rng = np.random.default_rng(seed)
    q = rng.uniform(0, 2e-3, (ne, ny, nx)) * rho[:, None, None]
    ph = thermal_phonon_occupation(pm.omega_bins, 0.25)[:, None, None] * rng.uniform(
        0.5, 2.0, (pm.num_omega, ny, nx)
    )
    return dict(E=E, dE=dE, pm=pm, rho=rho, Ks=Ks, Kr=Kr, plan=plan, q=q, ph=ph)


def _xla_step(s, phonons, dt=DT):
    jp = j_plan(
        dE=s["dE"], rho_by_gap=s["rho"][None],
        K_r0_by_gap=None if s["Kr"] is None else s["Kr"][None],
        K_s0_by_gap=None if s["Ks"] is None else s["Ks"][None],
        gap_id=np.zeros(s["q"].shape[1:], np.int32), pmap=s["pm"],
        enable_recombination=s["Kr"] is not None, enable_scattering=s["Ks"] is not None,
        update_phonons=phonons, dtype=jnp.float64, pixel_chunk=48,
    )
    return make_collision_step(jp, dt)


def _port(s, q, ph, gen=None, dt=DT):
    qt, pt = state_to_torch(q, ph, "cpu", torch.float64)
    g = None if gen is None else torch.as_tensor(gen)
    return state_to_numpy(*collision_step_plain(s["plan"], qt, pt, dt, g))


@pytest.mark.parametrize(
    "scattering,recombination,phonons",
    [(True, False, True), (False, True, True), (True, True, True), (True, True, False)],
    ids=["scattering", "recombination", "both", "frozen_phonons"],
)
def test_plain_matches_xla_integrator(scattering, recombination, phonons):
    s = _setup(9, scattering=scattering, recombination=recombination, phonons=phonons)
    q1, p1 = (np.asarray(a) for a in _xla_step(s, phonons)(jnp.asarray(s["q"]), jnp.asarray(s["ph"])))
    q2, p2 = _port(s, s["q"], s["ph"])
    np.testing.assert_allclose(q2, q1, rtol=1e-12, atol=1e-30)
    np.testing.assert_allclose(p2, p1, rtol=1e-12, atol=1e-30)
    if not phonons:
        np.testing.assert_array_equal(p2, s["ph"])


@pytest.mark.parametrize("gen_input", [False, True], ids=["plain", "gen_fused"])
def test_plain_matches_pallas_interpret(gen_input):
    ne = 8
    s = _setup(ne, seed=3)
    kernel = build_pallas_collision_step(
        E_bins=s["E"], dE=s["dE"], rho=s["rho"], K_s0=s["Ks"], K_r0=s["Kr"], pmap=s["pm"],
        dt=DT, update_phonons=True, tile=128, interpret=True, gen_input=gen_input,
    )
    q, ph = jnp.asarray(s["q"]), jnp.asarray(s["ph"])
    gen = np.random.default_rng(5).uniform(0, 1e-6, s["q"].shape[1:]) if gen_input else None
    out = kernel(q, ph, jnp.asarray(gen)) if gen_input else kernel(q, ph)
    q1, p1 = (np.asarray(a) for a in out)
    q2, p2 = _port(s, s["q"], s["ph"], gen)
    np.testing.assert_allclose(q2, q1, rtol=1e-9, atol=1e-30)
    np.testing.assert_allclose(p2, p1, rtol=1e-9, atol=1e-30)


def test_split_omega_diagonal_keeps_exact_binning():
    # NE = 11 at Δ = 180, E_max/Δ = 4: one Toeplitz diagonal straddles two ω
    # bins; the per-pair maps (plain version and kernel tables) keep it
    s = _setup(11, ny=2, nx=6)
    assert _uniform_pair_rows(np.asarray(s["E"]), s["pm"]) is None  # it does split
    q1, p1 = (np.asarray(a) for a in _xla_step(s, True)(jnp.asarray(s["q"]), jnp.asarray(s["ph"])))
    q2, p2 = _port(s, s["q"], s["ph"])
    np.testing.assert_allclose(q2, q1, rtol=1e-12, atol=1e-30)
    np.testing.assert_allclose(p2, p1, rtol=1e-12, atol=1e-30)
    q3, p3 = _kernel_transcription(s["plan"], s["q"], s["ph"], None, DT)
    np.testing.assert_allclose(q3, q2, rtol=1e-12, atol=1e-30)
    np.testing.assert_allclose(p3, p2, rtol=1e-12, atol=1e-30)


def _kernel_transcription(plan, q, ph, gen, dt):
    """``csrc/collisions.cu`` line by line in NumPy, vectorised over pixels."""
    t = collisions_cuda.build_kernel_tables(plan)
    tab = lambda x: None if x is None else x.numpy()
    rho, ks, kr = tab(t.rho), tab(t.ks), tab(t.kr)
    idx_diff, idx_sum, sgn = t.idx_diff.numpy(), t.idx_sum.numpy(), t.sign.numpy()
    row_ptr, row_code = t.row_ptr.numpy(), t.row_code.numpy()
    ne, nw = plan.num_energy_bins, plan.num_omega
    qf = q.reshape(ne, -1) + (0.0 if gen is None else gen.reshape(1, -1))
    phf = ph.reshape(nw, -1)
    pv = rho[:, None] * np.maximum(1.0 - qf / np.maximum(rho, 1e-30)[:, None], 0.0)
    q_out = np.empty_like(qf)
    for i in range(ne):
        gain_s = loss_s = gain_r = loss_r = 0.0
        for j in range(ne):
            ij, ji = i * ne + j, j * ne + i
            if ks is not None:
                if sgn[ij] != 0:
                    n = phf[idx_diff[ij]]
                    loss_s = loss_s + ks[ij] * ((1.0 + n) if sgn[ij] > 0 else n) * pv[j]
                if sgn[ji] != 0:
                    n = phf[idx_diff[ji]]
                    gain_s = gain_s + ks[ji] * ((1.0 + n) if sgn[ji] > 0 else n) * qf[j]
            if kr is not None:
                sv = phf[idx_sum[ij]]
                loss_r = loss_r + kr[ij] * (1.0 + sv) * qf[j]
                gain_r = gain_r + kr[ij] * sv * pv[j]
        gain = pv[i] * gain_s + pv[i] * gain_r
        loss = loss_s + loss_r + np.zeros_like(qf[i])
        mu = np.maximum(loss, 0.0)
        p_term = np.maximum(gain + (mu - loss) * qf[i], 0.0)
        coeff = np.where(mu < 1e-14, dt, -np.expm1(-mu * dt) / np.maximum(mu, 1e-14))
        q_out[i] = np.maximum(np.exp(-mu * dt) * qf[i] + coeff * p_term, 0.0)
    if not plan.update_phonons:
        return q_out.reshape(q.shape), ph
    ph_out = np.empty_like(phf)
    for w in range(nw):
        a = b = np.zeros_like(phf[w])
        for code in row_code[row_ptr[w] : row_ptr[w + 1]]:
            pair, kind = code >> 2, code & 3
            i, j = divmod(int(pair), ne)
            if kind == 2:
                k = 0.5 * kr[pair]
                rec = k * qf[i] * qf[j]
                a, b = a + rec, b + (rec - k * pv[i] * pv[j])
            else:
                v = ks[pair] * qf[i] * pv[j]
                a, b = (a + v, b + v) if kind == 0 else (a, b - v)
        x = np.clip(b * dt, -80.0, 80.0)
        tiny = np.abs(b) < 1e-14
        coeff = np.where(tiny, dt, np.expm1(x) / np.where(tiny, 1.0, b))
        ph_out[w] = np.maximum(np.exp(x) * phf[w] + coeff * a, 0.0)
    return q_out.reshape(q.shape), ph_out.reshape(ph.shape)


@pytest.mark.parametrize(
    "scattering,recombination,phonons,gen",
    [(True, True, True, True), (True, False, True, False), (False, True, False, True)],
    ids=["both_gen", "scattering", "recombination_frozen_gen"],
)
def test_kernel_tables_reproduce_plain_version(scattering, recombination, phonons, gen):
    s = _setup(7, scattering=scattering, recombination=recombination, phonons=phonons, seed=11)
    g = np.random.default_rng(2).uniform(0, 1e-6, s["q"].shape[1:]) if gen else None
    q1, p1 = _port(s, s["q"], s["ph"], g)
    q2, p2 = _kernel_transcription(s["plan"], s["q"], s["ph"], g, DT)
    np.testing.assert_allclose(q2, q1, rtol=1e-12, atol=1e-30)
    np.testing.assert_allclose(p2, p1, rtol=1e-12, atol=1e-30)


def test_pair_rows_cover_every_pair_once():
    s = _setup(10)
    plan = s["plan"]
    row_ptr, row_code = collisions_cuda.pair_rows(plan)
    ne = plan.num_energy_bins
    assert row_ptr[0] == 0 and row_ptr[-1] == row_code.size
    assert row_code.size == ne * (ne - 1) + ne * ne  # scattering pairs i≠j, all recombination pairs
    for w in range(plan.num_omega):
        for code in row_code[row_ptr[w] : row_ptr[w + 1]]:
            i, j = divmod(int(code >> 2), ne)
            kind = code & 3
            if kind == collisions_cuda.RECOMBINATION:
                assert s["pm"].idx_sum[i, j] == w
            else:
                assert s["pm"].idx_diff[i, j] == w
                assert s["pm"].diff_sign[i, j] == (1 if kind == collisions_cuda.EMISSION else -1)


def test_wrapper_runs_plain_on_cpu_and_launches_nothing():
    s = _setup(6, seed=4)
    tables = collisions_cuda.build_kernel_tables(s["plan"])
    qt, pt = state_to_torch(s["q"], s["ph"], "cpu", torch.float64)
    gen = torch.full(qt.shape[1:], 1e-7, dtype=torch.float64)
    before = dict(collisions_cuda.LAUNCHES)
    a = collisions_cuda.collision_step(s["plan"], tables, qt, pt, DT, gen)
    b = collision_step_plain(s["plan"], qt, pt, DT, gen)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
    assert collisions_cuda.LAUNCHES == before
    # inputs are untouched (the step is out of place)
    np.testing.assert_array_equal(qt.numpy(), s["q"])
