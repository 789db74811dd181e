"""Film ensembles, the diffusion sweep and ``make_collision_step`` against ``qpsim_tpu``, float64 on the CPU.

``build_film_ensemble`` in each collision form the JAX package routes —
uniform (its Pallas K3, interpret mode), per-member gaps (its analytic
K4, interpret mode), per-member τ with few and with more than eight
members (its XLA per-gap integrator) — stepped and chunked with a
generation plane, per-member pulse windows and the photon drive
(per-member n̄ and coupling, per-member gaps), each to 1e-12; on the card
the same forms run K3, K4, K3 with gap ids and K5's column walk with int32
member ids.  ``make_collision_step`` (one gap, gap ids, more than eight
per-gap tables, ids given per call) against the JAX package's; K5's column
tables for more than eight gaps through its NumPy transcription;
the batched diffusion sweep; members against solo runs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from qpsim_tpu.models.params import PhotonDriveSpec as JPhoton  # noqa: E402
from qpsim_tpu.ops import collisions as jc  # noqa: E402
from qpsim_tpu.parallel import ensemble as je  # noqa: E402

from column_walk_transcription import transcribe  # noqa: E402
from qpsim_tpu_torch.models.params import PhotonDriveSpec as TPhoton  # noqa: E402
from qpsim_tpu_torch.ops import collisions as tc  # noqa: E402
from qpsim_tpu_torch.ops.collisions_blocked_cuda import build_column_tables  # noqa: E402
from qpsim_tpu_torch.ops.column_walk import column_pixels  # noqa: E402
from qpsim_tpu_torch.parallel import ensemble as te  # noqa: E402

F64 = torch.float64
NY, NX, NE = 4, 6, 5
_FORMS = {
    "uniform": dict(n_members=3),
    "member_gaps": dict(n_members=3, gap=np.array([150.0, 180.0, 210.0])),
    "member_taus": dict(n_members=3, tau_s=np.array([200.0, 440.0, 800.0]), tau_r=np.array([300.0, 440.0, 600.0])),
    "member_taus_10": dict(n_members=10, tau_r=np.linspace(200.0, 700.0, 10)),
}


def _pair(**kw):
    common = dict(member_shape=(NY, NX), num_energy_bins=NE, energy_max_factor=3.0, dt=0.1)
    return (je.build_film_ensemble(**common, dtype=jnp.float64, **kw),
            te.build_film_ensemble(**common, dtype=F64, device="cpu", **kw))


def _states(ens, seed=0):
    b = ens.n_members
    q = np.random.default_rng(seed).uniform(0.0, 1e-4, (b, NE, NY, NX))
    return ens.pack(q, ens.thermal_phonons(np.linspace(0.1, 0.25, b)))


def _close(got, want, tol=1e-12):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    assert float(np.max(np.abs(got - want))) <= tol * max(float(np.max(np.abs(want))), 1e-300)


@pytest.mark.parametrize("form", list(_FORMS))
def test_film_ensemble_step_matches_jax(form):
    jens, tens = _pair(**_FORMS[form])
    assert tens.super_shape == jens.super_shape and tens.num_omega == jens.num_omega
    np.testing.assert_array_equal(tens.E_bins, jens.E_bins)
    q, ph = _states(jens, seed=len(form))
    jq, jp = jnp.asarray(q), jnp.asarray(ph)
    step = jax.jit(jens.step)
    tq, tp = tens.to_device(q, ph)
    for _ in range(2):
        jq, jp = step(jq, jp)
        tq, tp = tens.step(tq, tp)
    _close(tq, jq)
    _close(tp, jp)
    sep = tq.numpy()[:, NY :: NY + 1, :]
    assert sep.size and np.all(sep == 0.0)


def test_chunk_with_generation_plane_and_member_windows_matches_jax():
    jens, tens = _pair(**_FORMS["member_taus"])
    q, ph = _states(jens, seed=3)
    plane = jens.generation_plane(np.array([1e-6, 2e-6, 4e-6]))
    window = (np.array([0.0, 0.1, 0.2]), 0.15)
    jchunk = jens.make_chunk(4, gen_plane=plane, pulse_window=window)
    tchunk = tens.make_chunk(4, unroll=2, gen_plane=plane, pulse_window=window)
    for t0 in (0.0, 0.4):
        jq, jp = jchunk(jnp.asarray(q), jnp.asarray(ph), t0)
        tq, tp = tchunk(*tens.to_device(q, ph), t0)
        _close(tq, jq)
        _close(tp, jp)
    with pytest.raises(TypeError, match="start"):
        tchunk(*tens.to_device(q, ph))
    with pytest.raises(ValueError, match="pulse_window requires gen_plane"):
        tens.make_chunk(2, pulse_window=(0.0, 1.0))
    plain = tens.make_chunk(3)
    a = plain(*tens.to_device(q, ph))
    b = tens.to_device(q, ph)
    for _ in range(3):
        b = tens.step(*b)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("gaps", [None, np.array([160.0, 190.0])], ids=["uniform_gap", "member_gaps"])
def test_photon_chunk_with_member_occupancy_matches_jax(gaps):
    kw = dict(n_members=2) if gaps is None else dict(n_members=2, gap=gaps)
    jens, tens = _pair(**kw)
    q, ph = _states(jens, seed=5)
    omega = float(2.0 * jens.E_bins[0] + 2.0 * jens.dE)
    spec = dict(mode="photon", photon_energy=omega, occupancy=1.5, coupling=1e-4,
                window_start=0.05, window_duration=0.1)
    occ, coup = np.array([0.5, 2.0]), np.array([1e-4, 3e-4])
    jchunk = jens.make_chunk(2, photon=JPhoton(**spec), photon_occupancy=occ, photon_coupling=coup)
    tchunk = tens.make_chunk(2, photon=TPhoton(**spec), photon_occupancy=occ, photon_coupling=coup)
    jq, jp = jchunk(jnp.asarray(q), jnp.asarray(ph), 0.0)
    tq, tp = tchunk(*tens.to_device(q, ph), 0.0)
    _close(tq, jq)
    _close(tp, jp)
    with pytest.raises(ValueError, match="photon_occupancy"):
        tens.make_chunk(2, photon_occupancy=occ)


def test_members_match_solo_runs_and_separators_stay_empty():
    _, tens = _pair(**_FORMS["member_taus"])
    q, ph = _states(tens, seed=7)
    out = tens.make_chunk(3)(*tens.to_device(q, ph))
    qm, pm = tens.unpack(*out)
    assert not np.allclose(qm[0], qm[2])
    taus = _FORMS["member_taus"]
    for m in (0, 2):
        solo = te.build_film_ensemble(n_members=1, member_shape=(NY, NX), num_energy_bins=NE,
                                      energy_max_factor=3.0, dt=0.1, tau_s=taus["tau_s"][m],
                                      tau_r=taus["tau_r"][m], dtype=F64, device="cpu")
        qs, ps = tens.unpack(*tens.to_device(q, ph))
        one = solo.make_chunk(3)(*solo.to_device(*solo.pack(qs[m : m + 1], ps[m : m + 1])))
        qo, po = solo.unpack(*one)
        _close(qm[m], qo[0], 1e-13)
        _close(pm[m], po[0], 1e-13)
    assert np.all(out[0].numpy()[:, NY :: NY + 1, :] == 0.0)


def test_diffusion_sweep_matches_jax():
    d = np.array([1.0, 3.5, 8.0])
    want = je.sweep_diffusion_decay(width=10, height=7, D_values=d, steps=4, dt=0.05, dtype=jnp.float64)
    got = te.sweep_diffusion_decay(width=10, height=7, D_values=d, steps=4, dt=0.05, dtype=F64, device="cpu")
    _close(got, want)
    assert got.shape == (3, 5)


def _plans(n_gaps, seed=0):
    """The same per-gap plan in both packages: G gap tables on a 5 × 6 film."""
    from qpsim_tpu_torch.ops.dos import dynes_density_of_states
    from qpsim_tpu_torch.ops.energy_grid import build_energy_grid
    from qpsim_tpu_torch.ops.kernels import recombination_kernel_base, scattering_kernel_base
    from qpsim_tpu_torch.ops.phonon_map import build_phonon_frequency_map

    E, dE = build_energy_grid(180.0, 1.0, 3.0, NE)
    pm = build_phonon_frequency_map(E)
    gaps = np.linspace(170.0, 180.0, n_gaps)
    taus = np.linspace(300.0, 600.0, n_gaps)
    rho = np.stack([dynes_density_of_states(E, g, 0.0) for g in gaps])
    kr = np.stack([recombination_kernel_base(E, g, t, 1.2) for g, t in zip(gaps, taus)])
    ks = np.stack([scattering_kernel_base(E, g, t, 1.2) for g, t in zip(gaps, taus)])
    rng = np.random.default_rng(seed)
    gid = rng.integers(0, n_gaps, (5, 6)).astype(np.int32)
    jplan = jc.build_collision_plan_arrays(dE=dE, rho_by_gap=rho, K_r0_by_gap=kr, K_s0_by_gap=ks, gap_id=gid,
                                           pmap=pm, enable_recombination=True, enable_scattering=True,
                                           update_phonons=True)
    tplan = tc.build_collision_plan_arrays(dE=dE, rho=rho, K_r0=kr, K_s0=ks, gap_id=gid, pmap=pm,
                                           enable_recombination=True, enable_scattering=True,
                                           update_phonons=True, device="cpu", dtype=F64, pixel_chunk=7)
    q = rng.uniform(0.0, 1e-4, (NE, 5, 6))
    ph = rng.uniform(0.0, 1e-3, (pm.num_omega, 5, 6))
    return jplan, tplan, q, ph, gid


@pytest.mark.parametrize("n_gaps", [1, 3, 10])
def test_make_collision_step_matches_jax(n_gaps):
    jplan, tplan, q, ph, gid = _plans(n_gaps, seed=n_gaps)
    want = jc.make_collision_step(jplan, 0.05)(jnp.asarray(q), jnp.asarray(ph))
    got = tc.make_collision_step(tplan, 0.05)(torch.as_tensor(q), torch.as_tensor(ph))
    for a, b in zip(got, want):
        _close(a, b)
    other = np.roll(gid, 1, axis=1)  # ids given per call (the sharded form)
    want = jc.make_collision_step(jplan, 0.05, gap_id_arg=True)(jnp.asarray(q), jnp.asarray(ph), jnp.asarray(other))
    got = tc.make_collision_step(tplan, 0.05, gap_id_arg=True)(torch.as_tensor(q), torch.as_tensor(ph), other)
    for a, b in zip(got, want):
        _close(a, b)


def test_more_than_eight_gap_tables_walk_the_columns_with_int32_ids():
    _, tplan, q, ph, gid = _plans(10, seed=4)
    tables = build_column_tables(tplan)
    assert tables.gid.dtype == torch.int32 and tables.rho.shape[0] == 10
    want = tc.collision_step_plain(tplan, torch.as_tensor(q), torch.as_tensor(ph), 0.05)
    got = transcribe(tables, q, ph, None, 0.05, True, column_pixels(torch.float32, NE, q[0].size))
    for a, b in zip(got, want):
        _close(np.asarray(a).reshape(b.shape), b.numpy())


def test_thirty_two_member_tables_walk_the_columns_with_int32_ids():
    """32 per-member tables (a film ensemble's member τ), the tile's ids mixed."""
    _, tplan, q, ph, gid = _plans(32, seed=5)
    tables = build_column_tables(tplan)
    assert tables.rho.shape[0] == 32
    # member ids at up to 16 bins launch two pixels a lane, as a uniform gap does
    pixels = column_pixels(torch.float32, NE, q[0].size, uniform=False)
    assert pixels == 2 == column_pixels(torch.float32, NE, q[0].size)
    want = tc.collision_step_plain(tplan, torch.as_tensor(q), torch.as_tensor(ph), 0.05)
    got = transcribe(tables, q, ph, None, 0.05, True, pixels)
    for a, b in zip(got, want):
        _close(np.asarray(a).reshape(b.shape), b.numpy())


def test_builders_and_make_collision_step_run_plain_on_the_cpu_and_launch_nothing():
    from qpsim_tpu_torch.ops import collisions_cuda

    jens, tens = _pair(**_FORMS["member_gaps"])
    before = dict(collisions_cuda.LAUNCHES)
    q, ph = _states(jens, seed=9)
    tens.step(*tens.to_device(q, ph))
    assert collisions_cuda.LAUNCHES == before
    with pytest.raises(ValueError, match="analytic plan"):
        from qpsim_tpu_torch.ops.collisions import build_analytic_plan
        from qpsim_tpu_torch.ops.phonon_map import build_phonon_frequency_map

        plan, _ = build_analytic_plan(E_bins=tens.E_bins, dE=tens.dE, gap_plane=np.full((2, 2), 170.0),
                                      pmap=build_phonon_frequency_map(tens.E_bins), tau_s=440.0, tau_r=440.0,
                                      T_c=1.2, dynes_gamma=0.0, update_phonons=True, device="cpu", dtype=F64)
        tc.make_collision_step(plan, 0.05)


def test_ensembles_run_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        te.build_film_ensemble(n_members=2, member_shape=(3, 3), num_energy_bins=3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        te.sweep_diffusion_decay(width=4, height=4, steps=1)
