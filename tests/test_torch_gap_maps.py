"""Gap maps in the port against ``qpsim_tpu``, float64 on the CPU.

* K3's plain version with per-pixel gap ids against the JAX package's XLA
  gather integrator (``make_collision_step``) at its own tolerances
  (``tests/test_collisions.py``: q 1e-12, n_ph 1e-9 — phonon occupations
  span ~1e-12..1e0 and summation order shows at ~1e-10 on the smallest);
* K4's plain version (analytic gap) against the JAX analytic Pallas kernel
  in interpret mode and against the port's own gather path at G = Npix
  (q 1e-11, n_ph 1e-9, as the JAX package holds its analytic kernel);
* the CUDA kernel's tables and walk (gap-id and analytic), through the
  NumPy transcription ``tests/pair_walk_transcription.py`` of
  ``csrc/collisions.cu`` (G = 3, and G = 8 mixed inside a warp);
* ``run_2d_crank_nicolson`` with ``gap_expression`` and ``precomputed``,
  end to end, against the JAX engine (frames 1e-10, mass 1e-12; across
  the gather and analytic forms the JAX package's own 1e-9).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import qpsim_tpu as J  # noqa: E402
from qpsim_tpu.geometry.mask import extract_edge_segments  # noqa: E402
from qpsim_tpu.io.precompute import precompute_arrays as j_precompute  # noqa: E402
from qpsim_tpu.models.params import BoundaryCondition, ExternalGenerationSpec, SimulationParameters  # noqa: E402
from qpsim_tpu.ops.collisions import build_collision_plan_arrays as j_plan  # noqa: E402
from qpsim_tpu.ops.collisions import make_collision_step  # noqa: E402
from qpsim_tpu.ops.dos import dynes_density_of_states, thermal_phonon_occupation  # noqa: E402
from qpsim_tpu.ops.energy_grid import build_energy_grid  # noqa: E402
from qpsim_tpu.ops.kernels import recombination_kernel_base, scattering_kernel_base  # noqa: E402
from qpsim_tpu.ops.pallas_collisions import build_pallas_collision_step_analytic  # noqa: E402
from qpsim_tpu.ops.phonon_map import build_phonon_frequency_map  # noqa: E402

import qpsim_tpu_torch as T  # noqa: E402
from qpsim_tpu_torch.interop import (  # noqa: E402
    analytic_tables_from_numpy,
    collision_tables_from_numpy,
    state_to_numpy,
    state_to_torch,
)
from qpsim_tpu_torch.models import params as tp  # noqa: E402
from qpsim_tpu_torch.ops import collisions_cuda  # noqa: E402
from qpsim_tpu_torch.ops.collisions import (  # noqa: E402
    analytic_rho,
    collision_step_analytic_plain,
    collision_step_plain,
)
from pair_walk_transcription import transcribe  # noqa: E402

NE, NY, NX = 10, 3, 6
DT = 0.01
TAU_S, TAU_R, T_C = 440.0, 500.0, 1.2


def _gap_map(kind, rng):
    if kind == "G3":
        gaps = np.array([120.0, 150.0, 170.0])
        plane = gaps[rng.integers(0, 3, (NY, NX))]
    else:  # every pixel its own gap
        plane = rng.uniform(120.0, 200.0, (NY, NX))
    return plane


def _gather_setup(plane, gamma, *, phonons=True, scattering=True, recombination=True, seed=0):
    """JAX's gather plan and the port's, over the unique gaps of ``plane``."""
    E, dE = build_energy_grid(180.0, 1.0, 4.0, NE)
    pm = build_phonon_frequency_map(E)
    gaps = np.unique(plane)
    gid = np.searchsorted(gaps, plane).astype(np.int32)
    rho = np.stack([dynes_density_of_states(E, g, gamma) for g in gaps])
    Ks = np.stack([scattering_kernel_base(E, g, TAU_S, T_C) for g in gaps]) if scattering else None
    Kr = np.stack([recombination_kernel_base(E, g, TAU_R, T_C) for g in gaps]) if recombination else None
    jp = j_plan(dE=dE, rho_by_gap=rho, K_r0_by_gap=Kr, K_s0_by_gap=Ks, gap_id=gid, pmap=pm,
                enable_recombination=recombination, enable_scattering=scattering,
                update_phonons=phonons, pixel_chunk=8)
    tplan = collision_tables_from_numpy(
        dE=dE, rho=rho, K_s0=Ks, K_r0=Kr, omega_bins=pm.omega_bins, idx_diff=pm.idx_diff,
        idx_sum=pm.idx_sum, diff_sign=pm.diff_sign, enable_scattering=scattering,
        enable_recombination=recombination, update_phonons=phonons, device="cpu",
        dtype=torch.float64, pixel_chunk=8, gap_id=gid,  # several chunks, one ragged
    )
    rng = np.random.default_rng(seed)
    q = rng.uniform(0, 1e-4, (NE, *plane.shape)) * rho[gid].transpose(2, 0, 1)
    ph = thermal_phonon_occupation(pm.omega_bins, 0.25)[:, None, None] * rng.uniform(
        0.5, 2.0, (pm.num_omega, *plane.shape))
    return dict(E=E, dE=dE, pm=pm, jplan=jp, plan=tplan, q=q, ph=ph, gid=gid)


def _analytic(s, plane, gamma, phonons=True):
    pm = s["pm"]
    return analytic_tables_from_numpy(
        E_bins=s["E"], dE=s["dE"], gap_plane=plane, omega_bins=pm.omega_bins, idx_diff=pm.idx_diff,
        idx_sum=pm.idx_sum, diff_sign=pm.diff_sign, tau_s=TAU_S, tau_r=TAU_R, T_c=T_C,
        dynes_gamma=gamma, update_phonons=phonons, device="cpu", dtype=torch.float64, pixel_chunk=8,
    )


def _run_port(step, *args, q, ph, gen=None):
    qt, pt = state_to_torch(q, ph, "cpu", torch.float64)
    g = None if gen is None else torch.as_tensor(gen)
    return state_to_numpy(*step(*args, qt, pt, DT, g))


def _close(got, want, rtol_q, rtol_ph):
    np.testing.assert_allclose(got[0], want[0], rtol=rtol_q, atol=1e-22)
    np.testing.assert_allclose(got[1], want[1], rtol=rtol_ph, atol=1e-22)


@pytest.mark.parametrize("kind", ["G3", "Gnpix"])
@pytest.mark.parametrize("phonons", [True, False], ids=["phonons", "frozen"])
@pytest.mark.parametrize("gen", [False, True], ids=["no_gen", "gen"])
def test_gap_id_plain_matches_xla_gather(kind, phonons, gen):
    plane = _gap_map(kind, np.random.default_rng(1))
    s = _gather_setup(plane, 0.0, phonons=phonons, seed=2)
    g = np.random.default_rng(5).uniform(0, 1e-6, (NY, NX)) if gen else None
    q_in = s["q"] + (0.0 if g is None else g[None])  # the JAX step takes the dt·g plane added
    want = [np.asarray(a) for a in make_collision_step(s["jplan"], DT)(jnp.asarray(q_in), jnp.asarray(s["ph"]))]
    got = _run_port(collision_step_plain, s["plan"], q=s["q"], ph=s["ph"], gen=g)
    _close(got, want, 1e-12, 1e-9)
    if not phonons:
        np.testing.assert_array_equal(got[1], s["ph"])


@pytest.mark.parametrize("gamma", [0.0, 0.12], ids=["bcs", "dynes"])
@pytest.mark.parametrize("gen", [False, True], ids=["no_gen", "gen"])
def test_analytic_plain_matches_pallas_interpret(gamma, gen):
    plane = _gap_map("Gnpix", np.random.default_rng(7))
    s = _gather_setup(plane, gamma, seed=3)
    g = np.random.default_rng(6).uniform(0, 1e-6, (NY, NX)) if gen else None
    pal = build_pallas_collision_step_analytic(
        E_bins=s["E"], dE=s["dE"], gap_plane=plane, pmap=s["pm"], dt=DT, tau_s=TAU_S, tau_r=TAU_R,
        T_c=T_C, dynes_gamma=gamma, update_phonons=True, tile=128, interpret=True, gen_input=gen,
    )
    args = (jnp.asarray(s["q"]), jnp.asarray(s["ph"])) + ((jnp.asarray(g),) if gen else ())
    want = [np.asarray(a) for a in pal(*args)]
    plan, tab = _analytic(s, plane, gamma)
    got = _run_port(collision_step_analytic_plain, plan, tab, q=s["q"], ph=s["ph"], gen=g)
    _close(got, want, 1e-11, 1e-9)


@pytest.mark.parametrize("gamma", [0.0, 0.12], ids=["bcs", "dynes"])
def test_analytic_plain_matches_gather_at_G_npix(gamma):
    plane = _gap_map("Gnpix", np.random.default_rng(8))
    s = _gather_setup(plane, gamma, seed=4)
    want = _run_port(collision_step_plain, s["plan"], q=s["q"], ph=s["ph"])
    plan, tab = _analytic(s, plane, gamma)
    got = _run_port(collision_step_analytic_plain, plan, tab, q=s["q"], ph=s["ph"])
    _close(got, want, 1e-11, 1e-9)
    # the closed-form ρ is the per-gap DOS
    rho, inv = analytic_rho(tab, tab.g2)
    ref = np.stack([dynes_density_of_states(s["E"], g, gamma) for g in plane.reshape(-1)])
    np.testing.assert_allclose(rho.numpy(), ref, rtol=1e-13, atol=0)
    np.testing.assert_allclose((rho * inv).numpy()[ref > 0], 1.0, rtol=1e-13)


def _gid_transcription(plan, q, ph, gen, dt):
    """K3 with gap ids: the kernel's walk (NumPy), each pixel on its gap's tables."""
    return transcribe(plan, collisions_cuda.build_kernel_tables(plan), q, ph, gen, dt)


def _analytic_transcription(plan, tab, q, ph, gen, dt):
    """K4: ρ, 1/ρ and the per-pixel constants from Δ², in the kernel's walk."""
    return transcribe(plan, collisions_cuda.build_kernel_tables(plan, tab), q, ph, gen, dt, analytic=tab)


def _mixed_warp_plane(gaps, rng):
    """A 2 × 32 plane of ``gaps``: a warp-sized run of mixed ids, then one of a single id."""
    ids = np.concatenate([rng.permutation(np.arange(32) % len(gaps)), np.full(32, 2)])
    return np.asarray(gaps)[ids].reshape(2, 32)


@pytest.mark.parametrize(
    "scattering,recombination,phonons,gen",
    [(True, True, True, True), (True, False, True, False), (False, True, False, True)],
    ids=["both_gen", "scattering", "recombination_frozen_gen"],
)
def test_gap_id_kernel_tables_reproduce_plain_version(scattering, recombination, phonons, gen):
    plane = _gap_map("G3", np.random.default_rng(11))
    s = _gather_setup(plane, 0.0, phonons=phonons, scattering=scattering,
                      recombination=recombination, seed=9)
    assert s["plan"].num_gaps == 3
    g = np.random.default_rng(2).uniform(0, 1e-6, (NY, NX)) if gen else None
    want = _run_port(collision_step_plain, s["plan"], q=s["q"], ph=s["ph"], gen=g)
    got = _gid_transcription(s["plan"], s["q"], s["ph"], g, DT)
    _close(got, want, 1e-12, 1e-12)


@pytest.mark.parametrize("gen", [False, True], ids=["no_gen", "gen"])
def test_gap_id_kernel_walk_with_eight_gaps_mixed_in_a_warp(gen):
    """G = 8 (the gap-id bound) with ids mixed inside a warp-sized run of
    pixels, against the plain version and the JAX package's XLA gather."""
    plane = _mixed_warp_plane(np.linspace(120.0, 190.0, 8), np.random.default_rng(14))
    s = _gather_setup(plane, 0.0, seed=15)
    assert s["plan"].num_gaps == 8 and len(np.unique(s["gid"].reshape(-1)[:32])) == 8
    g = np.random.default_rng(4).uniform(0, 1e-6, plane.shape) if gen else None
    want = _run_port(collision_step_plain, s["plan"], q=s["q"], ph=s["ph"], gen=g)
    got = _gid_transcription(s["plan"], s["q"], s["ph"], g, DT)
    _close(got, want, 1e-12, 1e-12)
    q_in = s["q"] + (0.0 if g is None else g[None])
    xla = [np.asarray(a) for a in make_collision_step(s["jplan"], DT)(jnp.asarray(q_in), jnp.asarray(s["ph"]))]
    _close(got, xla, 1e-12, 1e-9)


@pytest.mark.parametrize("gamma,phonons,gen", [(0.0, True, True), (0.12, True, False), (0.12, False, True)],
                         ids=["bcs_gen", "dynes", "dynes_frozen_gen"])
def test_analytic_kernel_walk_reproduces_plain_version(gamma, phonons, gen):
    plane = _gap_map("Gnpix", np.random.default_rng(12))
    s = _gather_setup(plane, gamma, seed=10)
    plan, tab = _analytic(s, plane, gamma, phonons=phonons)
    g = np.random.default_rng(3).uniform(0, 1e-6, (NY, NX)) if gen else None
    want = _run_port(collision_step_analytic_plain, plan, tab, q=s["q"], ph=s["ph"], gen=g)
    got = _analytic_transcription(plan, tab, s["q"], s["ph"], g, DT)
    _close(got, want, 1e-12, 1e-12)


def test_wrappers_run_plain_on_cpu_and_check_gap_counts():
    plane = _gap_map("G3", np.random.default_rng(13))
    s = _gather_setup(plane, 0.0, seed=12)
    tables = collisions_cuda.build_kernel_tables(s["plan"])
    assert s["plan"].gap_id.dtype == torch.uint8
    assert tables.rho.shape == (3, collisions_cuda.WALK_BINS)  # each gap's ρ over the walk's bins
    qt, pt = state_to_torch(s["q"], s["ph"], "cpu", torch.float64)
    before = dict(collisions_cuda.LAUNCHES)
    a = collisions_cuda.collision_step(s["plan"], tables, qt, pt, DT)
    b = collision_step_plain(s["plan"], qt, pt, DT)
    plan, tab = _analytic(s, plane, 0.0)
    c = collisions_cuda.collision_step_analytic(plan, tab, collisions_cuda.build_kernel_tables(plan, tab),
                                                qt, pt, DT)
    d = collision_step_analytic_plain(plan, tab, qt, pt, DT)
    for x, y in (*zip(a, b), *zip(c, d)):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
    assert collisions_cuda.LAUNCHES == before
    np.testing.assert_array_equal(qt.numpy(), s["q"])  # out of place
    # more unique gaps than the gap-id tables take
    many = _gather_setup(_gap_map("Gnpix", np.random.default_rng(1)), 0.0)
    with pytest.raises(ValueError, match="at most 8"):
        collisions_cuda.build_kernel_tables(many["plan"])


# ---------------------------------------------------------------- engine


def _film(ny=6, nx=9):
    """A masked film: a hole and a notch, one BC kind per edge in turn."""
    mask = np.ones((ny, nx), dtype=bool)
    mask[2:4, 3:5] = False
    mask[0, :2] = False
    return mask


def _engine_kwargs(mask, **extra):
    edges = extract_edge_segments(mask)
    kinds = ("reflective", "absorbing", "reflective", "robin")
    spec = lambda i: dict(kind=kinds[i % 4], value=0.3 if kinds[i % 4] == "robin" else None,
                          aux_value=0.1 if kinds[i % 4] == "robin" else None)
    bj = {e.edge_id: BoundaryCondition(**spec(i)) for i, e in enumerate(edges)}
    bt = {e.edge_id: tp.BoundaryCondition(**spec(i)) for i, e in enumerate(edges)}
    init = np.zeros(mask.shape)
    init[mask] = 1e-5 * (1.0 + 0.5 * np.sin(np.arange(mask.sum()) * 0.3))
    kw = dict(mask=mask, edges=edges, initial_field=init, diffusion_coefficient=6.0, dt=0.05,
              total_time=0.32, dx=1.0, store_every=3, energy_gap=180.0, energy_max_factor=4.0,
              num_energy_bins=6, enable_recombination=True, enable_scattering=True,
              bath_temperature=0.15)
    kw.update(extra)
    return kw, bj, bt


def _gen(pkg):
    cls = ExternalGenerationSpec if pkg == "jax" else tp.ExternalGenerationSpec
    return cls(mode="pulse", pulse_start=0.05, pulse_duration=0.15, pulse_rate=2e-5)


def _runs(kw, bj, bt, jax_extra=None, port_extra=None, gen=True):
    ha, hb = {}, {}
    a = J.run_2d_crank_nicolson(**kw, edge_conditions=bj, phonon_history_out=ha,
                                external_generation=_gen("jax") if gen else None, **(jax_extra or {}))
    b = T.run_2d_crank_nicolson(**kw, edge_conditions=bt, phonon_history_out=hb, device="cpu",
                                external_generation=_gen("torch") if gen else None, **(port_extra or {}))
    return (a, ha), (b, hb)


def _match(ra, rb, rtol_frames=1e-10, rtol_mass=1e-12):
    (a, ha), (b, hb) = ra, rb
    assert b[0] == a[0]
    np.testing.assert_allclose(b[2], a[2], rtol=rtol_mass, atol=0)
    for fa, fb in zip(a[1], b[1]):
        np.testing.assert_array_equal(np.isnan(fb), np.isnan(fa))
        np.testing.assert_allclose(np.nan_to_num(fb), np.nan_to_num(fa), rtol=rtol_frames, atol=1e-18)
    for row_a, row_b in zip(a[4], b[4]):
        for fa, fb in zip(row_a, row_b):
            np.testing.assert_allclose(np.nan_to_num(fb), np.nan_to_num(fa), rtol=rtol_frames, atol=1e-18)
    np.testing.assert_array_equal(b[5], a[5])
    assert hb["phonon_metadata"] == ha["phonon_metadata"]
    for fa, fb in zip(ha["phonon_frames"], hb["phonon_frames"]):
        np.testing.assert_allclose(np.nan_to_num(fb), np.nan_to_num(fa), rtol=rtol_frames, atol=1e-18)
    for row_a, row_b in zip(ha["phonon_energy_frames"], hb["phonon_energy_frames"]):
        for fa, fb in zip(row_a, row_b):
            np.testing.assert_allclose(np.nan_to_num(fb), np.nan_to_num(fa), rtol=rtol_frames, atol=1e-18)


TRAP = "return 180.0 - 20.0 * (x < 0.4) - 10.0 * (y > 0.6)"  # G = 3
GRADIENT = "return 130.0 + 60.0 * x + 5.0 * y"  # G = Npix


@pytest.mark.parametrize("strang_mode", ["exact", "merged"])
def test_piecewise_gap_map_on_a_masked_film(strang_mode):
    kw, bj, bt = _engine_kwargs(_film(), gap_expression=TRAP, strang_mode=strang_mode)
    _match(*_runs(kw, bj, bt))


def test_continuous_gap_map_both_forms():
    kw, bj, bt = _engine_kwargs(_film(), gap_expression=GRADIENT, dynes_gamma=0.1,
                                strang_mode="exact", total_time=0.2)
    # the gather path (per-gap stacks) against the JAX package's XLA path
    gather = _runs(kw, bj, bt, {"collision_backend": "auto"}, {"collision_backend": "plain"}, gen=False)
    _match(*gather)
    # the analytic path (K4's plain version) against the interpret-mode analytic kernel
    analytic = _runs(kw, bj, bt, {"collision_backend": "pallas"}, {"collision_backend": "auto"}, gen=False)
    _match(*analytic)
    # across the two forms, the JAX package's own tolerance
    _match(gather[1], analytic[1], rtol_frames=1e-9, rtol_mass=1e-9)


def test_user_supplied_precomputed_payload_is_used_as_given():
    mask = _film()
    kw, bj, bt = _engine_kwargs(mask, strang_mode="merged")
    params = SimulationParameters(diffusion_coefficient=6.0, dt=0.05, total_time=0.32, mesh_size=1.0,
                                  energy_gap=180.0, energy_max_factor=4.0, num_energy_bins=6,
                                  gap_expression=TRAP, bath_temperature=0.15)
    payload = j_precompute(mask, kw["edges"], bj, params)
    # a D_array the expression would not give: the engines must not recompute it
    payload["D_array"] = payload["D_array"] * np.linspace(0.8, 1.2, payload["D_array"].shape[1])
    _match(*_runs(kw, bj, bt, {"precomputed": payload}, {"precomputed": payload}))
    # without gap_values every pixel keeps the uniform gap
    del payload["gap_values"]
    _match(*_runs(kw, bj, bt, {"precomputed": payload}, {"precomputed": payload}))


def test_uniform_expression_keeps_energy_gap_in_the_collisions():
    # is_uniform: D(E) from the payload at Δ = 170, while the collisions
    # and the Pauli ρ stay at energy_gap = 180
    kw, bj, bt = _engine_kwargs(_film(), gap_expression="return 170.0", strang_mode="exact")
    ra, rb = _runs(kw, bj, bt)
    _match(ra, rb)
    plain_a, _ = _runs(dict(kw, gap_expression=""), bj, bt)
    assert not np.allclose(np.nan_to_num(ra[0][1][-1]), np.nan_to_num(plain_a[0][1][-1]), rtol=1e-8)


def test_gap_map_above_4096_cells_on_nb_planes():
    mask = np.ones((66, 66), dtype=bool)  # 4356 cells: ADI on both sides
    kw, bj, bt = _engine_kwargs(mask, gap_expression=GRADIENT, strang_mode="merged",
                                total_time=0.15, store_every=2, num_energy_bins=4)
    _match(*_runs(kw, bj, bt, {"diffusion_backend": "adi"}, {"diffusion_backend": "adi"}))


def test_plain_path_refuses_huge_gap_stacks_as_the_jax_package_does():
    mask = np.ones((300, 280), dtype=bool)  # 84 000 distinct gaps × 50² × 8 B × 3 tables > 4 GiB
    kw, bj, bt = _engine_kwargs(mask, gap_expression="return 130.0 + 60.0 * x + 5.0 * np.sqrt(y)",
                                enable_diffusion=False,
                                num_energy_bins=50, total_time=0.05)
    kw.pop("store_every")
    with pytest.raises(ValueError) as ea:
        J.run_2d_crank_nicolson(**kw, edge_conditions=bj, collision_backend="xla")
    with pytest.raises(ValueError) as eb:
        T.run_2d_crank_nicolson(**kw, edge_conditions=bt, collision_backend="plain", device="cpu")
    # the same count and size; the port names its own path and its remedy
    first = lambda e: str(e.value).split(" on the ")[0]
    assert first(eb) == first(ea) and "84000 unique gap values" in first(eb)
    assert "collision_backend='auto'" in str(eb.value)
