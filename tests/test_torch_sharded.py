"""The port's sharded step (``qpsim_tpu_torch.parallel``) against ``qpsim_tpu``'s, float64 on the CPU.

Each test is the counterpart of a sharded test of ``tests/test_parallel.py``
at its size and with its seeded inputs: the JAX call runs on its 8-device
CPU mesh (``tests/conftest.py``), the port's on
``make_mesh(devices=[torch.device("cpu")] * 8)``, where every kernel
wrapper runs its plain version and the mesh's local exchange moves rows
between the eight shards.  Tolerances are the JAX tests' own (1e-12 for
diffusion, 1e-13 for coupled steps, 1e-12 relative for engine runs).

``tridiag_backend="pallas"`` runs the port's K7 entry point
(``solve_lines``, its plain version here) for every local line solve —
the x half, the pencil y half and the Wang partition's local solves —,
which is the route CUDA shards take; ``CALL_TIME_PLANE_DEVICES``
monkeypatched to include the CPU runs the gap-map branch CUDA shards take
(K4/K6 with each shard's gap plane at call time).

``test_engine_mesh_program_cache_zero_retrace`` has no counterpart: the
port has no jit cache and builds nothing per call that could be reused.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from qpsim_tpu.geometry.mask import extract_edge_segments  # noqa: E402
from qpsim_tpu.models import params as jp  # noqa: E402
from qpsim_tpu.models.params import BoundaryCondition, ExternalGenerationSpec  # noqa: E402
from qpsim_tpu.ops.diffusion import build_directional_stencils, fold_diffusion  # noqa: E402
from qpsim_tpu.ops.dos import dynes_density_of_states, thermal_phonon_occupation  # noqa: E402
from qpsim_tpu.ops.energy_grid import build_energy_grid  # noqa: E402
from qpsim_tpu.ops.kernels import recombination_kernel_base, scattering_kernel_base  # noqa: E402
from qpsim_tpu.ops.phonon_map import build_phonon_frequency_map  # noqa: E402
from qpsim_tpu.parallel import mesh as jmesh  # noqa: E402
from qpsim_tpu.parallel.sharded import build_sharded_step as j_build  # noqa: E402
from qpsim_tpu.solver.diffusion_backends import ADIDiffusion as JADIDiffusion  # noqa: E402
from qpsim_tpu.solver.engine import run_2d_crank_nicolson as j_run  # noqa: E402

import qpsim_tpu_torch as T  # noqa: E402
from qpsim_tpu_torch.geometry.mask import extract_edge_segments as t_edges  # noqa: E402
from qpsim_tpu_torch.interop import split_operator_from_numpy  # noqa: E402
from qpsim_tpu_torch.models import params as tp  # noqa: E402
from qpsim_tpu_torch.ops.phonon_map import build_phonon_frequency_map as t_pmap  # noqa: E402
from qpsim_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from qpsim_tpu_torch.parallel import sharded as tsharded  # noqa: E402
from qpsim_tpu_torch.solver.diffusion_backends import ADIDiffusion as TADIDiffusion  # noqa: E402

GAP, TAU, TC, TBATH = 180.0, 440.0, 1.2, 0.2
N_DEV = len(jax.devices())
CPU8 = [torch.device("cpu")] * N_DEV

pytestmark = pytest.mark.skipif(N_DEV < 2, reason="needs multiple (virtual) devices")


def _geometry(ny, nx, hole=False, kinds=("dirichlet", "reflective")):
    mask = np.ones((ny, nx), dtype=bool)
    if hole:
        mask[6:10, 3:7] = False  # decoupled y intervals at shard edges
    edges = extract_edge_segments(mask)
    bcs = {e.edge_id: BoundaryCondition(kind=kinds[0] if e.normal in ("left", "right") else kinds[1],
                                        value=0.0) for e in edges}
    return mask, edges, bcs


def _ops(ny, nx, D, hole=False, kinds=("dirichlet", "reflective")):
    """The JAX operator and the port's copy of it."""
    mask, edges, bcs = _geometry(ny, nx, hole, kinds)
    xs, ys = build_directional_stencils(mask, edges, bcs, 1.0)
    op = fold_diffusion(xs, ys, mask, 1.0, D)
    return op, split_operator_from_numpy(**vars(op))


def _grid(ne, emax=3.0):
    E, dE = build_energy_grid(GAP, 1.0, emax, ne)
    return E, dE, build_phonon_frequency_map(E), t_pmap(E)


def _uniform_collisions(ne):
    E, dE, pm, tpm = _grid(ne)
    common = dict(
        dE=dE, rho=dynes_density_of_states(E, GAP, 0.0), K_r0=recombination_kernel_base(E, GAP, TAU, TC),
        K_s0=scattering_kernel_base(E, GAP, TAU, TC), enable_recombination=True,
        enable_scattering=True, update_phonons=True,
    )
    return E, pm, dict(common, pmap=pm), dict(common, pmap=tpm)


def _states(seed, ne, nw, ny, nx, scale=1e-4):
    rng = np.random.default_rng(seed)
    q0 = rng.uniform(0, scale, (ne, ny, nx))
    return q0, rng


def _thermal(pm, ny, nx, lead=()):
    occ = thermal_phonon_occupation(pm.omega_bins, TBATH)
    return np.broadcast_to(occ.reshape((1,) * len(lead) + (-1, 1, 1)), (*lead, pm.num_omega, ny, nx)).copy()


def _j_run_steps(sh, q0, ph0, n, *grow):
    q = jax.device_put(jnp.asarray(q0), sh.q_sharding)
    ph = jax.device_put(jnp.asarray(ph0), sh.ph_sharding)
    mass = None
    for _ in range(n):
        q, ph, mass = sh.step(q, ph, *grow)
    return np.asarray(q), np.asarray(ph), mass


def _t_run_steps(sh, q0, ph0, n, *grow):
    q, ph = sh.shard(q0), sh.shard(ph0)
    mass = None
    for _ in range(n):
        q, ph, mass = sh.step(q, ph, *grow)
    return sh.gather(q).numpy(), sh.gather(ph).numpy(), mass


def _t_mesh(**kw):
    return tmesh.make_mesh(devices=CPU8, **kw)


# ---------------------------------------------------------------- the Wang pieces


def test_wang_apply_pieces_match_jax_and_the_cut_block_solve():
    """``wang_apply_rhs``/``wang_apply_interface`` against the JAX functions
    (1e-12), and D — the solve of each partition's block with its
    couplings cut — against K7's plain solve of the block with NaN in the
    entries it must not read (the route CUDA shards take)."""
    from qpsim_tpu.ops import tridiag as jt

    from qpsim_tpu_torch.ops import tridiag as tt
    from qpsim_tpu_torch.ops.adi_cuda import solve_lines_plain

    rng = np.random.default_rng(21)
    nb, n, lanes, k = 3, 40, 6, 4
    lo = rng.uniform(0.1, 1.0, (nb, lanes, n))
    hi = rng.uniform(0.1, 1.0, (nb, lanes, n))
    di = -(lo + hi) - rng.uniform(0.0, 0.5, (nb, lanes, n))
    alpha = 0.3
    sub, diag, sup = -alpha * lo, 1.0 - alpha * di, -alpha * hi
    rhs = rng.normal(size=(nb, lanes, n))
    jf = jt.wang_factor(jnp.asarray(sub), jnp.asarray(diag), jnp.asarray(sup), chunk=n // k)
    tf = tt.wang_factor(*(torch.as_tensor(a) for a in (sub, diag, sup)), chunk=n // k)
    d_layout = tt._wang_layout(torch.as_tensor(rhs), k, n // k)
    D_t = tt.wang_apply_rhs(d_layout, tf["m"], tf["inv"], tf["cp"])
    D_j = jt.wang_apply_rhs(jnp.asarray(d_layout.numpy()), jf["m"], jf["inv"], jf["cp"])
    np.testing.assert_allclose(D_t.numpy(), np.asarray(D_j), rtol=0, atol=1e-12)
    args = ("if_aL", "if_aR", "if_inv", "if_q", "if_w_pre", "if_w_post")
    Ls_t, Rs_t = tt.wang_apply_interface(D_t[0], D_t[-1], *(tf[a] for a in args), k)
    Ls_j, Rs_j = jt.wang_apply_interface(D_j[0], D_j[-1], *(jf[a] for a in args), k)
    for a, b in zip(Ls_t + Rs_t, Ls_j + Rs_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-12)
    np.testing.assert_allclose(tt.wang_apply(tf, torch.as_tensor(rhs)).numpy(),
                               np.asarray(jt.wang_apply(jf, jnp.asarray(rhs))), rtol=0, atol=1e-12)
    # D of each partition = K7 on the partition's block, couplings cut (NaN there)
    blocks = lambda a: torch.as_tensor(a).reshape(nb, lanes, k, n // k).permute(0, 2, 3, 1)
    lo_b, di_b, hi_b = blocks(lo).clone(), blocks(di), blocks(hi).clone()
    lo_b[:, :, 0] = float("nan")
    hi_b[:, :, -1] = float("nan")
    for j in range(k):
        got = solve_lines_plain(blocks(rhs)[:, j].contiguous(), lo_b[:, j].contiguous(), di_b[:, j].contiguous(),
                                hi_b[:, j].contiguous(), torch.ones(nb, dtype=torch.float64), alpha=alpha)
        want = D_t[:, j].permute(1, 0, 2)  # (m, nb, lanes) -> (nb, m, lanes)
        assert torch.isfinite(got).all()
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-12)


# ---------------------------------------------------------------- diffusion


@pytest.mark.parametrize("y_solve", ["pencil", "wang"])
@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_sharded_diffusion_matches_jax(y_solve, backend):
    """``test_sharded_diffusion_matches_single_chip`` (and, with 'pallas',
    ``test_sharded_pallas_tridiag_matches_xla_backend``): 5 steps on 32 × 24."""
    ny, nx = 32, 24
    op, top = _ops(ny, nx, np.array([2.0, 5.0]))
    jsh = j_build(jmesh.make_mesh(n_space=N_DEV), op, 0.05, dtype=jnp.float64, y_solve=y_solve)
    tsh = tsharded.build_sharded_step(_t_mesh(), top, 0.05, dtype=torch.float64, y_solve=y_solve,
                                      tridiag_backend=backend)
    q0 = np.random.default_rng(0).uniform(0, 1, (2, ny, nx))
    ph0 = np.zeros((1, ny, nx))
    qj, _, mj = _j_run_steps(jsh, q0, ph0, 5)
    qt, _, mt = _t_run_steps(tsh, q0, ph0, 5)
    np.testing.assert_allclose(qt, qj, rtol=0, atol=1e-12)
    single = jax.jit(JADIDiffusion(op, dtype=jnp.float64).make_step(0.05))
    q_single = jnp.asarray(q0)
    for _ in range(5):
        q_single = single(q_single)
    np.testing.assert_allclose(qt, np.asarray(q_single), rtol=0, atol=1e-12)
    assert abs(float(mt) - float(jnp.sum(q_single))) < 1e-10


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("y_solve", ["pencil", "wang"])
def test_sharded_lazy_bin_scale_matches_jax(monkeypatch, y_solve, backend):
    """``test_sharded_lazy_bin_scale_matches_single_chip``: the scale kept
    lazy (unit-D planes × bin_scale), 4 steps; 'wang' takes the unfactored
    branch (with 'pallas': D, A and C in one K7 solve)."""
    monkeypatch.setattr(JADIDiffusion, "MATERIALIZE_MAX_ELEMENTS", 0)
    monkeypatch.setattr(TADIDiffusion, "MATERIALIZE_MAX_ELEMENTS", 0)
    ny, nx = 16, 16
    op, top = _ops(ny, nx, np.array([2.0, 5.0, 7.0]))
    assert top.bin_scale is not None
    jsh = j_build(jmesh.make_mesh(n_space=N_DEV), op, 0.05, dtype=jnp.float64, y_solve=y_solve)
    tsh = tsharded.build_sharded_step(_t_mesh(), top, 0.05, dtype=torch.float64, y_solve=y_solve,
                                      tridiag_backend=backend)
    assert "wfp_cp" not in tsh.aux[0]
    q0 = np.random.default_rng(7).uniform(0, 1, (3, ny, nx))
    qj, _, _ = _j_run_steps(jsh, q0, np.zeros((1, ny, nx)), 4)
    qt, _, _ = _t_run_steps(tsh, q0, np.zeros((1, ny, nx)), 4)
    np.testing.assert_allclose(qt, qj, rtol=0, atol=1e-12)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_sharded_wang_lazy_and_prefactored_branches(monkeypatch, backend):
    """``test_sharded_wang_lazy_and_prefactored_branches``: both Wang
    branches agree with pencil and with each other (1e-12)."""
    ny, nx = 16, 16
    op, top = _ops(ny, nx, np.array([2.0, 5.0, 7.0]))
    q0 = np.random.default_rng(9).uniform(0, 1, (3, ny, nx))

    def run(y_solve):
        sh = tsharded.build_sharded_step(_t_mesh(), top, 0.05, dtype=torch.float64, y_solve=y_solve,
                                         tridiag_backend=backend)
        return _t_run_steps(sh, q0, np.zeros((1, ny, nx)), 4)[0], sh

    ref, _ = run("pencil")
    got, sh_w = run("wang")
    assert "wfp_cp" in sh_w.aux[0]
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)
    monkeypatch.setattr(TADIDiffusion, "MATERIALIZE_MAX_ELEMENTS", 0)
    ref_lazy, _ = run("pencil")
    got_lazy, sh_lazy = run("wang")
    assert "wfp_cp" not in sh_lazy.aux[0]
    np.testing.assert_allclose(got_lazy, ref_lazy, rtol=0, atol=1e-12)
    np.testing.assert_allclose(got_lazy, got, rtol=0, atol=1e-12)


# ---------------------------------------------------------------- coupled steps


@pytest.mark.parametrize("y_solve", ["pencil", "wang"])
def test_sharded_full_coupled_matches_jax(y_solve):
    """``test_sharded_full_coupled_matches_single_chip``: 16² × 6 bins, 3 steps."""
    ny = nx = 16
    E, pm, jcol, tcol = _uniform_collisions(6)
    D_bins = 6.0 * np.sqrt(np.maximum(0.0, 1.0 - (GAP / E) ** 2))
    op, top = _ops(ny, nx, D_bins)
    jsh = j_build(jmesh.make_mesh(n_space=N_DEV), op, 0.05, collisions=jcol, dtype=jnp.float64,
                  y_solve=y_solve)
    tsh = tsharded.build_sharded_step(_t_mesh(), top, 0.05, collisions=tcol, dtype=torch.float64,
                                      y_solve=y_solve)
    q0, _ = _states(1, 6, pm.num_omega, ny, nx)
    ph0 = _thermal(pm, ny, nx)
    qj, pj, mj = _j_run_steps(jsh, q0, ph0, 3)
    qt, pt, mt = _t_run_steps(tsh, q0, ph0, 3)
    np.testing.assert_allclose(qt, qj, rtol=0, atol=1e-13)
    np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-13)
    assert abs(float(mt) - float(mj)) < 1e-10


@pytest.mark.parametrize("form", ["gap_id", "gap_plane"])
def test_sharded_nonuniform_gap_matches_jax(monkeypatch, form):
    """``test_sharded_nonuniform_gap_matches_single_chip``: a piecewise gap,
    per-bin D planes; 'gap_id' is the CPU branch (each shard's gap ids),
    'gap_plane' the CUDA branch (each shard's Δ plane at call time)."""
    if form == "gap_plane":
        monkeypatch.setattr(tsharded, "CALL_TIME_PLANE_DEVICES", ("cuda", "cpu"))
    ny = nx = 16
    ne = 5
    E, dE, pm, tpm = _grid(ne)
    gap_plane = np.full((ny, nx), GAP)
    gap_plane[: ny // 2] = 150.0
    D_dense = np.stack([np.where(gap_plane < E[i], 6.0 * np.sqrt(np.maximum(0.0, 1.0 - (gap_plane / E[i]) ** 2)),
                                 0.0) for i in range(ne)])
    op, top = _ops(ny, nx, D_dense)
    common = dict(dE=dE, rho=dynes_density_of_states(E, GAP, 0.0), E_bins=E, gap_plane=gap_plane, tau_s=TAU,
                  tau_r=TAU, T_c=TC, enable_recombination=True, enable_scattering=True, update_phonons=True)
    jsh = j_build(jmesh.make_mesh(n_space=N_DEV), op, 0.05, collisions=dict(common, pmap=pm), dtype=jnp.float64)
    tsh = tsharded.build_sharded_step(_t_mesh(), top, 0.05, collisions=dict(common, pmap=tpm),
                                      dtype=torch.float64)
    assert (tsh.aux[0]["gap_aux"][0].dtype == torch.float64) == (form == "gap_plane")
    q0, _ = _states(4, ne, pm.num_omega, ny, nx)
    ph0 = _thermal(pm, ny, nx)
    qj, pj, _ = _j_run_steps(jsh, q0, ph0, 3)
    qt, pt, _ = _t_run_steps(tsh, q0, ph0, 3)
    np.testing.assert_allclose(qt, qj, rtol=0, atol=1e-13)
    np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-13)
    final = qt.sum(axis=0)
    assert not np.allclose(final[: ny // 2].sum(), final[ny // 2:].sum())


def test_analytic_step_gap_plane_arg_matches_baked():
    """``test_analytic_step_gap_plane_arg_matches_baked``: the call-time
    form of K4's builder (its plain version here) is the baked form, bit
    for bit, and matches the JAX call-time kernel in interpret mode (q
    1e-11, n_ph 1e-9, as ``test_torch_gap_maps.py`` holds K4); the
    no-channel step keeps the call-time arity."""
    from qpsim_tpu.ops.pallas_collisions import build_pallas_collision_step_analytic

    from qpsim_tpu_torch.ops.collisions_cuda import build_collision_step_analytic

    E, dE, pm, tpm = _grid(6)
    ny, nx = 2, 8
    rng = np.random.default_rng(9)
    gp = rng.uniform(130.0, 200.0, (ny, nx))
    kw = dict(E_bins=E, dE=dE, dt=0.02, tau_s=TAU, tau_r=TAU, T_c=TC, update_phonons=True)
    jarg = build_pallas_collision_step_analytic(gap_plane=None, pmap=pm, tile=128, interpret=True, **kw)
    baked = build_collision_step_analytic(gap_plane=gp, pmap=tpm, device="cpu", **kw)
    argmode = build_collision_step_analytic(gap_plane=None, pmap=tpm, device="cpu", **kw)
    rho = dynes_density_of_states(E, GAP, 0.0)
    q0 = rng.uniform(0, 1e-4, (6, ny, nx)) * rho[:, None, None]
    ph0 = np.broadcast_to(thermal_phonon_occupation(pm.omega_bins, 0.2)[:, None, None],
                          (pm.num_omega, ny, nx)).copy()
    tq, tph = torch.as_tensor(q0), torch.as_tensor(ph0)
    q1, p1 = baked(tq, tph)
    q2, p2 = argmode(tq, tph, torch.as_tensor(gp))
    assert torch.equal(q1, q2) and torch.equal(p1, p2)
    gen = torch.as_tensor(rng.uniform(0, 1e-6, (ny, nx)))
    assert torch.equal(argmode(tq, tph, torch.as_tensor(gp), gen)[0], baked(tq, tph, gen)[0])
    qj, pj = jarg(jnp.asarray(q0), jnp.asarray(ph0), jnp.asarray(gp))
    # the tolerances of test_torch_gap_maps.py: the TPU kernel's expm1 is a Taylor hybrid
    np.testing.assert_allclose(q2.numpy(), np.asarray(qj), rtol=1e-11, atol=1e-22)
    np.testing.assert_allclose(p2.numpy(), np.asarray(pj), rtol=1e-9, atol=1e-22)
    noop = build_collision_step_analytic(gap_plane=None, pmap=tpm, device="cpu",
                                         **{**kw, "tau_s": None, "tau_r": None})
    q3, p3 = noop(tq, tph, torch.as_tensor(gp))
    assert q3 is tq and p3 is tph


@pytest.mark.parametrize("y_solve", ["pencil", "wang"])
def test_sharded_gen_chunk_matches_plain_plus_add(y_solve):
    """``test_sharded_gen_chunk_matches_plain_plus_add``: the fused grow
    plane equals the pre-added state (1e-15), and the JAX gen step."""
    ny = nx = 16
    E, pm, jcol, tcol = _uniform_collisions(4)
    D_bins = 6.0 * np.sqrt(np.maximum(0.0, 1.0 - (GAP / E) ** 2))
    op, top = _ops(ny, nx, D_bins)
    mesh = _t_mesh()
    plain = tsharded.build_sharded_step(mesh, top, 0.05, collisions=tcol, dtype=torch.float64, y_solve=y_solve)
    gen = tsharded.build_sharded_step(mesh, top, 0.05, collisions=tcol, dtype=torch.float64, gen_input=True,
                                      y_solve=y_solve)
    assert gen.takes_gen and not plain.takes_gen
    q0, rng = _states(5, 4, pm.num_omega, ny, nx)
    ph0 = _thermal(pm, ny, nx)
    grow = rng.uniform(0, 1e-6, (ny, nx))
    q_g, ph_g, _ = _t_run_steps(gen, q0, ph0, 1, gen.shard(grow))
    q_p, ph_p, _ = _t_run_steps(plain, q0 + grow[None], ph0, 1)
    np.testing.assert_allclose(q_g, q_p, rtol=0, atol=1e-15)
    np.testing.assert_allclose(ph_g, ph_p, rtol=0, atol=1e-15)
    jgen = j_build(jmesh.make_mesh(n_space=N_DEV), op, 0.05, collisions=jcol, dtype=jnp.float64,
                   gen_input=True, y_solve=y_solve)
    qj, pj, _ = _j_run_steps(jgen, q0, ph0, 1, jnp.asarray(grow))
    np.testing.assert_allclose(q_g, qj, rtol=0, atol=1e-13)
    q_c, ph_c, m_c = gen.make_chunk(3, unroll=1)(gen.shard(q0), gen.shard(ph0), gen.shard(grow))
    assert np.all(np.isfinite(gen.gather(q_c).numpy())) and float(m_c) > 0


def test_chunk_matches_stepwise():
    """``test_chunk_helpers_match_stepwise`` (the sharded half): make_chunk
    equals calling step n times, and the JAX chunk."""
    ny = nx = 16
    op, top = _ops(ny, nx, 6.0)
    tsh = tsharded.build_sharded_step(_t_mesh(), top, 0.05, dtype=torch.float64)
    q0, ph0 = np.ones((1, ny, nx)), np.zeros((1, ny, nx))
    q_it, _, m_it = _t_run_steps(tsh, q0, ph0, 5)
    q_ch, _, m_ch = tsh.make_chunk(5, unroll=2)(tsh.shard(q0), tsh.shard(ph0))
    np.testing.assert_allclose(tsh.gather(q_ch).numpy(), q_it, rtol=0, atol=1e-14)
    assert abs(float(m_ch) - float(m_it)) < 1e-10
    jsh = j_build(jmesh.make_mesh(n_space=N_DEV), op, 0.05, dtype=jnp.float64)
    qj, _, mj = jsh.make_chunk(5, unroll=2)(jax.device_put(jnp.asarray(q0), jsh.q_sharding),
                                            jax.device_put(jnp.asarray(ph0), jsh.ph_sharding))
    np.testing.assert_allclose(q_it, np.asarray(qj), rtol=0, atol=1e-12)


def test_sharded_ensemble_chunk_matches_jax_L6():
    """``test_sharded_ensemble_chunk_matches_single_chip_L6``: a 2 × 4
    (ensemble × space) mesh, two members per ensemble group, 6 steps."""
    n_ens, n_space = 2, N_DEV // 2
    ny, nx, ne, n_members = 8 * n_space, 16, 4, 4
    E, pm, jcol, tcol = _uniform_collisions(ne)
    D_bins = 6.0 * np.sqrt(np.maximum(0.0, 1.0 - (GAP / E) ** 2))
    op, top = _ops(ny, nx, D_bins)
    jsh = j_build(jmesh.make_mesh(n_space=n_space, n_ensemble=n_ens), op, 0.05, collisions=jcol,
                  dtype=jnp.float64, ensemble=True)
    tsh = tsharded.build_sharded_step(_t_mesh(n_space=n_space, n_ensemble=n_ens), top, 0.05, collisions=tcol,
                                      dtype=torch.float64, ensemble=True)
    rng = np.random.default_rng(11)
    q0 = rng.uniform(0, 1e-4, (n_members, ne, ny, nx))
    ph0 = _thermal(pm, ny, nx, lead=(n_members,))
    qj, pj, mj = jsh.make_chunk(6, unroll=2)(jax.device_put(jnp.asarray(q0), jsh.q_sharding),
                                             jax.device_put(jnp.asarray(ph0), jsh.ph_sharding))
    qt, pt, mt = tsh.make_chunk(6)(tsh.shard(q0), tsh.shard(ph0))
    np.testing.assert_allclose(tsh.gather(qt).numpy(), np.asarray(qj), rtol=0, atol=1e-13)
    np.testing.assert_allclose(tsh.gather(pt).numpy(), np.asarray(pj), rtol=0, atol=1e-13)
    assert mt.shape == (n_members,)
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), rtol=1e-12)
    assert not np.allclose(tsh.gather(qt).numpy()[0], tsh.gather(qt).numpy()[1])


def test_sharded_wang_matches_pencil_and_jax():
    """``test_sharded_wang_y_solve_matches_pencil``: a hole decouples y
    intervals at shard edges; Wang against pencil at f64 roundoff, and the
    JAX Wang step; an unknown y_solve is refused with the JAX message."""
    ny = nx = 16
    E, pm, jcol, tcol = _uniform_collisions(4)
    op, top = _ops(ny, nx, 6.0, hole=True, kinds=("reflective", "reflective"))
    mask = np.asarray(op.mask)
    rng = np.random.default_rng(3)
    q0 = np.where(mask, 1.0, 0.0)[None] * rng.uniform(0, 1e-4, (4, ny, nx))
    ph0 = np.where(mask, 1.0, 0.0)[None] * rng.uniform(0, 1e-3, (pm.num_omega, ny, nx))
    outs = {}
    for ys in ("pencil", "wang"):
        sh = tsharded.build_sharded_step(_t_mesh(), top, 0.05, collisions=tcol, dtype=torch.float64, y_solve=ys)
        q, ph, _ = sh.make_chunk(6, unroll=2)(sh.shard(q0), sh.shard(ph0))
        outs[ys] = (sh.gather(q).numpy(), sh.gather(ph).numpy())
    for a, b in zip(outs["pencil"], outs["wang"]):
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-13 * max(np.abs(a).max(), 1e-30))
    jsh = j_build(jmesh.make_mesh(n_space=N_DEV), op, 0.05, collisions=jcol, dtype=jnp.float64, y_solve="wang")
    jq, jph, _ = jsh.make_chunk(6, unroll=2)(jnp.asarray(q0), jnp.asarray(ph0))
    for a, b in zip((jq, jph), outs["wang"]):
        np.testing.assert_allclose(b, np.asarray(a), rtol=0, atol=1e-13 * max(float(jnp.max(jnp.abs(a))), 1e-30))


@pytest.mark.parametrize("form", ["gap_id", "gap_plane"])
def test_sharded_wang_gap_plane_and_pieces(monkeypatch, form):
    """``test_sharded_wang_gap_plane_and_pieces``: the merged composition
    from the pieces, pencil and Wang, against the JAX pieces."""
    if form == "gap_plane":
        monkeypatch.setattr(tsharded, "CALL_TIME_PLANE_DEVICES", ("cuda", "cpu"))
    ny = nx = 16
    E, dE, pm, tpm = _grid(4)
    op, top = _ops(ny, nx, 6.0, kinds=("reflective", "reflective"))
    gap_plane = np.full((ny, nx), GAP)
    gap_plane[:, nx // 2:] = GAP - 25.0
    common = dict(E_bins=E, dE=dE, rho=dynes_density_of_states(E, GAP, 0.0), K_r0=None, K_s0=None,
                  gap_plane=gap_plane, tau_s=TAU, tau_r=TAU, T_c=TC, enable_recombination=True,
                  enable_scattering=True, update_phonons=True)
    rng = np.random.default_rng(4)
    q0 = rng.uniform(0, 1e-4, (4, ny, nx))
    ph0 = rng.uniform(0, 1e-3, (pm.num_omega, ny, nx))

    def merged(sh, q, ph):
        raw, src = sh.aux
        q, ph = sh.apply_col_half(q, ph, raw)
        q = sh.apply_diffuse(q, raw, src)
        q, ph = sh.apply_col_full(q, ph, raw)
        q = sh.apply_diffuse(q, raw, src)
        return sh.apply_col_half(q, ph, raw)

    for ys in ("pencil", "wang"):
        tsh = tsharded.build_sharded_step(_t_mesh(), top, 0.05, collisions=dict(common, pmap=tpm),
                                          dtype=torch.float64, y_solve=ys, pieces=True)
        q, ph = merged(tsh, tsh.shard(q0), tsh.shard(ph0))
        jsh = j_build(jmesh.make_mesh(n_space=N_DEV), op, 0.05, collisions=dict(common, pmap=pm),
                      dtype=jnp.float64, y_solve=ys, pieces=True)
        jq, jph = jax.jit(lambda a, b: merged(jsh, a, b))(jnp.asarray(q0), jnp.asarray(ph0))
        for got, want in ((tsh.gather(q), jq), (tsh.gather(ph), jph)):
            scale = float(jnp.max(jnp.abs(want)))
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-13 * max(scale, 1e-30))


# ---------------------------------------------------------------- meshes


def test_multihost_mesh_single_process_layout():
    """``test_multihost_mesh_single_process_layout``: without a process
    group the multihost mesh spans this process's devices, one ensemble
    group; a step over a 2-way space axis runs."""
    tmesh.initialize_distributed()  # no group to join: a no-op
    mesh = tmesh.make_multihost_mesh(device="cpu")
    jm = jmesh.make_multihost_mesh()
    assert mesh.shape == dict(jm.shape) and mesh.shape["ensemble"] == 1
    mesh2 = tmesh.make_multihost_mesh(n_space=2, device="cpu")
    assert mesh2.shape == dict(jmesh.make_multihost_mesh(n_space=2).shape)
    _, top = _ops(8, 8, 6.0)
    sh = tsharded.build_sharded_step(mesh2, top, 0.05, dtype=torch.float64)
    _, _, mass = _t_run_steps(sh, np.ones((1, 8, 8)), np.zeros((1, 8, 8)), 1)
    assert np.isfinite(float(mass))
    assert len(tmesh.local_devices("cpu")) == N_DEV
    with pytest.raises(ValueError, match="does not match"):
        tmesh.make_mesh(n_space=3, devices=CPU8)


def test_errors_match_jax():
    """The builder's refusals, with the JAX package's messages; a step
    given other shards than its mesh's cells hold is refused."""
    ny = nx = 16
    op, top = _ops(ny, nx, 6.0)
    E, dE, pm, tpm = _grid(4)
    jm, tm = jmesh.make_mesh(n_space=N_DEV), _t_mesh()
    gp = np.full((ny, nx), GAP)
    bad = [
        (dict(), dict(y_solve="diagonal")),
        (dict(), dict(tridiag_backend="mosaic")),
        (dict(), dict(gen_input=True, ensemble=True)),
        (dict(collisions=dict(dE=dE, pmap=None, gap_plane=gp, enable_scattering=True)), dict()),
        (dict(collisions=dict(dE=dE, pmap=None, gap_plane=gp[:8])), dict()),
    ]
    for jcol, kw in bad:
        with pytest.raises(ValueError) as je:
            j_build(jm, op, 0.05, dtype=jnp.float64, **jcol, **kw)
        with pytest.raises(ValueError) as te:
            tsharded.build_sharded_step(tm, top, 0.05, dtype=torch.float64, **jcol, **kw)
        assert str(te.value) == str(je.value)
    sh = tsharded.build_sharded_step(tm, top, 0.05, dtype=torch.float64)
    q, ph = sh.shard(np.ones((1, ny, nx))), sh.shard(np.zeros((1, ny, nx)))
    with pytest.raises(ValueError, match="shards on"):  # no shard may be missing or moved
        sh.step(q[:-1], ph[:-1])
    op2, top2 = _ops(12, 16, 6.0)
    with pytest.raises(ValueError) as je:
        j_build(jm, op2, 0.05, dtype=jnp.float64)
    with pytest.raises(ValueError) as te:
        tsharded.build_sharded_step(tm, top2, 0.05, dtype=torch.float64)
    assert str(te.value) == str(je.value)


def test_pulse_chunk_requires_start_time():
    """``test_pulse_chunk_requires_start_time``: a pulse-gated ensemble
    chunk refuses an implicit start time, as the JAX package's does."""
    from qpsim_tpu.parallel.ensemble import build_film_ensemble as j_ens

    from qpsim_tpu_torch.parallel.ensemble import build_film_ensemble as t_ens

    kw = dict(n_members=2, member_shape=(6, 10), num_energy_bins=4, dt=0.05)
    for build, extra, asarray in ((j_ens, dict(dtype=jnp.float64), jnp.asarray),
                                  (t_ens, dict(dtype=torch.float64, device="cpu"), torch.as_tensor)):
        ens = build(**kw, **extra)
        plane = ens.generation_plane(np.array([1e-6, 2e-6]))
        q, ph = ens.pack(np.zeros((2, 4, 6, 10)), ens.thermal_phonons(np.zeros(2)))
        q, ph = asarray(q), asarray(ph)
        gated = ens.make_chunk(2, gen_plane=plane, pulse_window=(0.0, 0.2))
        with pytest.raises(TypeError, match="re-fire"):
            gated(q, ph)
        gated(q, ph, 0.0)
        ens.make_chunk(2, gen_plane=plane)(q, ph)


# ---------------------------------------------------------------- the engine's mesh=


def _engine_kwargs(total_time, store_every, gen=False, gap_expression="", drive=None):
    """The JAX and the port's keywords; ``drive(params_module)`` adds keywords built per package."""
    ny = nx = 16
    mask, edges, bcs = _geometry(ny, nx)
    init = np.zeros(mask.shape)
    init[mask] = 0.01
    common = dict(
        mask=mask, initial_field=init, diffusion_coefficient=6.0, dt=0.05, total_time=total_time, dx=1.0,
        store_every=store_every, energy_gap=GAP, energy_max_factor=3.0, num_energy_bins=4,
        enable_recombination=True, enable_scattering=True, tau_s=TAU, tau_r=TAU, T_c=TC,
        bath_temperature=TBATH, gap_expression=gap_expression,
    )
    t_bcs = {k: tp.BoundaryCondition(kind=v.kind, value=v.value) for k, v in bcs.items()}
    jkw = dict(common, edges=edges, edge_conditions=bcs)
    tkw = dict(common, edges=t_edges(mask), edge_conditions=t_bcs)
    if gen:
        spec = dict(mode="pulse", pulse_start=0.05, pulse_duration=0.2, pulse_rate=2e-4)
        jkw["external_generation"] = ExternalGenerationSpec(**spec)
        tkw["external_generation"] = tp.ExternalGenerationSpec(**spec)
    if drive is not None:
        jkw.update(drive(jp))
        tkw.update(drive(tp))
    return jkw, tkw


def _assert_runs_close(got, want, rtol_mass=1e-11):
    assert got[0] == want[0]
    for a, b in zip(got[1], want[1]):
        np.testing.assert_allclose(np.nan_to_num(a), np.nan_to_num(b), rtol=0, atol=1e-12)
    np.testing.assert_allclose(got[2], want[2], rtol=rtol_mass)
    if want[4] is not None:
        for ea, eb in zip(got[4], want[4]):
            for a, b in zip(ea, eb):
                np.testing.assert_allclose(np.nan_to_num(a), np.nan_to_num(b), rtol=0, atol=1e-12)


ENGINE_CASES = {
    # test_engine_mesh_matches_single_chip: exact, a remainder segment
    "exact": dict(total_time=0.325, store_every=2, strang_mode="exact"),
    # test_engine_mesh_merged_matches_single_chip: merged seams, pulsed generation
    "merged_generation": dict(total_time=0.425, store_every=4, gen=True, strang_mode="merged"),
    # test_engine_mesh_merged_gap_map_matches_single_chip
    "merged_gap_map": dict(total_time=0.4, store_every=4, gap_expression="return 160.0 + 30.0 * (x > 8)",
                           strang_mode="merged"),
    # test_engine_mesh_gap_map_and_generation_match_single_chip ('auto' → merged)
    "gap_map_generation": dict(total_time=0.25, store_every=1, gen=True,
                               gap_expression="return 160.0 + 30.0 * (x > 8)", strang_mode="auto"),
    # a traced custom expression with a one-tone photon drive ('auto' → merged: both at every seam)
    "custom_traced_with_photons": dict(
        total_time=0.325, store_every=2, strang_mode="auto",
        drive=lambda p: dict(
            external_generation=p.ExternalGenerationSpec(
                mode="custom", custom_body="params.get('a', 1.0) * 2e-6 * (1.0 + x)", custom_params={"a": 3.0}),
            photon_drive=p.PhotonDriveSpec(mode="photon", photon_energy=2.6 * GAP, occupancy=2.0, coupling=2e-4))),
    # a host-evaluated expression with a windowed tone: one step per host evaluation ('auto' → exact)
    "custom_host": dict(
        total_time=0.4, store_every=3, strang_mode="auto",
        drive=lambda p: dict(
            external_generation=p.ExternalGenerationSpec(
                mode="custom", custom_body="2e-6 * (1.0 + x) if t >= 0.1 else 0.0"),
            photon_drive=p.PhotonDriveSpec(mode="photon", photon_energy=2.6 * GAP, occupancy=2.0, coupling=2e-4,
                                           window_start=0.1, window_duration=0.25))),
}


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_engine_mesh_matches_jax_and_the_single_device_engine(case):
    """``run_2d_crank_nicolson(mesh=...)`` against the JAX engine's mesh run
    and the port's single-device run (frames 1e-12, mass 1e-11 relative)."""
    kw = dict(ENGINE_CASES[case])
    strang = kw.pop("strang_mode")
    jkw, tkw = _engine_kwargs(**kw)
    want = j_run(**jkw, mesh=jmesh.make_mesh(n_space=N_DEV), strang_mode=strang)
    got = T.run_2d_crank_nicolson(**tkw, mesh=_t_mesh(), strang_mode=strang)
    _assert_runs_close(got, want)
    single = T.run_2d_crank_nicolson(**tkw, strang_mode=strang, device="cpu")
    _assert_runs_close(got, single)


def test_engine_mesh_merged_differs_from_exact():
    """Merged over the mesh is a real O(dt²) reordering of exact, and
    'auto' is merged (``test_engine_mesh_merged_matches_single_chip``)."""
    _, tkw = _engine_kwargs(total_time=0.425, store_every=4, gen=True)
    mesh = _t_mesh()
    m_m = T.run_2d_crank_nicolson(**tkw, mesh=mesh, strang_mode="merged")[2]
    m_a = T.run_2d_crank_nicolson(**tkw, mesh=mesh)[2]
    m_e = T.run_2d_crank_nicolson(**tkw, mesh=mesh, strang_mode="exact")[2]
    np.testing.assert_allclose(m_a, m_m, rtol=1e-13)
    assert max(abs(a - b) for a, b in zip(m_e, m_m)) > 1e-10


def test_engine_mesh_y_solve_env_and_parameter(monkeypatch):
    """``test_engine_mesh_wang_env_matches_pencil`` and
    ``test_engine_mesh_y_solve_parameter``: QPSIM_MESH_Y_SOLVE and the
    per-call argument pick the y solve; the runs agree at 1e-12; a bad
    name is refused with the JAX message."""
    jkw, tkw = _engine_kwargs(total_time=0.4, store_every=4)
    mesh = _t_mesh()
    monkeypatch.setenv("QPSIM_MESH_Y_SOLVE", "pencil")
    p = T.run_2d_crank_nicolson(**tkw, mesh=mesh)
    monkeypatch.setenv("QPSIM_MESH_Y_SOLVE", "wang")
    w = T.run_2d_crank_nicolson(**tkw, mesh=mesh)
    assert w[0] == p[0]
    for a, b in zip(w[1], p[1]):
        np.testing.assert_allclose(np.nan_to_num(a), np.nan_to_num(b), rtol=0, atol=1e-12)
    np.testing.assert_allclose(w[2], p[2], rtol=1e-12)
    monkeypatch.delenv("QPSIM_MESH_Y_SOLVE")
    m_p = T.run_2d_crank_nicolson(**tkw, mesh=mesh, mesh_y_solve="pencil")[2]
    np.testing.assert_allclose(m_p, p[2], rtol=0, atol=0)
    jw = j_run(**jkw, mesh=jmesh.make_mesh(n_space=N_DEV), mesh_y_solve="wang")
    np.testing.assert_allclose(w[2], jw[2], rtol=1e-12)
    with pytest.raises(ValueError) as je:
        j_run(**jkw, mesh=jmesh.make_mesh(n_space=N_DEV), mesh_y_solve="Wang")
    with pytest.raises(ValueError) as te:
        T.run_2d_crank_nicolson(**tkw, mesh=mesh, mesh_y_solve="Wang")
    assert str(te.value) == str(je.value)


def test_engine_mesh_rejects_unsupported_modes():
    """``test_engine_mesh_rejects_unsupported_modes``: the scalar branch and
    a run without diffusion are refused with the JAX messages; a device of
    another type than the mesh's is refused."""
    jkw, tkw = _engine_kwargs(total_time=0.1, store_every=1)
    drop = ("energy_gap", "num_energy_bins", "energy_max_factor")
    cases = (
        ({k: v for k, v in jkw.items() if k not in drop}, {k: v for k, v in tkw.items() if k not in drop}),
        (dict(jkw, enable_diffusion=False), dict(tkw, enable_diffusion=False)),
    )
    for jk, tk in cases:
        with pytest.raises(ValueError) as je:
            j_run(**jk, mesh=jmesh.make_mesh(n_space=N_DEV))
        with pytest.raises(ValueError) as te:
            T.run_2d_crank_nicolson(**tk, mesh=_t_mesh())
        assert str(te.value).replace("qpsim_tpu_torch", "qpsim_tpu") == str(je.value)
    with pytest.raises(ValueError, match="differs from the mesh"):
        T.run_2d_crank_nicolson(**tkw, mesh=_t_mesh(), device="cuda")
