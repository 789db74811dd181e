"""The collision substep beyond 64 bins (K5, K5 with gap ids, K6) against ``qpsim_tpu``.

Float64 on the CPU, where the wrappers ``collision_step_blocked`` and
``collision_step_blocked_analytic`` run their plain versions (K3's and
K4's, the same function over more bins):

* against the JAX package's blocked Pallas kernels in interpret mode
  (``build_pallas_collision_step_blocked[_analytic]``) at that package's
  own tolerances (``tests/test_collisions.py``: q 1e-12, n_ph 1e-9);
* at NE = 65, where a pair diagonal splits two ω bins and the JAX blocked
  builder declines, against the JAX XLA integrator it runs instead;
* the CUDA kernel's tables and walk (``csrc/collisions_blocked.cu``: 32-pixel
  tiles staged [NE][32], bins and ω rows strided over the warps) through a
  NumPy transcription, at NE = 72, whose ω rows carry differences and
  sums together, and at NE = 65;
* ``run_2d_crank_nicolson`` at NE = 72 on a 12-cell strip, uniform gap,
  a trap and a gradient, against the JAX engine on its blocked kernels
  (mass 1e-9, frames 1e-8, as ``tests/test_engine.py`` holds them);
* the dispatch (``collision_kernel_for``) at its boundaries, the wrapper
  the engine steps through, and the error on CUDA beyond 256 bins;
* the new modules under the port's no-JAX rule.
"""

import ast
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import qpsim_tpu as J  # noqa: E402
from qpsim_tpu.geometry.mask import extract_edge_segments  # noqa: E402
from qpsim_tpu.models.params import BoundaryCondition  # noqa: E402
from qpsim_tpu.ops.collisions import build_collision_plan_arrays as j_plan  # noqa: E402
from qpsim_tpu.ops.collisions import make_collision_step  # noqa: E402
from qpsim_tpu.ops.dos import dynes_density_of_states, thermal_phonon_occupation  # noqa: E402
from qpsim_tpu.ops.energy_grid import build_energy_grid  # noqa: E402
from qpsim_tpu.ops.kernels import recombination_kernel_base, scattering_kernel_base  # noqa: E402
from qpsim_tpu.ops.pallas_collisions import _uniform_pair_rows  # noqa: E402
from qpsim_tpu.ops.pallas_collisions_blocked import (  # noqa: E402
    build_pallas_collision_step_blocked,
    build_pallas_collision_step_blocked_analytic,
)
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
from qpsim_tpu_torch.ops.collisions import collision_step_analytic_plain, collision_step_plain  # noqa: E402
from qpsim_tpu_torch.ops.collisions_blocked_cuda import (  # noqa: E402
    MAX_BLOCKED_BINS,
    collision_step_blocked,
    collision_step_blocked_analytic,
)
from qpsim_tpu_torch.solver import engine as t_engine  # noqa: E402
from qpsim_tpu_torch.solver.program_build import collision_kernel_for  # noqa: E402

NY, NX = 2, 4
DT = 0.02
TAU_S, TAU_R, T_C = 440.0, 520.0, 1.2


def _setup(ne, *, gaps=(180.0,), scattering=True, recombination=True, phonons=True, seed=0,
           ny=NY, nx=NX):
    """Host physics from the JAX package, the port's plan from it, and a state."""
    E, dE = build_energy_grid(180.0, 1.0, 4.0, ne)
    pm = build_phonon_frequency_map(E)
    rng = np.random.default_rng(seed)
    gid = None if len(gaps) == 1 else rng.integers(0, len(gaps), (ny, nx)).astype(np.int32)
    rho = np.stack([dynes_density_of_states(E, g, 0.0) for g in gaps])
    Ks = np.stack([scattering_kernel_base(E, g, TAU_S, T_C) for g in gaps]) if scattering else None
    Kr = np.stack([recombination_kernel_base(E, g, TAU_R, T_C) for g in gaps]) if recombination else None
    plan = collision_tables_from_numpy(
        dE=dE, rho=rho, K_s0=Ks, K_r0=Kr, omega_bins=pm.omega_bins, idx_diff=pm.idx_diff,
        idx_sum=pm.idx_sum, diff_sign=pm.diff_sign, enable_scattering=scattering,
        enable_recombination=recombination, update_phonons=phonons, device="cpu",
        dtype=torch.float64, pixel_chunk=5, gap_id=gid,  # several chunks, one ragged
    )
    rho_px = rho[0][:, None, None] if gid is None else rho[gid].transpose(2, 0, 1)
    q = rng.uniform(0, 2e-3, (ne, ny, nx)) * rho_px
    ph = thermal_phonon_occupation(pm.omega_bins, 0.25)[:, None, None] * rng.uniform(
        0.5, 2.0, (pm.num_omega, ny, nx))
    return dict(E=E, dE=dE, pm=pm, rho=rho, Ks=Ks, Kr=Kr, gid=gid, plan=plan, q=q, ph=ph)


def _one(a):
    """A (1, ...) per-gap stack as the JAX builders take a uniform gap."""
    return None if a is None else (a[0] if a.shape[0] == 1 else a)


def _jax_blocked(s, phonons):
    return build_pallas_collision_step_blocked(
        E_bins=s["E"], dE=s["dE"], rho=_one(s["rho"]), K_s0=_one(s["Ks"]), K_r0=_one(s["Kr"]),
        pmap=s["pm"], dt=DT, update_phonons=phonons, tile=128, block=8, interpret=True,
        gap_id=s["gid"],  # block 8: half the interpret time of the default 16, same result
    )


def _port(step, *args, q, ph, gen=None):
    qt, pt = state_to_torch(q, ph, "cpu", torch.float64)
    g = None if gen is None else torch.as_tensor(gen)
    return state_to_numpy(*step(*args, qt, pt, DT, g))


def _close(got, want, rtol_q=1e-12, rtol_ph=1e-9):
    np.testing.assert_allclose(got[0], want[0], rtol=rtol_q, atol=1e-22)
    np.testing.assert_allclose(got[1], want[1], rtol=rtol_ph, atol=1e-22)


# ---------------------------------------------------------------- (a), (b) K5


@pytest.mark.parametrize(
    "ne,scattering,recombination,phonons",
    [(72, True, False, True), (72, False, True, True), (72, True, True, True),
     (72, True, True, False), (80, True, True, True)],
    ids=["scattering-72", "recombination-72", "both-72", "frozen_phonons-72", "both-80"],
)
def test_blocked_matches_jax_blocked_interpret(ne, scattering, recombination, phonons):
    s = _setup(ne, scattering=scattering, recombination=recombination, phonons=phonons, seed=ne)
    pal = _jax_blocked(s, phonons)
    assert pal is not None
    want = [np.asarray(a) for a in pal(jnp.asarray(s["q"]), jnp.asarray(s["ph"]))]
    tables = collisions_cuda.build_kernel_tables(s["plan"])
    got = _port(collision_step_blocked, s["plan"], tables, q=s["q"], ph=s["ph"])
    _close(got, want)
    if not phonons:
        np.testing.assert_array_equal(got[1], s["ph"])


def test_blocked_gap_ids_match_jax_blocked_interpret():
    s = _setup(80, gaps=(150.0, 165.0, 180.0), seed=81)
    assert len(np.unique(s["gid"])) == 3
    want = [np.asarray(a) for a in _jax_blocked(s, True)(jnp.asarray(s["q"]), jnp.asarray(s["ph"]))]
    tables = collisions_cuda.build_kernel_tables(s["plan"])
    _close(_port(collision_step_blocked, s["plan"], tables, q=s["q"], ph=s["ph"]), want)


# ---------------------------------------------------------------- (c) K6


def _analytic_setup(ne, gamma, *, phonons=True, seed=0):
    E, dE = build_energy_grid(180.0, 1.0, 4.0, ne)
    pm = build_phonon_frequency_map(E)
    rng = np.random.default_rng(seed)
    plane = rng.uniform(140.0, 195.0, (NY, NX))
    plan, tab = analytic_tables_from_numpy(
        E_bins=E, dE=dE, gap_plane=plane, omega_bins=pm.omega_bins, idx_diff=pm.idx_diff,
        idx_sum=pm.idx_sum, diff_sign=pm.diff_sign, tau_s=TAU_S, tau_r=TAU_R, T_c=T_C,
        dynes_gamma=gamma, update_phonons=phonons, device="cpu", dtype=torch.float64,
        pixel_chunk=5,
    )
    rho = np.stack([dynes_density_of_states(E, g, gamma) for g in plane.reshape(-1)]).T
    q = rng.uniform(0, 2e-3, (ne, NY, NX)) * rho.reshape(ne, NY, NX)
    ph = thermal_phonon_occupation(pm.omega_bins, 0.25)[:, None, None] * rng.uniform(
        0.5, 2.0, (pm.num_omega, NY, NX))
    return dict(E=E, dE=dE, pm=pm, plane=plane, plan=plan, tab=tab, q=q, ph=ph)


@pytest.mark.parametrize("gamma", [0.0, 0.12], ids=["bcs", "dynes"])
def test_blocked_analytic_matches_jax_blocked_analytic_interpret(gamma):
    s = _analytic_setup(72, gamma, seed=5)
    pal = build_pallas_collision_step_blocked_analytic(
        E_bins=s["E"], dE=s["dE"], gap_plane=s["plane"], pmap=s["pm"], dt=DT, tau_s=TAU_S,
        tau_r=TAU_R, T_c=T_C, dynes_gamma=gamma, update_phonons=True, tile=128, interpret=True,
    )
    assert pal is not None
    want = [np.asarray(a) for a in pal(jnp.asarray(s["q"]), jnp.asarray(s["ph"]))]
    tables = collisions_cuda.build_kernel_tables(s["plan"])
    got = _port(collision_step_blocked_analytic, s["plan"], s["tab"], tables, q=s["q"], ph=s["ph"])
    # the JAX package holds its analytic kernels at q 1e-11 (tests/test_torch_gap_maps.py)
    _close(got, want, rtol_q=1e-11)


# ---------------------------------------------------------------- (d) split ω diagonals


@pytest.mark.parametrize("gen", [False, True], ids=["no_gen", "gen"])
def test_split_omega_diagonals_match_the_xla_integrator(gen):
    s = _setup(65, seed=11)
    assert _uniform_pair_rows(np.asarray(s["E"]), s["pm"]) is None  # a diagonal splits
    assert _jax_blocked(s, True) is None  # so the JAX package declines its blocked kernel
    jp = j_plan(dE=s["dE"], rho_by_gap=s["rho"], K_r0_by_gap=s["Kr"], K_s0_by_gap=s["Ks"],
                gap_id=np.zeros((NY, NX), np.int32), pmap=s["pm"], enable_recombination=True,
                enable_scattering=True, update_phonons=True, pixel_chunk=5)
    g = np.random.default_rng(3).uniform(0, 1e-6, (NY, NX)) if gen else None
    q_in = s["q"] + (0.0 if g is None else g[None])  # the XLA step takes dt·g added
    want = [np.asarray(a) for a in make_collision_step(jp, DT)(jnp.asarray(q_in), jnp.asarray(s["ph"]))]
    tables = collisions_cuda.build_kernel_tables(s["plan"])
    _close(_port(collision_step_blocked, s["plan"], tables, q=s["q"], ph=s["ph"], gen=g), want,
           rtol_ph=1e-12)


# ---------------------------------------------------------------- the kernel's walk


def _blocked_transcription(tables, plan, q, ph, gen, dt, consts):
    """``csrc/collisions_blocked.cu`` in NumPy: 32-pixel tiles, the tile's q
    and partner staged [NE][32] (zeros in a ragged tile's idle lanes), bins
    and ω rows strided over 8 warps, each lane's pair walk vectorised over
    the tile.  ``consts(lo, hi)`` gives (scat, rec2, partner) for pixels
    lo..hi: scat(ij) and rec2(ij) per-pixel vectors, partner(i, q)."""
    tile, warps = 32, 8
    idx_diff, idx_sum, sgn = tables.idx_diff.numpy(), tables.idx_sum.numpy(), tables.sign.numpy()
    row_ptr, row_code = tables.row_ptr.numpy(), tables.row_code.numpy()
    ne, nw = plan.num_energy_bins, plan.num_omega
    qf, phf = q.reshape(ne, -1), ph.reshape(nw, -1)
    n_pix = qf.shape[1]
    q_out, ph_out = np.empty_like(qf), phf.copy()
    for lo in range(0, n_pix, tile):
        hi = min(lo + tile, n_pix)
        scat, rec2, partner = consts(lo, hi)
        sq, sp = np.zeros((ne, tile)), np.zeros((ne, tile))
        for w in range(warps):
            for i in range(w, ne, warps):
                qi = qf[i, lo:hi] + (0.0 if gen is None else gen.reshape(-1)[lo:hi])
                sq[i, : hi - lo], sp[i, : hi - lo] = qi, partner(i, qi)
        sq, sp, p = sq[:, : hi - lo], sp[:, : hi - lo], phf[:, lo:hi]
        for w in range(warps):
            for i in range(w, ne, warps):
                gain_s = loss_s = gain_r = loss_r = 0.0
                for j in range(ne):
                    ij, ji = i * ne + j, j * ne + i
                    if plan.enable_scattering:
                        if sgn[ij] != 0:
                            n = p[idx_diff[ij]]
                            loss_s = loss_s + scat(ij) * ((1.0 + n) if sgn[ij] > 0 else n) * sp[j]
                        if sgn[ji] != 0:
                            n = p[idx_diff[ji]]
                            gain_s = gain_s + scat(ji) * ((1.0 + n) if sgn[ji] > 0 else n) * sq[j]
                    if plan.enable_recombination:
                        sv = p[idx_sum[ij]]
                        loss_r = loss_r + rec2(ij) * (1.0 + sv) * sq[j]
                        gain_r = gain_r + rec2(ij) * sv * sp[j]
                gain = sp[i] * gain_s + sp[i] * gain_r
                loss = loss_s + loss_r + np.zeros(hi - lo)
                mu = np.maximum(loss, 0.0)
                p_term = np.maximum(gain + (mu - loss) * sq[i], 0.0)
                coeff = np.where(mu < 1e-14, dt, -np.expm1(-mu * dt) / np.maximum(mu, 1e-14))
                q_out[i, lo:hi] = np.maximum(np.exp(-mu * dt) * sq[i] + coeff * p_term, 0.0)
        if not plan.update_phonons:
            continue
        for w in range(warps):
            for row in range(w, nw, warps):
                a = b = np.zeros(hi - lo)
                for code in row_code[row_ptr[row] : row_ptr[row + 1]]:
                    pair, kind = int(code) >> 2, int(code) & 3
                    i, j = divmod(pair, ne)
                    if kind == 2:
                        k = 0.5 * rec2(pair)
                        rec = k * sq[i] * sq[j]
                        a, b = a + rec, b + (rec - k * sp[i] * sp[j])
                    else:
                        v = scat(pair) * sq[i] * sp[j]
                        a, b = (a + v, b + v) if kind == 0 else (a, b - v)
                x = np.clip(b * dt, -80.0, 80.0)
                tiny = np.abs(b) < 1e-14
                c = np.where(tiny, dt, np.expm1(x) / np.where(tiny, 1.0, b))
                ph_out[row, lo:hi] = np.maximum(np.exp(x) * p[row] + c * a, 0.0)
    return q_out.reshape(q.shape), ph_out.reshape(ph.shape)


def _table_consts(tables, plan):
    """K5's TableConsts: each pixel's tables by its gap id."""
    ne = plan.num_energy_bins
    gid = np.zeros(0, np.int64) if plan.gap_id is None else plan.gap_id.numpy().astype(np.int64)
    rho = tables.rho.numpy().reshape(-1, ne)
    ks = None if tables.ks is None else tables.ks.numpy().reshape(-1, ne * ne)
    kr = None if tables.kr is None else tables.kr.numpy().reshape(-1, ne * ne)

    def consts(lo, hi):
        g = gid[lo:hi] if gid.size else np.zeros(hi - lo, np.int64)

        def partner(i, qi):
            r = rho[g, i]
            return r * np.maximum(1.0 - qi / np.maximum(r, 1e-30), 0.0)

        return (lambda ij: ks[g, ij]), (lambda ij: kr[g, ij]), partner

    return consts


def _analytic_consts(tab):
    """K6's AnalyticConsts: constants and ρ from each pixel's Δ²."""
    e, inv_e, e2, zim = (t.numpy() for t in (tab.E, tab.inv_E, tab.e2, tab.zi))
    flat = lambda t: None if t is None else t.numpy().reshape(-1)
    a_s, b_s, a_r, b_r = flat(tab.dEa_s), flat(tab.dEb_s), flat(tab.dEa2_r), flat(tab.dEb2_r)
    g2, gamma = tab.g2.numpy(), tab.gamma

    def consts(lo, hi):
        d2 = g2[lo:hi]

        def partner(i, qi):
            if gamma == 0.0:
                r2 = e2[i] - d2
                t = 1.0 / np.sqrt(np.maximum(r2, 1e-30))
                rho = np.where(r2 > 0, e[i] * t, 0.0)
                inv = np.where(r2 > 0, (r2 * t) * inv_e[i], 0.0)
            else:
                zr = e2[i] - d2
                r = np.sqrt(zr * zr + zim[i] * zim[i])
                s = np.sqrt(np.maximum(0.5 * (r + zr), 0.0))
                tq = -np.sqrt(np.maximum(0.5 * (r - zr), 0.0))
                rho = np.maximum((e[i] * s - gamma * tq) / np.maximum(r, 1e-30), 0.0)
                inv = np.where(rho > 1e-30, 1.0 / np.maximum(rho, 1e-30), 0.0)
            return rho * np.maximum(1.0 - qi * inv, 0.0)

        scat = lambda ij: np.maximum(a_s[ij] - b_s[ij] * d2, 0.0)
        rec2 = lambda ij: a_r[ij] + b_r[ij] * d2
        return scat, rec2, partner

    return consts


@pytest.mark.parametrize(
    "ne,gaps,gen",
    [(72, (180.0,), True), (65, (180.0,), False), (72, (150.0, 165.0, 180.0), True)],
    ids=["shared_rows_gen", "split_diagonals", "gap_ids_gen"],
)
def test_blocked_kernel_walk_reproduces_plain_version(ne, gaps, gen):
    # 37 pixels: one full 32-pixel tile and a ragged one
    s = _setup(ne, gaps=gaps, seed=ne, ny=1, nx=37)
    plan = s["plan"]
    if ne == 72:  # ω rows that carry both a difference and a sum
        assert plan.num_omega < 3 * ne - 1
        assert np.intersect1d(s["pm"].idx_diff[s["pm"].diff_sign != 0], s["pm"].idx_sum).size > 0
    g = np.random.default_rng(4).uniform(0, 1e-6, s["q"].shape[1:]) if gen else None
    tables = collisions_cuda.build_kernel_tables(plan)
    want = _port(collision_step_plain, plan, q=s["q"], ph=s["ph"], gen=g)
    got = _blocked_transcription(tables, plan, s["q"], s["ph"], g, DT, _table_consts(tables, plan))
    _close(got, want, 1e-12, 1e-12)


@pytest.mark.parametrize("gamma", [0.0, 0.12], ids=["bcs", "dynes"])
def test_blocked_analytic_kernel_walk_reproduces_plain_version(gamma):
    s = _analytic_setup(72, gamma, seed=9)
    tables = collisions_cuda.build_kernel_tables(s["plan"])
    g = np.random.default_rng(6).uniform(0, 1e-6, (NY, NX))
    want = _port(collision_step_analytic_plain, s["plan"], s["tab"], q=s["q"], ph=s["ph"], gen=g)
    got = _blocked_transcription(tables, s["plan"], s["q"], s["ph"], g, DT, _analytic_consts(s["tab"]))
    _close(got, want, 1e-12, 1e-12)


def test_blocked_wrappers_run_plain_on_cpu_and_launch_nothing():
    s = _setup(70, gaps=(160.0, 180.0), seed=2)
    tables = collisions_cuda.build_kernel_tables(s["plan"])
    qt, pt = state_to_torch(s["q"], s["ph"], "cpu", torch.float64)
    gen = torch.full(qt.shape[1:], 1e-7, dtype=torch.float64)
    before = dict(collisions_cuda.LAUNCHES)
    a = collision_step_blocked(s["plan"], tables, qt, pt, DT, gen)
    b = collision_step_plain(s["plan"], qt, pt, DT, gen)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
    sa = _analytic_setup(70, 0.0, seed=3)
    qa, pa = state_to_torch(sa["q"], sa["ph"], "cpu", torch.float64)
    ta = collisions_cuda.build_kernel_tables(sa["plan"])
    a = collision_step_blocked_analytic(sa["plan"], sa["tab"], ta, qa, pa, DT)
    b = collision_step_analytic_plain(sa["plan"], sa["tab"], qa, pa, DT)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
    assert collisions_cuda.LAUNCHES == before
    np.testing.assert_array_equal(qt.numpy(), s["q"])  # inputs untouched


# ---------------------------------------------------------------- (e) the slice end to end


def _strip_kwargs(pkg, **extra):
    mask = np.ones((1, 12), dtype=bool)
    edges = extract_edge_segments(mask)
    bc = BoundaryCondition if pkg == "jax" else tp.BoundaryCondition
    kw = dict(mask=mask, edges=edges, edge_conditions={e.edge_id: bc(kind="reflective") for e in edges},
              initial_field=np.full(mask.shape, 1e-5), diffusion_coefficient=6.0, dt=0.05,
              total_time=0.1, dx=1.0, energy_gap=180.0, num_energy_bins=72, energy_max_factor=4.0,
              enable_recombination=True, enable_scattering=True, bath_temperature=0.2)
    return dict(kw, **extra)


@pytest.mark.parametrize(
    "gap_expression",
    ["", "return 180.0 - 20.0 * (x < 0.4)", "return 140.0 + 30.0 * x"],
    ids=["uniform", "trap", "gradient"],
)
def test_engine_at_72_bins_matches_the_jax_blocked_kernels(gap_expression):
    extra = dict(gap_expression=gap_expression) if gap_expression else {}
    _, fa, ma, _, efa, _ = J.run_2d_crank_nicolson(**_strip_kwargs("jax", **extra), collision_backend="pallas")
    _, fb, mb, _, efb, _ = T.run_2d_crank_nicolson(**_strip_kwargs("torch", **extra), device="cpu")
    np.testing.assert_allclose(mb, ma, rtol=1e-9)
    for a, b in zip(fa, fb):
        np.testing.assert_allclose(np.nan_to_num(b), np.nan_to_num(a), atol=1e-18, rtol=1e-8)
    for a, b in zip(efa[-1], efb[-1]):
        np.testing.assert_allclose(np.nan_to_num(b), np.nan_to_num(a), atol=1e-18, rtol=1e-8)


# ---------------------------------------------------------------- (f) dispatch


@pytest.mark.parametrize(
    "ne,n_gaps,kernel",
    [(64, 1, "K3"), (65, 1, "K5"), (64, 8, "K3_gid"), (65, 8, "K5_gid"), (256, 2, "K5_gid"),
     (64, 9, "K4"), (65, 9, "K6"), (256, 9, "K6"), (256, 1, "K5"), (257, 1, None), (257, 9, None)],
)
def test_collision_kernel_for_boundaries(ne, n_gaps, kernel):
    assert collision_kernel_for(ne, n_gaps) == kernel
    assert MAX_BLOCKED_BINS == 256


@pytest.mark.parametrize(
    "ne,gap_expression,wrapper",
    [(72, "", "collision_step_blocked"), (72, "return 180.0 - 20.0 * (x < 0.4)", "collision_step_blocked"),
     (72, "return 140.0 + 30.0 * x", "collision_step_blocked_analytic"), (16, "", "collision_step"),
     (16, "return 140.0 + 30.0 * x", "collision_step_analytic")],
    ids=["uniform-72", "trap-72", "gradient-72", "uniform-16", "gradient-16"],
)
def test_engine_steps_through_the_dispatched_wrapper(monkeypatch, ne, gap_expression, wrapper):
    from qpsim_tpu_torch.solver import program_build

    calls = {}
    for code, real in list(program_build._KERNEL_STEPS.items()):
        def spy(*args, _real=real):
            calls[_real.__name__] = calls.get(_real.__name__, 0) + 1
            return _real(*args)

        monkeypatch.setitem(program_build._KERNEL_STEPS, code, spy)
    extra = dict(gap_expression=gap_expression) if gap_expression else {}
    T.run_2d_crank_nicolson(**_strip_kwargs("torch", num_energy_bins=ne, **extra), device="cpu")
    assert list(calls) == [wrapper] and calls[wrapper] > 0


def test_beyond_the_cap_cuda_raises_and_the_cpu_runs_plain(monkeypatch):
    kw = _strip_kwargs("torch", num_energy_bins=257, total_time=0.05, enable_scattering=False)
    monkeypatch.setattr(t_engine, "_resolve_device", lambda device: torch.device("cuda"))
    with pytest.raises(NotImplementedError, match="256.*ROADMAP"):
        T.run_2d_crank_nicolson(**kw, dtype=torch.float64)
    monkeypatch.undo()
    before = dict(collisions_cuda.LAUNCHES)
    out = T.run_2d_crank_nicolson(**kw, device="cpu")
    assert np.all(np.isfinite(out[1][-1])) and collisions_cuda.LAUNCHES == before


# ---------------------------------------------------------------- (g) no JAX


def test_blocked_modules_are_in_the_no_jax_scan_and_import_no_jax():
    port = Path(T.__file__).resolve().parent
    scanned = set(port.rglob("*.py"))  # the files tests/test_torch_host_layer.py scans
    for rel in ("ops/collisions_blocked_cuda.py", "ops/collisions_cuda.py", "solver/program_build.py"):
        path = port / rel
        assert path in scanned
        tree = ast.parse(path.read_text())
        names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
        names += [n.module or "" for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.level == 0]
        assert not [m for m in names if m.split(".")[0] in ("jax", "jaxlib", "qpsim_tpu")], rel
