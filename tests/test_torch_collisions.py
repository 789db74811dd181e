"""The collision substep: plain version against ``qpsim_tpu``, kernel tables on the CPU.

Float64 on the CPU.  The plain PyTorch version is held against the XLA
integrator (``make_collision_step``) and against the Pallas kernel in
interpret mode, whose Taylor-expm1 hybrid (relative error ≲ 1e-10) sets the
looser tolerance there.  The CUDA kernel itself runs only on the card; its
tables and its walk (each unordered pair once, diagonal-major, in groups of
one ω row each) are checked here by the NumPy transcription
``tests/pair_walk_transcription.py``, against the plain version and the
XLA integrator: up to the register bucket's 16 bins (NE 7–16, padded
bins, a split ω diagonal at 11) and beyond it, where K3 runs the column
walk of K5 (17, 33, 64; ``tests/column_walk_transcription.py``), with each
channel off, frozen phonons and with and without the dt·g plane.
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
from qpsim_tpu_torch.ops.column_walk import ColumnTables, column_pixels  # noqa: E402
from column_walk_transcription import transcribe as column_walk  # noqa: E402
from pair_walk_transcription import transcribe  # noqa: E402

GAP = 180.0
DT = 0.02


def _setup(ne, *, scattering=True, recombination=True, phonons=True, seed=0, ny=4, nx=32, emax=4.0):
    """Host physics from the JAX package, the port's plan from it, and a state."""
    E, dE = build_energy_grid(GAP, 1.0, emax, ne)
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
    walk = collisions_cuda.pair_walk(s["plan"], 16)
    assert len(walk.s_meta) > 10  # more scattering groups than diagonals: a diagonal splits
    q3, p3 = _walk(s, s["q"], s["ph"], None)
    np.testing.assert_allclose(q3, q2, rtol=1e-12, atol=1e-30)
    np.testing.assert_allclose(p3, p2, rtol=1e-12, atol=1e-30)


def _walk(s, q, ph, gen, dt=DT):
    """The kernel's walk (NumPy) on the wrapper's tables: the pair walk up to
    16 bins, the column walk of K5/K6 beyond (where K3 launches it)."""
    plan = s["plan"]
    tables = collisions_cuda.build_kernel_tables(plan)
    if isinstance(tables, ColumnTables):
        n_pix = q[0].size
        return column_walk(tables, q, ph, gen, dt, plan.update_phonons,
                           column_pixels(torch.float64, plan.num_energy_bins, n_pix))
    return transcribe(plan, tables, q, ph, gen, dt)


@pytest.mark.parametrize(
    "ne,scattering,recombination,phonons,gen",
    [(7, True, True, True, True), (7, True, False, True, False), (7, False, True, False, True),
     (8, True, True, True, False), (9, True, True, True, True), (16, True, True, True, True),
     (16, True, True, True, False), (16, True, False, True, True), (16, False, True, True, True),
     (16, True, True, False, True), (17, True, True, True, True), (33, True, True, True, False),
     (64, True, True, True, True), (1, True, True, True, False), (1, False, True, False, False),
     (2, True, True, True, False), (24, True, True, True, True), (48, True, False, True, False),
     (64, True, True, False, True)],
    ids=["both_gen", "scattering", "recombination_frozen_gen", "8", "9", "16_gen", "16",
         "16_scattering", "16_recombination", "16_frozen", "17_column_walk", "33_column_walk",
         "64_column_walk", "1", "1_recombination_frozen", "2", "24_column_walk",
         "48_scattering_column_walk", "64_frozen_column_walk"],
)
def test_kernel_tables_reproduce_plain_version(ne, scattering, recombination, phonons, gen):
    # up to 16 bins on _setup's 4 × 32 grid (three pixel chunks, one ragged);
    # the column walk's wider cases on 2 × 8, for their cost
    grid = {} if ne <= 16 else dict(ny=2, nx=8)
    s = _setup(ne, scattering=scattering, recombination=recombination, phonons=phonons, seed=11,
               **grid)
    tables = collisions_cuda.build_kernel_tables(s["plan"])
    assert isinstance(tables, ColumnTables) == (ne > 16)  # beyond the register bucket: K5's walk
    if ne <= 16:  # the simple form: 16 bins, both channels, every group on a row of its own
        assert tables.simple == (ne == 16 and scattering and recombination)
    g = np.random.default_rng(2).uniform(0, 1e-6, s["q"].shape[1:]) if gen else None
    q1, p1 = _port(s, s["q"], s["ph"], g)
    q2, p2 = _walk(s, s["q"], s["ph"], g)
    np.testing.assert_allclose(q2, q1, rtol=1e-12, atol=1e-30)
    np.testing.assert_allclose(p2, p1, rtol=1e-12, atol=1e-30)
    # and, through the plain version, the JAX package's XLA integrator
    q_in = s["q"] + (0.0 if g is None else g[None])  # the XLA step takes dt·g added
    q3, p3 = (np.asarray(a) for a in _xla_step(s, phonons)(jnp.asarray(q_in), jnp.asarray(s["ph"])))
    np.testing.assert_allclose(q2, q3, rtol=1e-12, atol=1e-30)
    np.testing.assert_allclose(p2, p3, rtol=1e-12, atol=1e-30)


@pytest.mark.parametrize("ne,bins", [(10, 16), (11, 16), (16, 16), (33, 33)])
def test_pair_walk_covers_every_pair_once(ne, bins):
    """Every unordered pair lands once, in a group of its diagonal whose ω row
    is the pair's ``idx_diff`` / ``idx_sum``; the constants are the plain
    version's, bit for bit (in the kernel's 16-bin walk).  NE 11 and 33
    split diagonals into two groups; NE 33 (a walk wider than the
    kernel's) also puts a difference and a sum on one ω row, which two
    groups then reach."""
    s = _setup(ne, ny=1, nx=2)
    plan, pm = s["plan"], s["pm"]
    walk = collisions_cuda.pair_walk(plan, bins)
    tables = collisions_cuda.build_kernel_tables(plan) if bins == collisions_cuda.WALK_BINS else None
    ks, kr = (plan.dE * plan.K_s0)[0].numpy(), (2.0 * plan.dE * plan.K_r0)[0].numpy()
    groups_of_row = np.zeros(plan.num_omega, int)
    for kind, ptr, meta, pairs, n_diag, consts in (
        ("s", walk.s_ptr, walk.s_meta, walk.s_pairs, bins, tables and tables.scat[0].numpy()),
        ("r", walk.r_ptr, walk.r_meta, walk.r_pairs, 2 * bins - 1, tables and tables.rec[0].numpy()),
    ):
        seen = []
        assert ptr[0] == 0 and ptr[-1] == len(meta) and len(ptr) == n_diag + 1
        for d in range(n_diag):
            length = bins - d if kind == "s" else d // 2 + 1 - max(0, d - bins + 1)
            for g in range(ptr[d], ptr[d + 1]):
                row, first = meta[g]
                groups_of_row[row] += 1
                for e, (i, j) in enumerate(pairs[first: first + length], first):
                    if i < 0:
                        if tables:
                            np.testing.assert_array_equal(consts[e], 0.0)
                        continue
                    assert (i - j if kind == "s" else i + j) == d and i < ne
                    assert (pm.idx_diff if kind == "s" else pm.idx_sum)[i, j] == row
                    table = ks if kind == "s" else kr
                    if tables:  # the constants the kernel reads, the plain version's
                        np.testing.assert_array_equal(consts[e], [table[i, j], table[j, i]])
                    seen.append((int(i), int(j)))
        lower = [(i, j) for i in range(ne) for j in range(i if kind == "s" else i + 1)]
        assert sorted(seen) == lower  # each pair once
    assert (len(walk.s_meta) > ne - 1) == (ne in (11, 33))  # split diagonals: two groups each
    assert (groups_of_row.max() > 1) == (ne == 33)  # rows two groups reach
    if tables:
        np.testing.assert_array_equal(tables.rows.numpy(), np.concatenate([walk.s_meta[:, 0], walk.r_meta[:, 0]]))


def test_main_path_walk_takes_the_simple_form():
    """At 16 bins on the main path's grid each diagonal is one group, its
    constants where the kernel's simple form reads them (``kScatOff``,
    ``kRecOff``); with ρ ahead of them in a gap's constants."""
    s = _setup(16, ny=1, nx=2)
    t = collisions_cuda.build_kernel_tables(s["plan"])
    assert t.simple
    assert (t.nb, len(t.s_meta) // 2, len(t.r_meta) // 2) == (16, 15, 31)
    assert (t.scat_off, t.rec_off, t.consts.shape) == (16, 16 + 2 * 120, (1, 16 + 2 * 120 + 2 * 136))
    np.testing.assert_array_equal(t.rho.numpy()[0], s["rho"])


@pytest.mark.parametrize("emax", [5.0, 9.0])
def test_groups_that_share_an_omega_row_take_the_general_form(emax):
    """At 16 bins with 2·E_min/dE whole (E_max = 5Δ, 9Δ) a difference and a
    sum land on one ω row while each diagonal stays one group.  The simple
    form sets a row's rates from its one group, so the tables ask for the
    general form, which adds both groups' sums into the shared row."""
    s = _setup(16, seed=7, emax=emax)
    t = collisions_cuda.build_kernel_tables(s["plan"])
    rows = t.rows.numpy()
    assert (len(t.s_meta) // 2, len(t.r_meta) // 2) == (15, 31)  # one group per diagonal
    assert len(np.unique(rows)) < len(rows)  # rows two groups reach
    assert not t.simple
    g = np.random.default_rng(8).uniform(0, 1e-6, s["q"].shape[1:])
    q1, p1 = _port(s, s["q"], s["ph"], g)
    q2, p2 = _walk(s, s["q"], s["ph"], g)
    np.testing.assert_allclose(q2, q1, rtol=1e-12, atol=1e-30)
    np.testing.assert_allclose(p2, p1, rtol=1e-12, atol=1e-30)
    q_in = s["q"] + g[None]
    q3, p3 = (np.asarray(a) for a in _xla_step(s, True)(jnp.asarray(q_in), jnp.asarray(s["ph"])))
    np.testing.assert_allclose(q2, q3, rtol=1e-12, atol=1e-30)
    np.testing.assert_allclose(p2, p3, rtol=1e-12, atol=1e-30)


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


def _plan_fields(plan) -> dict:
    from dataclasses import fields

    return {f.name: getattr(plan, f.name) for f in fields(plan)}


@pytest.mark.parametrize("gaps", [1, 3], ids=["uniform", "gap_ids"])
def test_plan_takes_the_jax_keyword_names(gaps):
    """``build_collision_plan_arrays`` called as the JAX package's is
    (``rho_by_gap``, ``K_r0_by_gap``, ``K_s0_by_gap``, ``gap_id``; no
    ``device``/``dtype``, which default to "cuda" — here the CPU — and the
    device's float type) builds the plan the port's names build."""
    from qpsim_tpu_torch.ops.collisions import build_collision_plan_arrays

    s = _setup(8, seed=6)
    g = np.linspace(170.0, 180.0, gaps)
    rho = np.stack([dynes_density_of_states(s["E"], x, 0.0) for x in g])
    kr = np.stack([recombination_kernel_base(s["E"], x, 520.0, 1.2) for x in g])
    ks = np.stack([scattering_kernel_base(s["E"], x, 440.0, 1.2) for x in g])
    gid = np.random.default_rng(2).integers(0, gaps, (4, 32)).astype(np.int32)
    common = dict(dE=s["dE"], gap_id=gid, pmap=s["pm"], enable_recombination=True, enable_scattering=True,
                  update_phonons=True, pixel_chunk=64)
    jax_form = build_collision_plan_arrays(rho_by_gap=rho, K_r0_by_gap=kr, K_s0_by_gap=ks, device="cpu", **common)
    port_form = build_collision_plan_arrays(rho=rho, K_r0=kr, K_s0=ks, device="cpu", dtype=torch.float64,
                                            **common)
    a, b = _plan_fields(jax_form), _plan_fields(port_form)
    assert a.keys() == b.keys()
    for name in a:
        if isinstance(a[name], torch.Tensor):
            assert a[name].dtype == b[name].dtype and a[name].device == b[name].device, name
            assert torch.equal(a[name], b[name]), name
        elif isinstance(a[name], np.ndarray):
            np.testing.assert_array_equal(a[name], b[name])
        else:
            assert a[name] == b[name], name
    assert a["rho"].dtype == torch.float64 and (a["gap_id"] is None) == (gaps == 1)
    # the JAX call of __graft_entry__.entry() on the CPU, float32 asked
    f32 = build_collision_plan_arrays(rho_by_gap=rho, K_r0_by_gap=kr, K_s0_by_gap=ks, device="cpu",
                                      dtype=torch.float32, **common)
    assert f32.rho.dtype == f32.K_s0.dtype == torch.float32


def test_plan_refuses_both_spellings_of_one_table():
    from qpsim_tpu_torch.ops.collisions import build_collision_plan_arrays

    s = _setup(6, seed=7)
    common = dict(dE=s["dE"], K_r0=s["Kr"], K_s0=s["Ks"], pmap=s["pm"], enable_recombination=True,
                  enable_scattering=True, update_phonons=True, device="cpu")
    with pytest.raises(TypeError, match="'rho'.*'rho_by_gap'"):
        build_collision_plan_arrays(rho=s["rho"], rho_by_gap=s["rho"][None], **common)
    kw = dict(common, K_s0=None)
    with pytest.raises(TypeError, match="'K_r0'.*'K_r0_by_gap'"):
        build_collision_plan_arrays(rho=s["rho"], K_r0_by_gap=s["Kr"][None], **kw)
    with pytest.raises(TypeError, match="unexpected keyword argument 'rho_by_pixel'"):
        build_collision_plan_arrays(rho=s["rho"], rho_by_pixel=s["rho"], **common)
    with pytest.raises(TypeError, match="needs 'rho'"):
        build_collision_plan_arrays(**common)
