"""More than 256 energy bins: K5/K6's column walk in both launch forms, against ``qpsim_tpu``.

Float64 on the CPU, where the kernel wrappers run their plain versions:

* the dispatch (``collision_kernel_for``) names K5, K5 with gap ids and K6
  at every bin count beyond 64, and the launch form (``column_form``) is
  the staged one while q and partner of a 32-pixel tile fit a block's
  shared memory (908 bins in float32, 454 in float64), the device-memory
  one beyond — a pure function of the bin count and the dtype;
* the port's substep at NE = 257 and 300 — a uniform gap, G = 3 gap ids
  and a continuous gap map (the port's analytic form, where the JAX
  package takes per-gap stacks) — against the JAX package's
  ``make_collision_step``, the XLA gather integrator it runs beyond 256
  bins, at 1e-10;
* the device-memory form's walk (``tests/column_walk_transcription.py``,
  ``form="device"``: each block's tile in its own slice of a scratch
  buffer) against the plain version at NE = 258, which carries both of
  the column grouping's traps — a split ω diagonal and an ω row shared
  by a difference and a sum;
* one engine run through ``run_2d_crank_nicolson(device="cpu")`` against
  the JAX engine on a 4 × 6 film at 260 bins.
"""

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
from qpsim_tpu.ops.phonon_map import build_phonon_frequency_map  # noqa: E402

import qpsim_tpu_torch as T  # noqa: E402
from qpsim_tpu_torch.interop import (  # noqa: E402
    analytic_tables_from_numpy,
    collision_tables_from_numpy,
    state_to_numpy,
    state_to_torch,
)
from qpsim_tpu_torch.models import params as tp  # noqa: E402
from qpsim_tpu_torch.ops.collisions import collision_step_analytic_plain, collision_step_plain  # noqa: E402
from qpsim_tpu_torch.ops.collisions_blocked_cuda import (  # noqa: E402
    build_column_tables,
    collision_kernel_for,
)
from qpsim_tpu_torch.ops.column_walk import (  # noqa: E402
    MAX_SHARED_BYTES,
    blocks_per_sm,
    column_bins,
    column_form,
    column_pixels,
)

from column_walk_transcription import transcribe  # noqa: E402

DT = 0.02
TAU_S, TAU_R, T_C = 440.0, 520.0, 1.2


def _scaled(got, want) -> float:
    return float(np.max(np.abs(np.asarray(got) - np.asarray(want)))) / float(np.max(np.abs(want)))


# ---------------------------------------------------------------- dispatch and form


@pytest.mark.parametrize("ne", [65, 256, 257, 453, 454, 455, 907, 908, 909, 1024])
def test_dispatch_and_launch_form_beyond_256(ne):
    assert collision_kernel_for(ne, 1) == "K5"
    assert collision_kernel_for(ne, 3) == "K5_gid"
    assert collision_kernel_for(ne, 9) == "K6"
    want = {torch.float32: "staged" if ne <= 908 else "device",
            torch.float64: "staged" if ne <= 454 else "device"}
    for dtype, form in want.items():
        assert column_form(dtype, ne) == form
        size = 4 if dtype == torch.float32 else 8
        assert (2 * ne * 32 * size <= MAX_SHARED_BYTES) == (form == "staged")
        # beyond 112 float32 bins (4 blocks per SM at P = 2), with gap ids or a
        # Δ² plane beyond 16 bins, or in float64 one pixel per lane
        two = dtype == torch.float32 and blocks_per_sm(2 * ne * 64 * size) >= 4
        assert column_pixels(dtype, ne, 1024 * 1024) == (2 if two else 1)
        assert column_pixels(dtype, ne, 1024 * 1024, uniform=False) == 1
        # bins per register block: 8 where the float32 staged tile leaves at
        # most 3 blocks per SM, else 4
        eight = dtype == torch.float32 and form == "staged" and blocks_per_sm(2 * ne * 32 * size) <= 3
        assert column_bins(dtype, ne, 1, form) == (8 if eight else 4)
        assert column_bins(dtype, ne, 2, form) == 4


# ---------------------------------------------------------------- the substep


def _grid(ne):
    E, dE = build_energy_grid(180.0, 1.0, 4.0, ne)
    return E, dE, build_phonon_frequency_map(E)


def _state(rng, rho_px, pm, shape):
    q = rng.uniform(0, 2e-3, (rho_px.shape[0], *shape)) * rho_px
    ph = thermal_phonon_occupation(pm.omega_bins, 0.25)[:, None, None] * rng.uniform(
        0.5, 2.0, (pm.num_omega, *shape))
    return q, ph


def _table_case(ne, gaps, shape, seed):
    """Per-gap tables: the port's plan and the JAX gather plan of the same physics."""
    E, dE, pm = _grid(ne)
    rng = np.random.default_rng(seed)
    gid = np.zeros(shape, np.int32) if len(gaps) == 1 else rng.integers(0, len(gaps), shape).astype(np.int32)
    rho = np.stack([dynes_density_of_states(E, g, 0.0) for g in gaps])
    Ks = np.stack([scattering_kernel_base(E, g, TAU_S, T_C) for g in gaps])
    Kr = np.stack([recombination_kernel_base(E, g, TAU_R, T_C) for g in gaps])
    plan = collision_tables_from_numpy(
        dE=dE, rho=rho, K_s0=Ks, K_r0=Kr, omega_bins=pm.omega_bins, idx_diff=pm.idx_diff,
        idx_sum=pm.idx_sum, diff_sign=pm.diff_sign, enable_scattering=True,
        enable_recombination=True, update_phonons=True, device="cpu", dtype=torch.float64,
        pixel_chunk=5, gap_id=None if len(gaps) == 1 else gid)
    jp = j_plan(dE=dE, rho_by_gap=rho, K_r0_by_gap=Kr, K_s0_by_gap=Ks, gap_id=gid, pmap=pm,
                enable_recombination=True, enable_scattering=True, update_phonons=True, pixel_chunk=5)
    q, ph = _state(rng, rho[gid].transpose(2, 0, 1), pm, shape)
    return plan, jp, q, ph, pm


@pytest.mark.parametrize("ne", [257, 300])
@pytest.mark.parametrize("form", ["uniform", "gap_ids", "continuous"])
def test_substep_beyond_256_matches_the_jax_gather_integrator(ne, form):
    shape = (2, 6)
    gen = np.random.default_rng(ne + 1).uniform(0, 1e-6, shape)
    if form == "continuous":
        # every pixel its own gap: the port's analytic (K6) form; the JAX
        # package takes per-gap stacks of the 12 unique gaps
        E, dE, pm = _grid(ne)
        rng = np.random.default_rng(ne)
        plane = rng.uniform(150.0, 175.0, shape)
        gaps, gid = np.unique(plane, return_inverse=True)
        assert collision_kernel_for(ne, gaps.size) == "K6"
        plan, tab = analytic_tables_from_numpy(
            E_bins=E, dE=dE, gap_plane=plane, omega_bins=pm.omega_bins, idx_diff=pm.idx_diff,
            idx_sum=pm.idx_sum, diff_sign=pm.diff_sign, tau_s=TAU_S, tau_r=TAU_R, T_c=T_C,
            dynes_gamma=0.0, update_phonons=True, device="cpu", dtype=torch.float64, pixel_chunk=5)
        rho = np.stack([dynes_density_of_states(E, g, 0.0) for g in gaps])
        jp = j_plan(dE=dE, rho_by_gap=rho,
                    K_r0_by_gap=np.stack([recombination_kernel_base(E, g, TAU_R, T_C) for g in gaps]),
                    K_s0_by_gap=np.stack([scattering_kernel_base(E, g, TAU_S, T_C) for g in gaps]),
                    gap_id=gid.reshape(shape).astype(np.int32), pmap=pm, enable_recombination=True,
                    enable_scattering=True, update_phonons=True, pixel_chunk=5)
        q, ph = _state(rng, rho[gid.reshape(shape)].transpose(2, 0, 1), pm, shape)
        step = lambda qt, pt, g: collision_step_analytic_plain(plan, tab, qt, pt, DT, g)
    else:
        gaps = (180.0,) if form == "uniform" else (150.0, 165.0, 180.0)
        plan, jp, q, ph, pm = _table_case(ne, gaps, shape, seed=ne)
        step = lambda qt, pt, g: collision_step_plain(plan, qt, pt, DT, g)
    qt, pt = state_to_torch(q, ph, "cpu", torch.float64)
    got = state_to_numpy(*step(qt, pt, torch.as_tensor(gen)))
    # the XLA step takes the dt·g plane already added
    want = [np.asarray(a) for a in make_collision_step(jp, DT)(jnp.asarray(q + gen[None]), jnp.asarray(ph))]
    assert _scaled(got[0], want[0]) <= 1e-10
    assert _scaled(got[1], want[1]) <= 1e-10


# ---------------------------------------------------------------- the device-memory form's walk


@pytest.mark.parametrize("ne", [258])
def test_device_memory_walk_reproduces_plain_version(ne):
    # 40 pixels: two tiles, the second ragged, each in its own scratch slice;
    # the first tile's gap ids agree (one table base), the second's are mixed
    plan, _, q, ph, pm = _table_case(ne, (150.0, 165.0, 180.0), (1, 40), seed=ne)
    gid = plan.gap_id.numpy()
    gid[:32] = 1
    tables = build_column_tables(plan)
    assert tables.n_scat > ne - 1 or tables.n_rec > 2 * ne - 1  # a split ω diagonal
    assert np.intersect1d(pm.idx_diff[pm.diff_sign != 0], pm.idx_sum).size > 0  # a shared ω row
    gen = np.random.default_rng(5).uniform(0, 1e-6, (1, 40))
    qt, pt = state_to_torch(q, ph, "cpu", torch.float64)
    want = state_to_numpy(*collision_step_plain(plan, qt, pt, DT, torch.as_tensor(gen)))
    got = transcribe(tables, q, ph, gen, DT, True, 1, form="device")
    np.testing.assert_allclose(got[0], want[0], rtol=1e-12, atol=1e-22)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-12, atol=1e-22)
    with pytest.raises(ValueError, match="device form runs at 2 pixels"):
        transcribe(tables, q, ph, gen, DT, True, 2, form="device")


# ---------------------------------------------------------------- the engine


def _film_kwargs(pkg):
    mask = np.ones((4, 6), dtype=bool)
    edges = extract_edge_segments(mask)
    bc = BoundaryCondition if pkg == "jax" else tp.BoundaryCondition
    init = np.zeros(mask.shape)
    init[:, :3] = 1e-5
    return dict(mask=mask, edges=edges, edge_conditions={e.edge_id: bc(kind="reflective") for e in edges},
                initial_field=init, diffusion_coefficient=6.0, dt=0.05, total_time=0.1, dx=1.0,
                energy_gap=180.0, num_energy_bins=260, energy_max_factor=4.0,
                enable_recombination=True, enable_scattering=True, bath_temperature=0.2,
                store_every=1)


@pytest.fixture(scope="module")
def engine_runs():
    jax_out = J.run_2d_crank_nicolson(**_film_kwargs("jax"))
    port_out = T.run_2d_crank_nicolson(**_film_kwargs("torch"), device="cpu")
    return jax_out, port_out


def test_engine_at_260_bins_matches_the_jax_engine(engine_runs):
    (ta, fa, ma, _, efa, ea), (tb, fb, mb, _, efb, eb) = engine_runs
    np.testing.assert_allclose(tb, ta, rtol=0, atol=1e-15)
    np.testing.assert_allclose(eb, ea, rtol=1e-15)
    np.testing.assert_allclose(mb, ma, rtol=1e-10)
    assert len(fb) == len(fa) == 3
    for a, b in zip(fa, fb):
        assert _scaled(b, a) <= 1e-10
    for a, b in zip(efa[-1], efb[-1]):
        assert _scaled(b, a) <= 1e-10
