"""The port's ``run_2d_crank_nicolson`` against ``qpsim_tpu``'s, float64 on the CPU.

Both packages get the same geometry, initial field and physics; the port
runs with ``device="cpu"`` (every kernel's plain version).  Parity tests
pin ``strang_mode`` on both sides.  Also covered: the Pauli policy and its
messages, the features this port defers (they must raise), and the
interop helpers.  Gap maps are in ``test_torch_gap_maps.py``.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import qpsim_tpu as J  # noqa: E402
from qpsim_tpu.geometry.mask import create_intrinsic_geometry, extract_edge_segments, mask_from_lists  # noqa: E402
from qpsim_tpu.models.params import BoundaryCondition, ExternalGenerationSpec  # noqa: E402
from qpsim_tpu.ops.diffusion import build_directional_stencils, fold_diffusion  # noqa: E402

import qpsim_tpu_torch as T  # noqa: E402
from qpsim_tpu_torch.interop import split_operator_from_numpy, state_to_numpy, state_to_torch  # noqa: E402
from qpsim_tpu_torch.models import params as tp  # noqa: E402
from qpsim_tpu_torch.ops import adi_cuda, collisions_cuda  # noqa: E402
from qpsim_tpu_torch.ops import diffusion as t_diffusion  # noqa: E402


def _grid(kind):
    if kind == "dense":  # 16 x 24 interior cells: dense spectral CN on both sides
        geo = create_intrinsic_geometry(width=32, height=24)
        mask, edges = mask_from_lists(geo.mask), geo.edges
    else:  # a full 72 x 72 grid: 5184 cells, ADI on both sides
        mask = np.ones((72, 72), dtype=bool)
        edges = extract_edge_segments(mask)
    bcs = {e.edge_id: BoundaryCondition(kind="reflective") for e in edges}
    return mask, edges, bcs


def _gen(mode, pkg):
    cls = ExternalGenerationSpec if pkg == "jax" else tp.ExternalGenerationSpec
    if mode == "none":
        return None
    if mode == "constant":
        return cls(mode="constant", rate=3e-6)
    return cls(mode="pulse", pulse_start=0.1, pulse_duration=0.2, pulse_rate=2e-5)


def _common(grid, **extra):
    mask, edges, bcs = _grid(grid)
    init = np.zeros(mask.shape)
    init[mask] = 1e-5 * (1.0 + 0.5 * np.sin(np.arange(mask.sum()) * 0.1))
    kw = dict(
        mask=mask, edges=edges, edge_conditions=bcs, initial_field=init,
        diffusion_coefficient=6.0, dt=0.05, total_time=0.42, dx=1.0, store_every=3,
        energy_gap=180.0, energy_max_factor=4.0, num_energy_bins=6,
        enable_recombination=True, enable_scattering=True, bath_temperature=0.1,
    )
    kw.update(extra)
    return kw


def _assert_runs_match(a, b):
    times_a, frames_a, mass_a, clim_a, ef_a, eb_a = a
    times_b, frames_b, mass_b, clim_b, ef_b, eb_b = b
    assert times_b == times_a
    np.testing.assert_allclose(mass_b, mass_a, rtol=1e-12, atol=0)
    assert len(frames_b) == len(frames_a)
    for fa, fb in zip(frames_a, frames_b):
        np.testing.assert_array_equal(np.isnan(fb), np.isnan(fa))
        np.testing.assert_allclose(np.nan_to_num(fb), np.nan_to_num(fa), rtol=1e-10, atol=1e-18)
    if ef_a is None:
        assert ef_b is None
    else:
        for row_a, row_b in zip(ef_a, ef_b):
            for fa, fb in zip(row_a, row_b):
                np.testing.assert_allclose(np.nan_to_num(fb), np.nan_to_num(fa), rtol=1e-10, atol=1e-18)
    np.testing.assert_allclose(clim_b, clim_a, rtol=1e-10)
    np.testing.assert_array_equal(eb_b, eb_a)


@pytest.mark.parametrize(
    "grid,strang_mode,gen",
    [
        ("dense", "exact", "pulse"),
        ("dense", "merged", "constant"),
        ("dense", "merged", "none"),
        ("adi", "exact", "constant"),
        ("adi", "merged", "pulse"),
        ("adi", "exact", "none"),
    ],
)
def test_engine_matches_qpsim_tpu(grid, strang_mode, gen):
    # 8 steps of 0.05 plus a 0.02 remainder step, stored every 3 steps and at the end
    kw = _common(grid, strang_mode=strang_mode)
    a = J.run_2d_crank_nicolson(**kw, external_generation=_gen(gen, "jax"))
    b = T.run_2d_crank_nicolson(**kw, external_generation=_gen(gen, "torch"), device="cpu")
    _assert_runs_match(a, b)
    assert len(b[0]) == 4 and abs(b[0][-1] - 0.42) < 1e-12  # the tail of 2 is not stored


def test_engine_matches_pallas_collision_kernel_with_fused_generation():
    # the JAX run fuses dt·g into the Pallas kernel (interpret mode); the
    # port adds the same plane inside its collision step
    mask = np.ones((1, 6), dtype=bool)
    edges = extract_edge_segments(mask)
    bcs = {e.edge_id: BoundaryCondition(kind="reflective") for e in edges}
    kw = dict(
        mask=mask, edges=edges, edge_conditions=bcs, initial_field=np.full(mask.shape, 1e-5),
        diffusion_coefficient=6.0, dt=0.05, total_time=0.2, dx=1.0, energy_gap=180.0,
        num_energy_bins=6, energy_max_factor=3.0, enable_recombination=True,
        enable_scattering=True, bath_temperature=0.2, strang_mode="merged", store_every=2,
    )
    spec = dict(mode="pulse", pulse_start=0.05, pulse_duration=0.1, pulse_rate=4e-5)
    a = J.run_2d_crank_nicolson(
        **kw, collision_backend="pallas", external_generation=ExternalGenerationSpec(**spec)
    )
    b = T.run_2d_crank_nicolson(
        **kw, external_generation=tp.ExternalGenerationSpec(**spec), device="cpu"
    )
    _assert_runs_match(a, b)


def test_integrated_snapshots_and_phonon_history_match():
    kw = _common("dense", strang_mode="merged", total_time=0.3, store_every=2)
    ha, hb = {}, {}
    seen_a, seen_b = [], []
    a = J.run_2d_crank_nicolson(
        **kw, snapshot_detail="integrated", phonon_history_out=ha,
        progress_callback=lambda t, f: seen_a.append(t),
    )
    b = T.run_2d_crank_nicolson(
        **kw, snapshot_detail="integrated", phonon_history_out=hb,
        progress_callback=lambda t, f: seen_b.append(t), device="cpu",
    )
    _assert_runs_match(a, b)
    assert seen_b == seen_a == a[0]
    assert hb["phonon_metadata"] == ha["phonon_metadata"]
    np.testing.assert_array_equal(hb["phonon_energy_bins"], ha["phonon_energy_bins"])
    for fa, fb in zip(ha["phonon_frames"], hb["phonon_frames"]):
        np.testing.assert_allclose(np.nan_to_num(fb), np.nan_to_num(fa), rtol=1e-10, atol=1e-18)
    # full detail also records the per-ω phonon frames
    ha, hb = {}, {}
    J.run_2d_crank_nicolson(**kw, phonon_history_out=ha)
    T.run_2d_crank_nicolson(**kw, phonon_history_out=hb, device="cpu")
    for row_a, row_b in zip(ha["phonon_energy_frames"], hb["phonon_energy_frames"]):
        for fa, fb in zip(row_a, row_b):
            np.testing.assert_allclose(np.nan_to_num(fb), np.nan_to_num(fa), rtol=1e-10, atol=1e-18)


def _pauli_kwargs(**extra):
    mask = np.ones((1, 4), dtype=bool)
    edges = extract_edge_segments(mask)
    bcs = {e.edge_id: BoundaryCondition(kind="reflective") for e in edges}
    kw = dict(
        mask=mask, edges=edges, edge_conditions=bcs, initial_field=np.full(mask.shape, 1e9),
        diffusion_coefficient=1.0, dt=0.05, total_time=0.1, dx=1.0, energy_gap=180.0,
        num_energy_bins=4, energy_max_factor=3.0, enable_scattering=True, bath_temperature=0.1,
    )
    kw.update(extra)
    return kw


def _error_of(fn, **kw):
    with pytest.raises(ValueError) as exc:
        fn(**kw)
    return str(exc.value)


def test_pauli_error_and_warning_messages_match():
    kw = _pauli_kwargs()
    msg_a = _error_of(J.run_2d_crank_nicolson, **kw)
    msg_b = _error_of(T.run_2d_crank_nicolson, **kw, device="cpu")
    assert msg_b == msg_a and "Pauli occupation exceeded" in msg_b
    with warnings.catch_warnings(record=True) as wa:
        warnings.simplefilter("always")
        J.run_2d_crank_nicolson(**kw, enforce_pauli=False)
    with warnings.catch_warnings(record=True) as wb:
        warnings.simplefilter("always")
        T.run_2d_crank_nicolson(**kw, enforce_pauli=False, device="cpu")
    pick = lambda ws: [str(w.message) for w in ws if issubclass(w.category, UserWarning)]
    assert pick(wb) == pick(wa) and len(pick(wb)) == 1


def test_pauli_violation_mid_run_reports_the_same_step():
    # generation pushes f past the threshold a few steps in: the error comes
    # out of the segment drain with the step number and time of the JAX run
    kw = _pauli_kwargs(
        initial_field=np.full((1, 4), 1e-5), total_time=1.0, store_every=3,
        pauli_error_threshold=0.02, strang_mode="merged",
    )
    msg_a = _error_of(J.run_2d_crank_nicolson, **kw,
                      external_generation=ExternalGenerationSpec(mode="constant", rate=5e-2))
    msg_b = _error_of(T.run_2d_crank_nicolson, **kw, device="cpu",
                      external_generation=tp.ExternalGenerationSpec(mode="constant", rate=5e-2))
    assert msg_b == msg_a
    assert "step=0," not in msg_b


_DEFERRED = [
    dict(mesh=object()),
    dict(checkpointer=object()),
    dict(frame_sink=object()),
]


@pytest.mark.parametrize("extra", _DEFERRED, ids=["mesh", "checkpointer", "frame_sink"])
def test_deferred_features_raise(extra):
    kw = _pauli_kwargs(initial_field=np.full((1, 4), 1e-5))
    kw.update(extra)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        T.run_2d_crank_nicolson(**kw, device="cpu")


def test_no_quiet_cpu_and_no_kernel_on_cpu():
    kw = _pauli_kwargs(initial_field=np.full((1, 4), 1e-5))
    # the kernel paths, by the port's and the JAX package's names, raise on the CPU
    for name in ("kernel", "pallas"):
        with pytest.raises(ValueError, match="CUDA"):
            T.run_2d_crank_nicolson(**kw, collision_backend=name, device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        T.run_2d_crank_nicolson(**kw, diffusion_backend="pallas", device="cpu")
    for kind in ("collision", "diffusion"):
        with pytest.raises(ValueError, match=f"Unknown {kind} backend"):
            T.run_2d_crank_nicolson(**kw, **{f"{kind}_backend": "mosaic"}, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            T.run_2d_crank_nicolson(**kw)  # the default device is "cuda"
    # the CPU run launches no kernel and agrees with the explicit plain path,
    # also under the JAX package's name for it ('xla')
    before = (dict(collisions_cuda.LAUNCHES), dict(adi_cuda.LAUNCHES))
    a = T.run_2d_crank_nicolson(**kw, device="cpu")
    b = T.run_2d_crank_nicolson(**kw, device="cpu", collision_backend="plain")
    c = T.run_2d_crank_nicolson(**kw, device="cpu", collision_backend="xla")
    assert (dict(collisions_cuda.LAUNCHES), dict(adi_cuda.LAUNCHES)) == before
    _assert_runs_match(a, b)
    _assert_runs_match(c, b)


def test_interop_round_trip():
    rng = np.random.default_rng(0)
    q, ph = rng.uniform(size=(5, 3, 4)), rng.uniform(size=(13, 3, 4))
    qt, pt = state_to_torch(q, ph, "cpu", torch.float64)
    assert qt.dtype == torch.float64 and tuple(pt.shape) == (13, 3, 4)
    q2, p2 = state_to_numpy(qt, pt)
    np.testing.assert_array_equal(q2, q)
    np.testing.assert_array_equal(p2, ph)
    qf, _ = state_to_numpy(*state_to_torch(q, ph, "cpu", torch.float32))
    np.testing.assert_array_equal(qf, q.astype(np.float32).astype(np.float64))
    # a JAX-built operator carries over field for field
    mask = np.ones((6, 9), dtype=bool)
    mask[2:4, 3:6] = False
    edges = extract_edge_segments(mask)
    bcs = {e.edge_id: BoundaryCondition(kind="absorbing") for e in edges}
    op_j = fold_diffusion(*build_directional_stencils(mask, edges, bcs, 0.5), mask, 0.5, np.array([1.0, 2.0]))
    op_t = split_operator_from_numpy(**vars(op_j))
    own = t_diffusion.fold_diffusion(
        *t_diffusion.build_directional_stencils(mask, edges, bcs, 0.5), mask, 0.5, np.array([1.0, 2.0])
    )
    for f in ("ax_lo", "ax_hi", "ax_diag", "sx", "ay_lo", "ay_hi", "ay_diag", "sy", "mask", "bin_scale"):
        np.testing.assert_array_equal(getattr(op_t, f), getattr(op_j, f))
        np.testing.assert_array_equal(getattr(own, f), getattr(op_t, f))
    assert jnp.asarray(op_t.ax_lo).dtype == jnp.float64
