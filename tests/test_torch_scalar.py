"""The port's scalar ``run_2d_crank_nicolson`` (energy_gap <= 0) against ``qpsim_tpu``'s.

Float64 on the CPU: the same geometry and initial field go through both
packages, and times, frames (rtol 1e-10), mass (rtol 1e-12), color limits
and the fixed-temperature phonon scaffold must agree.  The port's CPU run
takes every kernel's plain version; one case swaps the separable CUDA
backend (K1's plain version on CPU tensors) into the runner.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import qpsim_tpu as J  # noqa: E402
from qpsim_tpu.geometry.mask import create_intrinsic_geometry, extract_edge_segments, mask_from_lists  # noqa: E402
from qpsim_tpu.models.params import BoundaryCondition  # noqa: E402

import qpsim_tpu_torch as T  # noqa: E402
from qpsim_tpu_torch.ops import adi_cuda, adi_sep_cuda, tridiag_cuda  # noqa: E402
from qpsim_tpu_torch.solver import diffusion_backends as tdb  # noqa: E402
from qpsim_tpu_torch.solver import scalar_runner  # noqa: E402

_MIXED = [("absorbing", None, None), ("reflective", None, None), ("robin", 0.3, 0.1),
          ("dirichlet", 0.2, None), ("neumann", 0.1, None)]


def _geometry(kind):
    if kind == "dense":  # 16 x 24 interior cells: dense spectral CN on both sides
        geo = create_intrinsic_geometry(width=32, height=24)
        mask, edges = mask_from_lists(geo.mask), geo.edges
    elif kind == "film":  # a full 72 x 72 film: 5184 cells, ADI on both sides
        mask = np.ones((72, 72), dtype=bool)
        edges = extract_edge_segments(mask)
    else:  # a 96² donut: ≈ 4.7 k cells, two boundary rings
        yy, xx = np.mgrid[0:96, 0:96] - 47.5
        r = np.hypot(yy, xx)
        mask = (r < 0.45 * 96) & (r > 0.2 * 96)
        edges = extract_edge_segments(mask)
    bcs = {}
    for i, e in enumerate(edges):
        kind_, value, aux = _MIXED[i % len(_MIXED)] if kind != "dense" else ("reflective", None, None)
        bcs[e.edge_id] = BoundaryCondition(kind=kind_, value=value, aux_value=aux)
    return mask, edges, bcs


def _kwargs(kind, **extra):
    mask, edges, bcs = _geometry(kind)
    init = np.zeros(mask.shape)
    init[mask] = 1e-5 * (1.0 + 0.5 * np.sin(np.arange(mask.sum()) * 0.1))
    kw = dict(
        mask=mask, edges=edges, edge_conditions=bcs, initial_field=init,
        diffusion_coefficient=6.0, dt=0.05, total_time=0.4, dx=1.0, store_every=3,
        energy_gap=0.0, bath_temperature=0.12,
    )
    kw.update(extra)
    return kw


def _assert_scalar_runs_match(a, b):
    times_a, frames_a, mass_a, clim_a, ef_a, eb_a = a
    times_b, frames_b, mass_b, clim_b, ef_b, eb_b = b
    assert times_b == times_a
    assert ef_a is ef_b is None and eb_a is eb_b is None
    np.testing.assert_allclose(mass_b, mass_a, rtol=1e-12, atol=0)
    assert len(frames_b) == len(frames_a)
    for fa, fb in zip(frames_a, frames_b):
        np.testing.assert_array_equal(np.isnan(fb), np.isnan(fa))
        np.testing.assert_allclose(np.nan_to_num(fb), np.nan_to_num(fa), rtol=1e-10, atol=1e-18)
    np.testing.assert_allclose(clim_b, clim_a, rtol=1e-10)


def _assert_scaffolds_match(ha, hb, n_frames):
    assert hb["phonon_metadata"] == ha["phonon_metadata"]
    assert hb["phonon_energy_frames"] is None and hb["phonon_energy_bins"] is None
    assert len(hb["phonon_frames"]) == len(ha["phonon_frames"]) == n_frames
    np.testing.assert_array_equal(hb["phonon_frames"][0], ha["phonon_frames"][0])
    # one read-only frame, aliased across every stored time
    assert all(f is hb["phonon_frames"][0] for f in hb["phonon_frames"])
    assert not hb["phonon_frames"][0].flags.writeable


_CASES = {
    "dense": dict(),
    "film": dict(),
    "donut": dict(),
    "no_diffusion": dict(enable_diffusion=False),
    "remainder": dict(total_time=0.43, store_every=4),
    "film_adi": dict(diffusion_backend="adi"),
    "donut_wang": dict(diffusion_backend="wang"),
    "film_cg": dict(diffusion_backend="cg"),
}


@pytest.mark.parametrize("case", list(_CASES))
def test_scalar_run_matches_qpsim_tpu(case):
    kind = case.split("_")[0] if case.split("_")[0] in ("dense", "film", "donut") else "film"
    kw = _kwargs(kind, **_CASES[case])
    ha, hb = {}, {}
    seen_a, seen_b = [], []
    a = J.run_2d_crank_nicolson(**kw, phonon_history_out=ha,
                                progress_callback=lambda t, f: seen_a.append(t))
    b = T.run_2d_crank_nicolson(**kw, phonon_history_out=hb, device="cpu",
                                progress_callback=lambda t, f: seen_b.append(t))
    _assert_scalar_runs_match(a, b)
    assert seen_b == seen_a == a[0]
    _assert_scaffolds_match(ha, hb, len(a[0]))
    if case == "remainder":  # 8 steps of 0.05 and one of 0.03, stored every 4 and at the end
        assert len(b[0]) == 4 and abs(b[0][-1] - 0.43) < 1e-12
    if case == "no_diffusion":
        for f in b[1]:
            np.testing.assert_array_equal(f, b[1][0])


def test_scalar_run_through_the_separable_kernel_path(monkeypatch):
    # the run the card takes on a full film (K1), here with K1's plain
    # version on CPU tensors, against the JAX package's plain ADI run
    made = []

    def cuda_backend(op, device, dtype, preference="auto", *, coupled=False):
        made.append(tdb.CudaADI(op, device, dtype, coupled=coupled))
        return made[-1]

    monkeypatch.setattr(scalar_runner, "choose_backend", cuda_backend)
    kw = _kwargs("film", total_time=0.43)
    before = (dict(adi_sep_cuda.LAUNCHES), dict(adi_cuda.LAUNCHES), dict(tridiag_cuda.LAUNCHES))
    b = T.run_2d_crank_nicolson(**kw, device="cpu")
    assert made and made[0].separable
    assert (dict(adi_sep_cuda.LAUNCHES), dict(adi_cuda.LAUNCHES), dict(tridiag_cuda.LAUNCHES)) == before
    _assert_scalar_runs_match(J.run_2d_crank_nicolson(**kw), b)


def test_scalar_mass_is_conserved_with_reflective_faces():
    mask = np.ones((40, 50), dtype=bool)
    edges = extract_edge_segments(mask)
    bcs = {e.edge_id: BoundaryCondition(kind="reflective") for e in edges}
    init = np.random.default_rng(0).uniform(0.0, 1e-5, mask.shape)
    _, frames, mass, _, _, _ = T.run_2d_crank_nicolson(
        mask=mask, edges=edges, edge_conditions=bcs, initial_field=init,
        diffusion_coefficient=6.0, dt=0.1, total_time=2.0, dx=1.0, store_every=5,
        energy_gap=0.0, device="cpu",
    )
    np.testing.assert_allclose(mass, mass[0], rtol=1e-13)
    assert np.nanmax(frames[-1]) < np.nanmax(frames[0])  # it diffused


def test_scalar_photon_drive_is_refused_as_in_qpsim_tpu():
    from qpsim_tpu_torch.models.params import PhotonDriveSpec

    kw = _kwargs("dense")
    with pytest.raises(ValueError, match="energy-resolved"):
        T.run_2d_crank_nicolson(
            **kw, device="cpu",
            photon_drive=PhotonDriveSpec(mode="photon", photon_energy=400.0, coupling=1.0),
        )
