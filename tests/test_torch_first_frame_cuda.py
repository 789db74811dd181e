"""The first frame of an integrated-detail run on the card (``ops.snapshot_reduce_cuda``).

Needs an NVIDIA card: every test is marked ``cuda`` and skips without one.
On the card, where JAX need not be installed:
``python -m pytest --noconftest -m cuda tests/test_torch_first_frame_cuda.py``.

On a card the runner reduces the t = 0 state of a light run with the
snapshot kernel and copies only its results to the host.  Held here: the
kernel against the host reduction of the same state (frames bit for bit,
sums to 1e-13, the same bits on every launch); the engine's first light
frame against the first full frame, which the host reduces as before;
a light run resumed from checkpoints against the uninterrupted run; and
the bytes a call copies before its first segment against the count by hand.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from qpsim_tpu_torch import run_2d_crank_nicolson
from qpsim_tpu_torch.geometry.mask import extract_edge_segments
from qpsim_tpu_torch.io.checkpoint import SimulationCheckpointer
from qpsim_tpu_torch.models.params import BoundaryCondition, ExternalGenerationSpec
from qpsim_tpu_torch.ops.snapshot_reduce_cuda import snapshot_reduce
from qpsim_tpu_torch.solver.spectral_runner import light_on_host
from qpsim_tpu_torch.utils import profiling

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


def _holed_film(ny=72, nx=88):
    """A film with a margin, a round hole and a notch cut from one edge."""
    yy, xx = np.mgrid[0:ny, 0:nx]
    mask = np.zeros((ny, nx), dtype=bool)
    mask[4:-4, 4:-4] = True
    mask[(yy - ny / 2) ** 2 + (xx - nx / 3) ** 2 < 100] = False
    mask[4:20, 60:66] = False
    return mask


def _kwargs(ne, dtype, total_time=0.1, store_every=1):
    mask = _holed_film()
    edges = extract_edge_segments(mask)
    y, x = np.mgrid[0:mask.shape[0], 0:mask.shape[1]]
    field = 1e-5 * (1.0 + 30.0 * np.exp(-((x - 50.0) ** 2 + (y - 40.0) ** 2) / 60.0))
    return dict(
        mask=mask, edges=edges,
        edge_conditions={e.edge_id: BoundaryCondition(kind="reflective") for e in edges},
        initial_field=np.where(mask, field, 0.0), diffusion_coefficient=6.0, dt=0.05,
        total_time=total_time, dx=1.0, store_every=store_every, energy_gap=180.0,
        energy_max_factor=4.0, num_energy_bins=ne, enable_recombination=True,
        enable_scattering=True, bath_temperature=0.1,
        external_generation=ExternalGenerationSpec(mode="pulse", pulse_start=0.0, pulse_duration=1.0,
                                                   pulse_rate=1e-5),
        device="cuda", dtype=dtype,
    )


def _counted_run(**kw):
    """The call's results, its phonon history and the counters' change over it."""
    phonons: dict = {}
    before = profiling.counters()
    out = run_2d_crank_nicolson(**kw, phonon_history_out=phonons)
    after = profiling.counters()
    return out, phonons, {k: after[k] - before[k] for k in after}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("ne, nw, phonons", [(16, 47, True), (100, 299, True), (300, 899, False), (5, 13, True)])
def test_the_kernel_gives_the_host_reductions_frames(ne, nw, phonons, dtype):
    mask = _holed_film(61, 77)
    rng = np.random.default_rng(ne)
    q = torch.as_tensor(rng.uniform(0.0, 2e-5, (ne, *mask.shape)), dtype=dtype, device="cuda")
    ph = torch.as_tensor(rng.uniform(0.0, 3e-2, (nw, *mask.shape)), dtype=dtype, device="cuda")
    q[:, torch.as_tensor(~mask, device="cuda")] = float("nan")  # outside the mask reaches nothing
    widths = rng.uniform(1.0, 20.0, nw)
    args = (q, ph if phonons else None, torch.as_tensor(mask, device="cuda"),
            torch.as_tensor(widths, device="cuda") if phonons else None, 33.75)
    got = [None if g is None else g.cpu().numpy() for g in snapshot_reduce(*args)]
    again = [None if g is None else g.cpu().numpy() for g in snapshot_reduce(*args)]
    host = light_on_host(q.cpu().numpy(), ph.cpu().numpy() if phonons else None, mask, 33.75, widths)
    for a, b in zip(got, again, strict=True):
        assert (a is None and b is None) or a.tobytes() == b.tobytes()
    assert np.array_equal(got[0][mask], host[0][mask]) and not np.any(got[0][~mask])
    np.testing.assert_allclose(got[1], host[1], rtol=1e-13)
    np.testing.assert_allclose(np.sum(got[1]), np.sum(host[1]), rtol=1e-13)
    if phonons:
        assert np.array_equal(got[2][mask], host[2][mask]) and not np.any(got[2][~mask])
        np.testing.assert_allclose(got[3], host[3], rtol=1e-13)
    else:
        assert got[2] is None and got[3] is None


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("ne", [16, 100])
def test_the_first_light_frame_on_the_card_is_the_host_reduction(ne, dtype):
    light, light_ph, light_delta = _counted_run(**_kwargs(ne, dtype), snapshot_detail="integrated")
    full, full_ph, full_delta = _counted_run(**_kwargs(ne, dtype), snapshot_detail="full")
    assert (light_delta["first_frames_on_card"], light_delta["first_frames_on_host"]) == (1, 0)
    assert (full_delta["first_frames_on_card"], full_delta["first_frames_on_host"]) == (0, 1)
    assert np.array_equal(np.nan_to_num(light[1][0]), np.nan_to_num(full[1][0]))
    assert np.array_equal(np.isnan(light[1][0]), np.isnan(full[1][0]))
    assert np.array_equal(np.nan_to_num(light_ph["phonon_frames"][0]), np.nan_to_num(full_ph["phonon_frames"][0]))
    np.testing.assert_allclose(light[2][0], full[2][0], rtol=1e-13)


@pytest.mark.parametrize("ne", [16, 100])
def test_a_light_run_resumed_on_the_card_reproduces_the_uninterrupted_run(tmp_path, ne):
    kw = dict(_kwargs(ne, torch.float32, total_time=0.3, store_every=2), snapshot_detail="integrated")
    whole, whole_ph, _ = _counted_run(**kw)
    run_2d_crank_nicolson(**{**kw, "total_time": 0.15}, checkpointer=SimulationCheckpointer(tmp_path))
    resumed, resumed_ph, delta = _counted_run(**kw, checkpointer=SimulationCheckpointer(tmp_path))
    assert (delta["first_frames_on_card"], delta["first_frames_on_host"]) == (1, 0)
    assert resumed[0] == whole[0] and resumed[2] == whole[2] and resumed[3] == whole[3]
    for a, b in zip(resumed[1], whole[1], strict=True):
        assert np.array_equal(np.nan_to_num(a), np.nan_to_num(b))
    for a, b in zip(resumed_ph["phonon_frames"], whole_ph["phonon_frames"], strict=True):
        assert np.array_equal(np.nan_to_num(a), np.nan_to_num(b))


@pytest.mark.parametrize("phonons", [True, False])
def test_initial_copy_bytes_is_the_count_by_hand(phonons):
    kw = dict(_kwargs(16, torch.float32), snapshot_detail="integrated")
    before = profiling.counters()
    history: dict = {}
    run_2d_crank_nicolson(**kw, **({"phonon_history_out": history} if phonons else {}))
    initial = profiling.counters()["initial_copy_bytes"] - before["initial_copy_bytes"]
    ny, nx = kw["mask"].shape
    stats0 = 4 * 8  # the t = 0 Pauli statistics, four float64 values
    if phonons:
        nw = history["phonon_energy_bins"].size
        assert initial == stats0 + 2 * ny * nx * 8 + (16 + nw) * 8
    else:
        assert initial == stats0 + ny * nx * 8 + 16 * 8
