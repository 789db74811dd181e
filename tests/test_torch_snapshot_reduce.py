"""The light snapshot's reductions (``ops.snapshot_reduce_cuda``) on the CPU.

The kernel's frames rest on one premise: the runner's host interior
``q[:, mask]`` has each pixel's planes together in memory, and numpy sums
such an array along axis 0 in its pairwise order, which the kernel walks
plane by plane (``pairwise_planes`` is its plain transcription).  The
premise is held here for plane counts across numpy's block sizes and the
benchmark's cells (pixels cut); the plain version, which the wrapper runs
on CPU tensors, is held to the runner's host reduction (``light_on_host``):
frames bit for bit, sums to 1e-14.  The wrapper refuses what the kernel
does not take, on any device.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from qpsim_tpu_torch.ops.snapshot_reduce_cuda import pairwise_planes, snapshot_reduce, snapshot_reduce_plain
from qpsim_tpu_torch.solver.spectral_runner import light_on_host


def _holed_film(ny=40, nx=56):
    """A film with a margin, a round hole and a notch cut from one edge."""
    yy, xx = np.mgrid[0:ny, 0:nx]
    mask = np.zeros((ny, nx), dtype=bool)
    mask[3:-3, 4:-4] = True
    mask[(yy - ny / 2) ** 2 + (xx - nx / 3) ** 2 < 36] = False
    mask[3:12, 40:44] = False
    return mask


def _state(ne, nw, mask, dtype, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.uniform(0.0, 2e-5, (ne, *mask.shape)).astype(dtype)
    ph = rng.uniform(0.0, 3e-2, (nw, *mask.shape)).astype(dtype)
    q[:, ~mask] = np.nan  # nothing outside the mask may reach a sum
    widths = rng.uniform(1.0, 20.0, nw)
    return q, ph, widths


@pytest.mark.parametrize("planes", [1, 5, 8, 16, 47, 100, 128, 129, 299, 300, 899])
def test_numpy_sums_the_hosts_interior_in_pairwise_order(planes):
    rng = np.random.default_rng(planes)
    mask = _holed_film(30, 41)
    state = rng.uniform(0.0, 1e-5, (planes, *mask.shape)).astype(np.float32)
    x = state.astype(np.float64)[:, mask]  # as light_on_host forms it
    assert x.flags.f_contiguous and (planes == 1 or not x.flags.c_contiguous)
    w = rng.uniform(0.5, 20.0, planes)
    assert np.array_equal(np.sum(x, axis=0), 0.0 + pairwise_planes(torch.as_tensor(x)).numpy())
    assert np.array_equal(np.sum(x * w[:, None], axis=0),
                          0.0 + pairwise_planes(torch.as_tensor(x * w[:, None])).numpy())
    if planes >= 8:  # and not plane after plane, as numpy sums a C-ordered array
        wacc = w[0] * x[0]
        for i in range(1, planes):
            wacc = wacc + w[i] * x[i]
        assert np.array_equal(np.sum(np.ascontiguousarray(x * w[:, None]), axis=0), wacc)
        assert not np.array_equal(np.sum(x * w[:, None], axis=0), wacc)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("phonons", [True, False])
def test_plain_reduction_gives_the_host_reductions_frames(dtype, phonons):
    mask = _holed_film()
    q, ph, widths = _state(16, 47, mask, dtype)
    dE = 33.75
    host = light_on_host(q, ph if phonons else None, mask, dE, widths)
    got = snapshot_reduce(torch.as_tensor(q), torch.as_tensor(ph) if phonons else None,
                          torch.as_tensor(mask), torch.as_tensor(widths) if phonons else None, dE)
    got = [None if g is None else g.numpy() for g in got]
    assert got[0].dtype == np.float64
    assert np.array_equal(got[0][mask], host[0][mask])
    assert not np.any(got[0][~mask])
    np.testing.assert_allclose(got[1], host[1], rtol=1e-14)
    mass, host_mass = np.sum(got[1]) * dE, np.sum(host[1]) * dE
    np.testing.assert_allclose(mass, host_mass, rtol=1e-14)
    if phonons:
        assert np.array_equal(got[2][mask], host[2][mask])
        assert not np.any(got[2][~mask])
        np.testing.assert_allclose(got[3], host[3], rtol=1e-14)
    else:
        assert got[2] is None and got[3] is None and host[2] is None


def test_plain_reduction_is_the_plain_version_on_the_cpu():
    mask = _holed_film(12, 10)
    q, ph, widths = (torch.as_tensor(a) for a in _state(5, 9, mask, np.float64, seed=3))
    m = torch.as_tensor(mask)
    for a, b in zip(snapshot_reduce(q, ph, m, widths, 2.0), snapshot_reduce_plain(q, ph, m, widths, 2.0),
                    strict=True):
        assert torch.equal(a, b)
    # a uint8 mask reads as the bool one
    assert torch.equal(snapshot_reduce(q, None, m.to(torch.uint8), None, 2.0)[0],
                       snapshot_reduce(q, None, m, None, 2.0)[0])


def test_the_wrapper_refuses_what_the_kernel_does_not_take():
    mask = torch.as_tensor(_holed_film(12, 10))
    q, ph, widths = (torch.as_tensor(a) for a in _state(5, 9, mask.numpy(), np.float64, seed=3))
    with pytest.raises(TypeError, match="float32 or float64"):
        snapshot_reduce(q.to(torch.float16), None, mask, None, 1.0)
    with pytest.raises(ValueError, match="mask"):
        snapshot_reduce(q, None, mask[:, :-1], None, 1.0)
    with pytest.raises(ValueError, match="phonon state"):
        snapshot_reduce(q, ph.float(), mask, widths, 1.0)
    with pytest.raises(ValueError, match="widths"):
        snapshot_reduce(q, ph, mask, None, 1.0)
    with pytest.raises(ValueError, match="widths"):
        snapshot_reduce(q, ph, mask, widths[:-1], 1.0)
    with pytest.raises(ValueError, match="contiguous"):
        snapshot_reduce(q.transpose(1, 2), None, mask.T, None, 1.0)
    with pytest.raises(RuntimeError, match="no backward"):
        snapshot_reduce(q.clone().requires_grad_(), None, mask, None, 1.0)
