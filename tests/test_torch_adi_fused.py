"""The port's fused ADI step (K2, ``csrc/adi.cu``) against ``qpsim_tpu``, float64 on the CPU.

The kernel's blocking, transcribed in NumPy (``tests/adi_transcription.py``:
TL lines per block with a ragged last block, Wang chunks in the TPU
kernel's order, zero rows outside the grid, the two-pass form for long
lines, the last chunk padded with identity rows when the chunk count does
not divide the line), is held to 1e-12 against the port's plain halves on
every case and,
where ``build_pallas_adi_fused_step`` takes the shape, against that JAX step
in interpret mode.  The wrappers run the plain halves on CPU tensors and
launch nothing.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from qpsim_tpu.geometry.mask import extract_edge_segments  # noqa: E402
from qpsim_tpu.models.params import BoundaryCondition  # noqa: E402
from qpsim_tpu.ops.diffusion import build_directional_stencils, fold_diffusion  # noqa: E402
from qpsim_tpu.ops.pallas_adi import build_pallas_adi_fused_step  # noqa: E402

import adi_transcription as tr  # noqa: E402
from qpsim_tpu_torch.interop import split_operator_from_numpy  # noqa: E402
from qpsim_tpu_torch.ops import adi_cuda  # noqa: E402

F64 = torch.float64
ALPHA = 0.035
_KINDS = ["absorbing", "reflective", "robin", "dirichlet", "neumann"]


def _donut(n):
    yy, xx = np.mgrid[0:n, 0:n] - (n - 1) / 2.0
    r = np.hypot(yy, xx)
    return (r < 0.45 * n) & (r > 0.2 * n)


def _case(mask, nb, *, per_pixel=False, seed=0):
    """A JAX SplitOperator on ``mask`` with mixed faces, the port's planes and a state."""
    rng = np.random.default_rng(seed)
    edges = extract_edge_segments(mask)
    bcs = {}
    for i, e in enumerate(edges):
        kind = _KINDS[i % len(_KINDS)]
        bcs[e.edge_id] = BoundaryCondition(
            kind=kind, value=0.3 if kind in ("dirichlet", "neumann", "robin") else None,
            aux_value=0.1 if kind == "robin" else None,
        )
    ny, nx = mask.shape
    D = rng.uniform(1.0, 3.0, (nb, ny, nx) if per_pixel else nb)
    op_j = fold_diffusion(*build_directional_stencils(mask, edges, bcs, 0.7), mask, 0.7, D)
    planes = adi_cuda.AdiPlanes.from_operator(split_operator_from_numpy(**vars(op_j)), "cpu", F64)
    u = rng.uniform(0.0, 1.0, (nb, ny, nx)) * mask[None]
    return op_j, planes, u


def _arrays(planes):
    return [t.numpy() for t in (planes.ax_lo, planes.ax_hi, planes.ax_diag, planes.ay_lo,
                                planes.ay_hi, planes.ay_diag, planes.src, planes.scale)]


def _close(got, ref):
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12 * np.abs(ref).max())


# (mask, bins, per-pixel D, x-half TL, y-half TL, chunks held at once,
# chunk count launched: None for pick_chunks)
CASES = {
    "rectangle": (np.ones((48, 64), bool), 3, False, 4, 8, None, None),
    "donut": (_donut(64), 2, False, 8, 8, None, None),         # zero coupling rows
    "nb_planes": (np.ones((40, 48), bool), 2, True, 8, 8, None, None),
    "ragged_tiles": (np.ones((36, 40), bool), 2, False, 8, 16, None, None),
    "k1_rows": (np.ones((20, 61), bool), 1, False, 4, 8, None, None),  # x: K = 1, y: K = 2
    # x: 301 cells take 32 chunks of 10, the last with 19 identity rows; y: K = 1
    "padded_32": (np.ones((12, 301), bool), 1, False, 4, 8, None, None),
    "two_pass": (np.ones((64, 64), bool), 1, False, 2, 8, 2, None),    # W = 2 of K = 8
    # K = 4 on lines of 301 and 37: M = 76 and 10, the last chunk padded
    # with 3 identity rows, in two passes of W = 2
    "padded_chunks": (np.ones((37, 301), bool), 2, False, 4, 8, 2, 4),
}


@pytest.mark.parametrize("name", list(CASES))
def test_kernel_transcription_matches_plain_halves(name):
    mask, nb, per_pixel, tl_x, tl_y, w, k = CASES[name]
    _, planes, u = _case(mask, nb, per_pixel=per_pixel)
    ut = torch.as_tensor(u)
    kx, ky = tr.pick_chunks(mask.shape[1]), tr.pick_chunks(mask.shape[0])
    assert kx < 32 and ky < 32  # fewer than 32 chunks asked for
    got_x = tr.fused_half(u, _arrays(planes), ALPHA, "x", tl=tl_x, w=w, k=k)
    _close(got_x, adi_cuda.adi_x_half_plain(ut, planes, ALPHA).numpy())
    got_y = tr.fused_half(u, _arrays(planes), ALPHA, "y", tl=tl_y, w=w, k=k)
    _close(got_y, adi_cuda.adi_y_half_plain(ut, planes, ALPHA).numpy())
    assert not np.isnan(got_x).any() and not np.isnan(got_y).any()


@pytest.mark.parametrize(
    "mask,nb,per_pixel",
    [(np.ones((24, 32), bool), 2, False), (_donut(32), 2, False), (np.ones((24, 32), bool), 2, True)],
    ids=["rectangle", "donut", "nb_planes"],
)
def test_kernel_transcription_step_matches_jax_fused_interpret(mask, nb, per_pixel):
    tl_x, tl_y = 4, 8
    op_j, planes, u = _case(mask, nb, per_pixel=per_pixel, seed=1)
    dt = 2 * ALPHA
    ref = np.asarray(build_pallas_adi_fused_step(op_j, dt, jnp.float64, interpret=True)(jnp.asarray(u)))
    half = tr.fused_half(u, _arrays(planes), ALPHA, "x", tl=tl_x)
    got = tr.fused_half(half, _arrays(planes), ALPHA, "y", tl=tl_y)
    _close(got, ref)


def test_wrappers_run_the_plain_halves_on_cpu_and_launch_nothing():
    _, planes, u = _case(_donut(32), 2)
    ut = torch.as_tensor(u)
    before = dict(adi_cuda.LAUNCHES)
    np.testing.assert_array_equal(adi_cuda.adi_x_half(ut, planes, ALPHA).numpy(),
                                  adi_cuda.adi_x_half_plain(ut, planes, ALPHA).numpy())
    np.testing.assert_array_equal(adi_cuda.adi_step(ut, planes, ALPHA).numpy(),
                                  adi_cuda.adi_step_plain(ut, planes, ALPHA).numpy())
    assert dict(adi_cuda.LAUNCHES) == before
    with pytest.raises(ValueError, match="CUDA tensors"):
        adi_cuda.adi_y_half(ut.to("meta"), planes, ALPHA)
