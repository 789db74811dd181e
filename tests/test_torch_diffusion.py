"""The port's tridiagonal solve and diffusion backends against ``qpsim_tpu``.

Float64 on the CPU.  The ADI kernel's plain version (``ops.adi_cuda``) is
held against the JAX ``ADIDiffusion`` step and against the fused Pallas
ADI kernels in interpret mode (whose Wang partition orders the
eliminations differently, hence the looser tolerance there).
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
from qpsim_tpu.ops.tridiag import tridiag_solve as j_tridiag_solve  # noqa: E402
from qpsim_tpu.solver import diffusion_backends as jdb  # noqa: E402

from qpsim_tpu_torch.interop import split_operator_from_numpy  # noqa: E402
from qpsim_tpu_torch.ops import adi_cuda  # noqa: E402
from qpsim_tpu_torch.ops.tridiag import tridiag_solve, tridiag_solve_along  # noqa: E402
from qpsim_tpu_torch.solver import diffusion_backends as tdb  # noqa: E402

_KINDS = ["reflective", "absorbing", "dirichlet", "neumann", "robin"]
F64 = torch.float64


def _operator(ny, nx, nb, *, masked, variable_d, seed=0, dx=0.7):
    """A JAX SplitOperator with every BC kind, its port copy and a state."""
    rng = np.random.default_rng(seed)
    mask = np.ones((ny, nx), dtype=bool)
    if masked:
        mask[rng.random((ny, nx)) < 0.25] = False
        mask[0, :] = True
        mask[-1, :] = True
    edges = extract_edge_segments(mask)
    bcs = {}
    for i, e in enumerate(edges):
        kind = _KINDS[i % len(_KINDS)]
        bcs[e.edge_id] = BoundaryCondition(
            kind=kind,
            value=0.3 if kind in ("dirichlet", "neumann", "robin") else None,
            aux_value=0.1 if kind == "robin" else None,
        )
    D = rng.uniform(1.0, 3.0, (nb, ny, nx)) if variable_d else rng.uniform(1.0, 3.0, nb)
    op_j = fold_diffusion(*build_directional_stencils(mask, edges, bcs, dx), mask, dx, D)
    op_t = split_operator_from_numpy(**vars(op_j))
    u0 = rng.uniform(0.0, 1.0, (nb, ny, nx)) * mask[None]
    return op_j, op_t, u0


@pytest.mark.parametrize("axis", [-1, -2])
def test_thomas_matches_jax_tridiag(axis):
    rng = np.random.default_rng(3)
    shape = (3, 37, 29)
    lo = rng.uniform(-0.3, -0.1, shape)
    hi = rng.uniform(-0.3, -0.1, shape)
    di = rng.uniform(2.0, 3.0, shape)
    rhs = rng.uniform(-1.0, 1.0, shape)
    lo[:, 17, 11] = 0.0  # a decoupled interval boundary
    mv = lambda a: np.moveaxis(a, axis, -1)
    ref = np.moveaxis(
        np.asarray(j_tridiag_solve(*(jnp.asarray(mv(a)) for a in (lo, di, hi, rhs)))), -1, axis
    )
    got = tridiag_solve_along(axis, *(torch.as_tensor(a) for a in (lo, di, hi, rhs)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-13, atol=0)
    if axis == -1:
        np.testing.assert_array_equal(
            tridiag_solve(*(torch.as_tensor(a) for a in (lo, di, hi, rhs))).numpy(), got.numpy()
        )


_CASES = [
    (32, 64, 3, True, False),
    (64, 32, 3, True, True),
    (16, 16, 1, False, False),
    (24, 40, 3, False, True),
]


@pytest.mark.parametrize("ny,nx,nb,masked,variable_d", _CASES)
def test_adi_step_matches_jax_adi(ny, nx, nb, masked, variable_d):
    op_j, op_t, u0 = _operator(ny, nx, nb, masked=masked, variable_d=variable_d)
    dt = 0.05
    ref = np.asarray(jdb.ADIDiffusion(op_j, dtype=jnp.float64).make_step(dt)(jnp.asarray(u0)))
    got = tdb.ADIDiffusion(op_t, "cpu", F64).make_step(dt)(torch.as_tensor(u0))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-12, atol=0)


@pytest.mark.parametrize("ny,nx,nb,masked,variable_d", _CASES[:3])
def test_adi_plain_matches_fused_pallas_interpret(ny, nx, nb, masked, variable_d):
    op_j, op_t, u0 = _operator(ny, nx, nb, masked=masked, variable_d=variable_d, seed=1)
    dt = 0.05
    ref = np.asarray(
        build_pallas_adi_fused_step(op_j, dt, jnp.float64, interpret=True)(jnp.asarray(u0))
    )
    planes = adi_cuda.AdiPlanes.from_operator(op_t, "cpu", F64)
    got = adi_cuda.adi_step_plain(torch.as_tensor(u0), planes, 0.5 * dt)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-10, atol=0)


@pytest.mark.parametrize("masked,variable_d", [(True, False), (False, True)])
def test_dense_spectral_matches_jax_dense(masked, variable_d):
    op_j, op_t, u0 = _operator(12, 18, 3, masked=masked, variable_d=variable_d, seed=2)
    dt = 0.07
    ref = np.asarray(
        jdb.DenseSpectralDiffusion(op_j, dtype=jnp.float64).make_step(dt)(jnp.asarray(u0))
    )
    got = tdb.DenseSpectralDiffusion(op_t, "cpu", F64).make_step(dt)(torch.as_tensor(u0))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-12, atol=1e-15)


def test_kernel_wrappers_run_the_plain_version_on_cpu():
    _, op_t, u0 = _operator(20, 28, 3, masked=True, variable_d=False, seed=4)
    planes = adi_cuda.AdiPlanes.from_operator(op_t, "cpu", F64)
    u = torch.as_tensor(u0)
    before = dict(adi_cuda.LAUNCHES)
    half = adi_cuda.adi_x_half(u, planes, 0.025)
    np.testing.assert_array_equal(half.numpy(), adi_cuda.adi_x_half_plain(u, planes, 0.025).numpy())
    np.testing.assert_array_equal(
        adi_cuda.adi_step(u, planes, 0.025).numpy(),
        adi_cuda.adi_step_plain(u, planes, 0.025).numpy(),
    )
    assert adi_cuda.LAUNCHES == before  # nothing launched for CPU tensors
    step = tdb.CudaADI(op_t, "cpu", F64).make_step(0.05)
    np.testing.assert_array_equal(step(u).numpy(), adi_cuda.adi_step_plain(u, planes, 0.025).numpy())


def test_choose_backend_dispatch(monkeypatch):
    _, small, _ = _operator(16, 16, 2, masked=False, variable_d=False)
    _, big, _ = _operator(72, 72, 2, masked=False, variable_d=False)
    assert isinstance(tdb.choose_backend(small, "cpu", F64), tdb.DenseSpectralDiffusion)
    auto_big = tdb.choose_backend(big, "cpu", F64)
    assert type(auto_big) is tdb.ADIDiffusion  # plain ADI on the CPU, never the kernel
    assert isinstance(tdb.choose_backend(small, "cpu", F64, "adi"), tdb.ADIDiffusion)
    assert type(tdb.choose_backend(small, "cpu", F64, "wang")) is tdb.PrefactoredWangADI
    assert type(tdb.choose_backend(small, "cpu", F64, "cg")) is tdb.CGDiffusion
    assert type(tdb.choose_backend(big, "cpu", F64, coupled=True)) is tdb.ADIDiffusion
    with pytest.raises(ValueError, match="Unknown"):
        tdb.choose_backend(small, "cpu", F64, "kernel")
    # 'pallas', the JAX package's name, is the CUDA ADI backend and needs the card
    with pytest.raises(ValueError, match="CUDA"):
        tdb.choose_backend(small, "cpu", F64, "pallas")
    monkeypatch.setattr(tdb, "CudaADI", lambda op, device, dtype, coupled=False: ("CudaADI", device.type, coupled))
    assert tdb.choose_backend(small, "cuda", F64, "pallas", coupled=True) == ("CudaADI", "cuda", True)
