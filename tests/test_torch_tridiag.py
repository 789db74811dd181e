"""The port's tridiagonal solvers, the Thomas kernel's plain version (K10), and the
Wang and CG diffusion backends against ``qpsim_tpu``, float64 on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from qpsim_tpu.geometry.mask import extract_edge_segments  # noqa: E402
from qpsim_tpu.models.params import BoundaryCondition  # noqa: E402
from qpsim_tpu.ops import tridiag as jt  # noqa: E402
from qpsim_tpu.ops.diffusion import build_directional_stencils, fold_diffusion  # noqa: E402
from qpsim_tpu.ops.pallas_tridiag import tridiag_solve_pallas  # noqa: E402
from qpsim_tpu.solver import diffusion_backends as jdb  # noqa: E402

from qpsim_tpu_torch.interop import split_operator_from_numpy  # noqa: E402
from qpsim_tpu_torch.ops import adi_cuda, tridiag_cuda  # noqa: E402
from qpsim_tpu_torch.ops import tridiag as tt  # noqa: E402
from qpsim_tpu_torch.solver import diffusion_backends as tdb  # noqa: E402

F64 = torch.float64
_KINDS = ["reflective", "absorbing", "dirichlet", "neumann", "robin"]


@pytest.fixture
def restore_solvers():
    yield
    jt.set_default_solver("auto")
    tt.set_default_solver("auto")


def _system(shape=(3, 37, 29), seed=3):
    """A diagonally dominant batch with decoupled intervals and masked identity rows."""
    rng = np.random.default_rng(seed)
    lo = rng.uniform(-0.3, -0.1, shape)
    hi = rng.uniform(-0.3, -0.1, shape)
    di = rng.uniform(2.0, 3.0, shape)
    rhs = rng.uniform(-1.0, 1.0, shape)
    lines = lambda a: a.reshape(-1, shape[-1])  # views, one row per line
    lines(lo)[::3, 11] = 0.0  # an interval boundary inside a line: both couplings cut
    lines(hi)[::3, 10] = 0.0
    lines(lo)[1::4, 20] = lines(hi)[1::4, 20] = 0.0  # a masked cell: an identity row
    lines(di)[1::4, 20] = 1.0
    lines(hi)[1::4, 19] = lines(lo)[1::4, 21] = 0.0
    return lo, di, hi, rhs


def _both(arrays):
    return [jnp.asarray(a) for a in arrays], [torch.as_tensor(a) for a in arrays]


@pytest.mark.parametrize("shape", [(3, 37, 29), (4, 130)])
def test_pcr_matches_jax(shape):
    j, t = _both(_system(shape))
    ref = np.asarray(jt.tridiag_solve_pcr(*j))
    np.testing.assert_allclose(tt.tridiag_solve_pcr(*t).numpy(), ref, rtol=1e-13, atol=1e-15)


@pytest.mark.parametrize("chunk", [8, 16, 128])
def test_wang_and_prefactored_wang_match_jax(chunk):
    j, t = _both(_system((3, 37, 45)))
    ref = np.asarray(jt.tridiag_solve_wang(*j, chunk=chunk))
    np.testing.assert_allclose(tt.tridiag_solve_wang(*t, chunk=chunk).numpy(), ref, rtol=1e-13, atol=1e-15)
    fac_j = jt.wang_factor(*j[:3], chunk=chunk)
    fac_t = tt.wang_factor(*t[:3], chunk=chunk)
    assert sorted(fac_t) == sorted(fac_j)
    for name in fac_j:
        np.testing.assert_allclose(fac_t[name].numpy(), np.asarray(fac_j[name]), rtol=1e-13, atol=1e-15)
    ref2 = np.asarray(jt.wang_apply(fac_j, j[3]))
    np.testing.assert_allclose(tt.wang_apply(fac_t, t[3]).numpy(), ref2, rtol=1e-13, atol=1e-15)
    np.testing.assert_allclose(ref2, ref, rtol=1e-12, atol=1e-14)


def test_wang_stages_match_jax():
    rng = np.random.default_rng(5)
    arrays = [rng.uniform(-0.2, -0.1, (8, 4, 3)), rng.uniform(2.0, 3.0, (8, 4, 3)),
              rng.uniform(-0.2, -0.1, (8, 4, 3)), rng.uniform(-1.0, 1.0, (8, 4, 3))]
    j, t = _both(arrays)
    for a, b in zip(jt.wang_eliminate(*j), tt.wang_eliminate(*t)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-13, atol=1e-15)
    C, A, D = jt.wang_eliminate(*j)
    Ct, At, Dt = tt.wang_eliminate(*t)
    ls_j, rs_j = jt.wang_interface_sweep(A[0], C[0], D[0], A[-1], C[-1], D[-1], 4)
    ls_t, rs_t = tt.wang_interface_sweep(At[0], Ct[0], Dt[0], At[-1], Ct[-1], Dt[-1], 4)
    for a, b in zip(ls_j + rs_j, ls_t + rs_t):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-13, atol=1e-15)


@pytest.mark.parametrize("name", ["auto", "thomas", "pcr", "wang"])
def test_default_solver_dispatch_matches_jax(name, restore_solvers):
    j, t = _both(_system((2, 30, 70)))
    jt.set_default_solver(name)
    tt.set_default_solver(name)
    assert tt.get_default_solver() == name
    ref = np.asarray(jt.tridiag_solve_along(-2, *j))
    got = tt.tridiag_solve_along(-2, *t)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-13, atol=1e-15)
    with pytest.raises(ValueError, match="Unknown tridiagonal solver"):
        tt.set_default_solver("cusparse")


@pytest.mark.parametrize("shape", [(3, 37, 29), (1000, 33)])
def test_thomas_plain_matches_pallas_interpret_and_launches_nothing(shape, restore_solvers):
    j, t = _both(_system(shape))
    ref = np.asarray(tridiag_solve_pallas(*j, interpret=True))
    before = dict(tridiag_cuda.LAUNCHES)
    np.testing.assert_allclose(tridiag_cuda.thomas_plain(*t).numpy(), ref, rtol=1e-13, atol=1e-15)
    np.testing.assert_array_equal(tridiag_cuda.thomas(*t).numpy(), tridiag_cuda.thomas_plain(*t).numpy())
    tt.set_default_solver("pallas")  # the JAX name: K10 under every tridiag_solve
    np.testing.assert_array_equal(tt.tridiag_solve(*t).numpy(), tridiag_cuda.thomas_plain(*t).numpy())
    assert tridiag_cuda.LAUNCHES == before
    with pytest.raises(ValueError, match="CUDA tensors"):
        tridiag_cuda.thomas(*(a.to("meta") for a in t))


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


_BACKEND_CASES = [(24, 70, 3, True, False), (40, 36, 2, False, True), (33, 21, 1, True, False)]


@pytest.mark.parametrize("ny,nx,nb,masked,variable_d", _BACKEND_CASES)
def test_prefactored_wang_backend_matches_jax(ny, nx, nb, masked, variable_d):
    op_j, op_t, u0 = _operator(ny, nx, nb, masked=masked, variable_d=variable_d)
    dt = 0.06
    ref = jdb.PrefactoredWangADI(op_j, dtype=jnp.float64).make_step(dt)
    got = tdb.PrefactoredWangADI(op_t, "cpu", F64).make_step(dt)
    a, b = jnp.asarray(u0), torch.as_tensor(u0)
    for _ in range(2):
        a, b = ref(a), got(b)
    np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-13, atol=1e-15)


@pytest.mark.parametrize("ny,nx,nb,masked,variable_d", _BACKEND_CASES)
def test_cg_backend_matches_jax(ny, nx, nb, masked, variable_d):
    op_j, op_t, u0 = _operator(ny, nx, nb, masked=masked, variable_d=variable_d, seed=1)
    dt = 0.06
    ref = jdb.CGDiffusion(op_j, dtype=jnp.float64).make_step(dt)
    got = tdb.CGDiffusion(op_t, "cpu", F64).make_step(dt)
    a, b = jnp.asarray(u0), torch.as_tensor(u0)
    for _ in range(2):
        a, b = ref(a), got(b)
    np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-10, atol=1e-14)
    # and CG is the unsplit CN step the dense backend takes exactly
    dense = tdb.DenseSpectralDiffusion(op_t, "cpu", F64).make_step(dt)
    np.testing.assert_allclose(dense(dense(torch.as_tensor(u0))).numpy(), b.numpy(), rtol=1e-10, atol=1e-13)


def test_cg_runs_no_iteration_on_a_converged_state():
    # a zero state is its own CN solution: no iteration runs on either side
    op_j, op_t, u0 = _operator(12, 14, 1, masked=False, variable_d=False)
    op_t.sx[:] = op_t.sy[:] = 0.0
    step = tdb.CGDiffusion(op_t, "cpu", F64).make_step(0.05)
    assert torch.equal(step(torch.zeros(1, 12, 14, dtype=F64)), torch.zeros(1, 12, 14, dtype=F64))


def test_adi_backend_follows_the_default_solver(restore_solvers):
    _, op_t, u0 = _operator(20, 26, 2, masked=True, variable_d=False, seed=4)
    planes = adi_cuda.AdiPlanes.from_operator(op_t, "cpu", F64)
    u = torch.as_tensor(u0)
    plain = adi_cuda.adi_step_plain(u, planes, 0.03)
    for name in ("pcr", "wang", "pallas"):
        tt.set_default_solver(name)
        got = tdb.ADIDiffusion(op_t, "cpu", F64).make_step(0.06)(u)
        np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=1e-12, atol=1e-15)
        # the kernel's plain version stays on Thomas whatever the default is
        np.testing.assert_array_equal(adi_cuda.adi_step_plain(u, planes, 0.03).numpy(), plain.numpy())
