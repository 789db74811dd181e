"""The port's separable ADI step (K1) against ``qpsim_tpu``, float64 on the CPU.

The host side (stencil vectors, chunk choice, Wang prefactorization) is
pinned bit-equal to the JAX package's; the kernel's plain version is held
against ``build_pallas_adi_sep_step`` in interpret mode over three steps,
at the JAX package's own tolerance (``tests/test_pallas_adi_sep.py``);
the kernel's blocking, transcribed in NumPy (``tests/adi_transcription.py``),
is held to 1e-12 against the plain halves and the JAX step; and the
dispatch of ``CudaADI`` between K1 and K2 is checked without launching
anything.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from qpsim_tpu.geometry.mask import extract_edge_segments  # noqa: E402
from qpsim_tpu.models.params import BoundaryCondition  # noqa: E402
from qpsim_tpu.ops.diffusion import build_directional_stencils, fold_diffusion  # noqa: E402
from qpsim_tpu.ops import pallas_adi, pallas_adi_sep  # noqa: E402

import adi_transcription as tr  # noqa: E402
import qpsim_tpu_torch as T  # noqa: E402
from qpsim_tpu_torch.geometry.mask import extract_edge_segments as t_edges  # noqa: E402
from qpsim_tpu_torch.interop import split_operator_from_numpy  # noqa: E402
from qpsim_tpu_torch.models.params import BoundaryCondition as TBC  # noqa: E402
from qpsim_tpu_torch.ops import adi_cuda, adi_sep, adi_sep_cuda  # noqa: E402
from qpsim_tpu_torch.ops import diffusion as t_diffusion  # noqa: E402
from qpsim_tpu_torch.solver import diffusion_backends as tdb  # noqa: E402
from qpsim_tpu_torch.solver import program_build  # noqa: E402

F64 = torch.float64
_FACE_KINDS = ["dirichlet", "neumann", "robin", "reflective"]


def _rect_operator(ny, nx, D=2.3, *, dx=0.6, hole=False):
    """A JAX SplitOperator on a full rectangle with mixed faces, and its port copy."""
    mask = np.ones((ny, nx), dtype=bool)
    if hole:
        mask[ny // 3: ny // 2, nx // 3: nx // 2] = False
    edges = extract_edge_segments(mask)
    bcs = {}
    for i, e in enumerate(edges):
        kind = _FACE_KINDS[i % len(_FACE_KINDS)]
        bcs[e.edge_id] = BoundaryCondition(
            kind=kind,
            value=0.4 if kind in ("dirichlet", "neumann", "robin") else None,
            aux_value=0.2 if kind == "robin" else None,
        )
    op_j = fold_diffusion(*build_directional_stencils(mask, edges, bcs, dx), mask, dx, D)
    return op_j, split_operator_from_numpy(**vars(op_j))


@pytest.mark.parametrize("ny,nx,D", [(32, 64, 2.3), (64, 32, np.array([1.0, 2.0, 3.0])), (24, 40, 1.7)])
def test_stencil_vectors_and_prefactor_bit_equal_to_jax(ny, nx, D):
    op_j, op_t = _rect_operator(ny, nx, D)
    vj = pallas_adi_sep.separable_stencil_vectors(op_j)
    vt = adi_sep.separable_stencil_vectors(op_t)
    for dj, dt_ in zip(vj, vt):
        for a, b in zip(dj, dt_):
            np.testing.assert_array_equal(b, a)
    (xlo, xhi, xdiag, _), _ = vt
    a_s = 0.025 * 1.7
    k = adi_sep.pick_chunks(nx)
    pack_j, ifc_j = pallas_adi_sep._wang_prefactor_1d(-a_s * xlo, 1.0 - a_s * xdiag, -a_s * xhi, k)
    pack_t, ifc_t = adi_sep._wang_prefactor_1d(-a_s * xlo, 1.0 - a_s * xdiag, -a_s * xhi, k)
    np.testing.assert_array_equal(pack_t, pack_j)
    np.testing.assert_array_equal(ifc_t, ifc_j)
    # a hole, or a spatially varying D, is not separable on either side
    for op_j2, op_t2 in (_rect_operator(ny, nx, hole=True),
                         _rect_operator(ny, nx, np.full((2, ny, nx), 1.5))):
        assert pallas_adi_sep.separable_stencil_vectors(op_j2) is None
        assert adi_sep.separable_stencil_vectors(op_t2) is None


def test_pick_chunks_equals_jax():
    for n in range(1, 2100):
        assert adi_sep.pick_chunks(n) == pallas_adi._pick_chunks(n), n


@pytest.mark.parametrize("ny,nx,D", [(32, 64, 2.3), (64, 32, np.array([1.0, 2.0, 3.0]))],
                         ids=["nb1", "nb3"])
def test_plain_step_matches_pallas_sep_interpret(ny, nx, D):
    op_j, op_t = _rect_operator(ny, nx, D)
    nb = op_t.num_bins
    u0 = np.random.default_rng(ny + nx).uniform(0.0, 1.0, (nb, ny, nx))
    dt = 0.05
    jstep = pallas_adi_sep.build_pallas_adi_sep_step(op_j, dt, jnp.float64, interpret=True)
    factors = adi_sep.SepFactors.build(op_t, dt, "cpu", F64)
    assert factors.facx.shape == (nb, 5, nx // adi_sep.pick_chunks(nx), adi_sep.pick_chunks(nx))
    assert factors.ify.shape == (nb, adi_sep.pick_chunks(ny), 6)
    ref, got = jnp.asarray(u0), torch.as_tensor(u0)
    for _ in range(3):  # sources and BC couplings accumulate
        ref, got = jstep(ref), adi_sep_cuda.adi_sep_step_plain(got, factors)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-12)


def test_sep_step_matches_plain_adi_and_wrappers_launch_nothing_on_cpu():
    _, op_t = _rect_operator(48, 40, 2.5)
    u = torch.as_tensor(np.random.default_rng(1).uniform(0.0, 1.0, (1, 48, 40)))
    factors = adi_sep.SepFactors.build(op_t, 0.04, "cpu", F64)
    before = dict(adi_sep_cuda.LAUNCHES), dict(adi_cuda.LAUNCHES)
    half = adi_sep_cuda.adi_sep_x(u, factors)
    np.testing.assert_array_equal(half.numpy(), adi_sep_cuda.adi_sep_x_half_plain(u, factors).numpy())
    np.testing.assert_array_equal(
        adi_sep_cuda.adi_sep_y(half, factors).numpy(),
        adi_sep_cuda.adi_sep_y_half_plain(half, factors).numpy(),
    )
    sep = adi_sep_cuda.adi_sep_step(u, factors)
    cuda_adi = tdb.CudaADI(op_t, "cpu", F64)
    assert cuda_adi.separable
    np.testing.assert_array_equal(cuda_adi.make_step(0.04)(u).numpy(), sep.numpy())
    assert (dict(adi_sep_cuda.LAUNCHES), dict(adi_cuda.LAUNCHES)) == before
    # the same splitting as plain ADI, with the eliminations reordered
    planes = adi_cuda.AdiPlanes.from_operator(op_t, "cpu", F64)
    ref = adi_cuda.adi_step_plain(u, planes, 0.02)
    np.testing.assert_allclose(sep.numpy(), ref.numpy(), rtol=1e-12, atol=1e-14)
    # the launch path checks its input before it touches a device
    with pytest.raises(ValueError, match="state must be"):
        adi_sep_cuda._launch("x", u[:, :8], factors)
    with pytest.raises(ValueError, match="CUDA tensors"):
        adi_sep_cuda.adi_sep_y(u.to("meta"), factors)


# (Ny, Nx, D, x-half TL, y-half TL, chunks held at once)
KERNEL_CASES = {
    "nb1": (32, 64, 2.3, 2, 8, None),
    "ragged_tiles_nb3": (36, 64, np.array([1.0, 2.0, 3.0]), 8, 8, None),  # 36 rows, TL 8
    "short_chunks": (64, 32, 1.7, 4, 16, None),  # K = 4 along x (M = 8), 8 along y
    "two_pass": (64, 64, np.array([1.5, 2.5]), 4, 8, 2),  # W = 2 of K = 8
    "one_chunk_a_wave": (40, 48, 2.0, 8, 8, 1),  # W = 1: K waves of one chunk (odd M = 5)
}


@pytest.mark.parametrize("name", list(KERNEL_CASES))
def test_kernel_transcription_matches_plain_halves_and_jax(name):
    ny, nx, D, tl_x, tl_y, w = KERNEL_CASES[name]
    op_j, op_t = _rect_operator(ny, nx, D)
    nb = op_t.num_bins
    u0 = np.random.default_rng(ny * nx).uniform(0.0, 1.0, (nb, ny, nx))
    dt = 0.05
    f = adi_sep.SepFactors.build(op_t, dt, "cpu", F64)
    assert max(f.facx.shape[3], f.facy.shape[3]) < 32
    vec = lambda t: t.numpy()
    half = tr.sep_half(u0, vec(f.xv), vec(f.yv), vec(f.facx), vec(f.ifx), "x", tl=tl_x, w=w)
    ref = adi_sep_cuda.adi_sep_x_half_plain(torch.as_tensor(u0), f).numpy()
    np.testing.assert_allclose(half, ref, rtol=0, atol=1e-12 * np.abs(ref).max())
    got = tr.sep_half(half, vec(f.xv), vec(f.yv), vec(f.facy), vec(f.ify), "y", tl=tl_y, w=w)
    ref = adi_sep_cuda.adi_sep_y_half_plain(torch.as_tensor(half), f).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12 * np.abs(ref).max())
    if name in ("nb1", "two_pass"):  # the shapes the JAX builder tiles
        jstep = pallas_adi_sep.build_pallas_adi_sep_step(op_j, dt, jnp.float64, interpret=True)
        np.testing.assert_allclose(got, np.asarray(jstep(jnp.asarray(u0))), rtol=0, atol=1e-12)


def _own_operator(ny, nx, D, *, hole=False):
    """An operator built by the port's own host layer (reflective faces)."""
    mask = np.ones((ny, nx), dtype=bool)
    if hole:
        mask[1:3, 1:3] = False
    edges = t_edges(mask)
    bcs = {e.edge_id: TBC(kind="reflective") for e in edges}
    return t_diffusion.fold_diffusion(
        *t_diffusion.build_directional_stencils(mask, edges, bcs, 1.0), mask, 1.0, D
    )


@pytest.mark.parametrize(
    "ny,nx,D,coupled,expect",
    [
        (64, 64, 6.0, False, True),                     # scalar film
        (64, 64, 6.0, True, True),                      # NB = 1 ignores coupling
        (64, 64, np.array([1.0, 2.0]), False, False),   # NB > 1 below 512
        (512, 512, np.array([1.0, 2.0]), False, True),  # NB > 1 standalone at 512
        (512, 512, np.array([1.0, 2.0]), True, False),  # NB > 1 coupled
        (512, 256, np.array([1.0, 2.0]), False, False),  # one extent below 512
        (64, 67, 6.0, False, False),                    # 67 has no Wang chunks
        (16, 64, 6.0, False, True),                     # K = 2 on the short axis
        (64, 64, np.full((1, 64, 64), 6.0), False, False),  # per-pixel D: not lazy-scaled
    ],
)
def test_cuda_adi_dispatch(ny, nx, D, coupled, expect):
    op = _own_operator(ny, nx, D)
    assert tdb._separable_applies(op, coupled) is expect
    if ny * nx <= 64 * 67:
        assert tdb.CudaADI(op, "cpu", F64, coupled=coupled).separable is expect


@pytest.mark.parametrize("nx,expect", [(32768, True), (32770, False)], ids=["m1024", "m16385"])
def test_cuda_adi_dispatch_sends_chunks_too_long_for_k1_to_k2(nx, expect):
    # 16 rows: K = 2 along y; 32768 = 32 chunks of 1024; 32770 = 2 × 16385:
    # one chunk above K1's SEPARABLE_MAX_CHUNK_ROWS, so K2 takes the film
    op = _own_operator(16, nx, 6.0)
    assert tdb._separable_applies(op, False) is expect


def test_non_separable_masked_film_takes_k2():
    op = _own_operator(64, 64, 6.0, hole=True)
    backend = tdb.CudaADI(op, "cpu", F64)
    assert not backend.separable
    u = torch.as_tensor(np.random.default_rng(2).uniform(size=(1, 64, 64)) * op.mask[None])
    planes = adi_cuda.AdiPlanes.from_operator(op, "cpu", F64)
    np.testing.assert_array_equal(
        backend.make_step(0.1)(u).numpy(), adi_cuda.adi_step_plain(u, planes, 0.05).numpy()
    )


def test_engine_passes_coupled_to_the_backend_choice(monkeypatch):
    seen = []

    def spy(op, device, dtype, preference="auto", *, coupled=False):
        seen.append(coupled)
        return tdb.choose_backend(op, device, dtype, preference, coupled=coupled)

    monkeypatch.setattr(program_build, "choose_backend", spy)
    mask = np.ones((1, 4), dtype=bool)
    edges = t_edges(mask)
    kw = dict(
        mask=mask, edges=edges, edge_conditions={e.edge_id: TBC(kind="reflective") for e in edges},
        initial_field=np.full(mask.shape, 1e-5), diffusion_coefficient=1.0, dt=0.05,
        total_time=0.1, dx=1.0, energy_gap=180.0, num_energy_bins=4, energy_max_factor=3.0,
        device="cpu",
    )
    T.run_2d_crank_nicolson(**kw)
    T.run_2d_crank_nicolson(**kw, enable_scattering=True)
    assert seen == [False, True]
