"""The one-direction line solve (K7) and the unfused ADI step against ``qpsim_tpu``.

Float64 on the CPU, where ``solve_lines`` and the step of ``build_adi_step``
run their plain versions (the port's Thomas and Wang solves):

* ``solve_lines`` against ``solve_lines_pallas`` in interpret mode, with a
  decoupled interval inside a chunk, Thomas (chunks 1) and the Wang
  partition (auto, K = 4), one shared plane and NB planes (atol 1e-11, as
  ``tests/test_pallas_adi.py`` holds it);
* ``build_adi_step`` against ``build_pallas_adi_step`` on the four
  operators of ``tests/test_pallas_adi.py`` (atol 1e-12);
* the CUDA kernel's blocking, chunked sweeps and interface recurrence
  (``csrc/adi_lines.cu`` on ``csrc/adi_staged.cuh``) through the NumPy
  transcription ``tests/adi_transcription.py``, with a padded last chunk;
* the wrappers on the CPU launch nothing; the module imports no JAX.
"""

import ast
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from qpsim_tpu.geometry.mask import extract_edge_segments  # noqa: E402
from qpsim_tpu.models.params import BoundaryCondition  # noqa: E402
from qpsim_tpu.ops.diffusion import build_directional_stencils, fold_diffusion  # noqa: E402
from qpsim_tpu.ops.pallas_adi import _pick_chunks, build_pallas_adi_step, solve_lines_pallas  # noqa: E402

import adi_transcription as tr  # noqa: E402
import qpsim_tpu_torch as T  # noqa: E402
from qpsim_tpu_torch.interop import split_operator_from_numpy  # noqa: E402
from qpsim_tpu_torch.ops import adi_cuda  # noqa: E402
from qpsim_tpu_torch.ops.adi_cuda import (  # noqa: E402
    build_adi_step,
    build_adi_step_plain,
    solve_lines,
    solve_lines_plain,
)

_KINDS = ["reflective", "absorbing", "dirichlet", "neumann", "robin"]


def _lines(nb=3, n=48, batch=40, nbp=None, seed=3):
    """Diagonally dominant lines with a decoupled interval boundary inside a chunk."""
    rng = np.random.default_rng(seed)
    nbp = nb if nbp is None else nbp
    lo = rng.uniform(-0.3, -0.1, (nbp, n, batch))
    hi = rng.uniform(-0.3, -0.1, (nbp, n, batch))
    di = rng.uniform(2.0, 3.0, (nbp, n, batch))
    lo[:, 0] = 0.0
    hi[:, -1] = 0.0
    lo[:, 17] = 0.0
    hi[:, 16] = 0.0
    rhs = rng.uniform(-1.0, 1.0, (nb, n, batch))
    scale = rng.uniform(1.0, 1.5, nb)
    return rhs, lo, di, hi, scale


@pytest.mark.parametrize("chunks", [1, None], ids=["thomas", "wang_auto"])
@pytest.mark.parametrize("nbp", [3, 1], ids=["nb_planes", "one_plane"])
def test_solve_lines_matches_solve_lines_pallas(chunks, nbp):
    rhs, lo, di, hi, scale = _lines(nbp=nbp)
    alpha = 1.0
    want = solve_lines_pallas(*(jnp.asarray(a) for a in (rhs, lo, di, hi, scale)), alpha=alpha,
                              chunks=chunks, interpret=True)
    got = solve_lines(*(torch.as_tensor(a) for a in (rhs, lo, di, hi, scale)), alpha=alpha, chunks=chunks)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-11)
    assert _pick_chunks(48) == 4  # the auto case is the Wang partition


def test_solve_lines_rejects_chunks_that_do_not_divide():
    rhs, lo, di, hi, scale = (torch.as_tensor(a) for a in _lines())
    with pytest.raises(ValueError, match="do not divide"):
        solve_lines(rhs, lo, di, hi, scale, alpha=1.0, chunks=5)


def _random_operator(ny, nx, nb, *, masked, variable_d, seed=0, dx=0.7):
    """``tests/test_pallas_adi.py``'s operators: random masks, every BC kind, D per bin or per pixel."""
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
    op = fold_diffusion(*build_directional_stencils(mask, edges, bcs, dx), mask, dx, D)
    u0 = rng.uniform(0.0, 1.0, (nb, ny, nx)) * mask[None]
    return op, u0


@pytest.mark.parametrize(
    "ny,nx,nb,masked,variable_d",
    [(32, 64, 3, True, False), (64, 32, 2, True, True), (16, 16, 1, False, False), (56, 40, 2, True, False)],
)
def test_adi_step_matches_pallas_adi_step(ny, nx, nb, masked, variable_d):
    op, u0 = _random_operator(ny, nx, nb, masked=masked, variable_d=variable_d)
    dt = 0.05
    want = build_pallas_adi_step(op, dt, jnp.float64, interpret=True)(jnp.asarray(u0))
    top = split_operator_from_numpy(**vars(op))
    got = build_adi_step(top, dt, torch.float64, device="cpu")(torch.as_tensor(u0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-12)
    plain = build_adi_step_plain(top, dt, torch.float64, device="cpu")(torch.as_tensor(u0))
    np.testing.assert_array_equal(plain.numpy(), got.numpy())


def test_adi_step_agrees_with_the_fused_step():
    # the same splitting and systems as K2's step (adi_step), to roundoff
    op, u0 = _random_operator(32, 64, 3, masked=True, variable_d=False, seed=2)
    top = split_operator_from_numpy(**vars(op))
    dt = 0.05
    got = build_adi_step(top, dt, torch.float64, device="cpu")(torch.as_tensor(u0))
    planes = adi_cuda.AdiPlanes.from_operator(top, "cpu", torch.float64)
    want = adi_cuda.adi_step_plain(torch.as_tensor(u0), planes, 0.5 * dt)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-12)


# ---------------------------------------------------------------- the CUDA kernel's sweeps


@pytest.mark.parametrize("k,nbp", [(1, 3), (4, 3), (4, 1), (16, 1), (48, 3)])
def test_kernel_sweeps_reproduce_the_plain_version(k, nbp):
    # the kernel's blocking (tests/adi_transcription.py): TL adjacent lines a
    # block (40 lines: a ragged last block at TL = 16), and at K = 16 four
    # chunks held at a time, in two passes
    rhs, lo, di, hi, scale = _lines(nbp=nbp, seed=k)
    tl = 16 if k <= 16 else 4
    got = tr.lines_solve(rhs, lo, di, hi, scale, 0.8, k, tl=tl, w=4 if k == 16 else None)
    want = solve_lines_plain(*(torch.as_tensor(a) for a in (rhs, lo, di, hi, scale)), alpha=0.8, chunks=k)
    np.testing.assert_allclose(got, want.numpy(), rtol=0, atol=1e-13)


def test_kernel_sweeps_with_a_padded_last_chunk_reproduce_thomas():
    # the K the kernel raises where one chunk does not fit in shared memory
    # need not divide N: 5 chunks of 10 rows on N = 48, two identity rows
    rhs, lo, di, hi, scale = _lines(nbp=3, seed=9)
    got = tr.lines_solve(rhs, lo, di, hi, scale, 0.8, 5, tl=8)
    want = solve_lines_plain(*(torch.as_tensor(a) for a in (rhs, lo, di, hi, scale)), alpha=0.8, chunks=1)
    np.testing.assert_allclose(got, want.numpy(), rtol=0, atol=1e-13)


def test_wrappers_run_plain_on_cpu_and_launch_nothing():
    before = dict(adi_cuda.LAUNCHES)
    args = [torch.as_tensor(a) for a in _lines()]
    a = solve_lines(*args, alpha=0.5)
    np.testing.assert_array_equal(a.numpy(), solve_lines_plain(*args, alpha=0.5).numpy())
    op, u0 = _random_operator(16, 16, 2, masked=True, variable_d=True, seed=5)
    build_adi_step(split_operator_from_numpy(**vars(op)), 0.05, torch.float64, device="cpu")(
        torch.as_tensor(u0))
    assert adi_cuda.LAUNCHES == before and before["adi_lines"] == 0


def test_adi_cuda_imports_no_jax():
    port = Path(T.__file__).resolve().parent
    path = port / "ops" / "adi_cuda.py"
    assert path in set(port.rglob("*.py"))  # the files tests/test_torch_host_layer.py scans
    tree = ast.parse(path.read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module or "" for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.level == 0]
    assert not [m for m in names if m.split(".")[0] in ("jax", "jaxlib", "qpsim_tpu")]
    assert (port / "csrc" / "adi_lines.cu").is_file()
