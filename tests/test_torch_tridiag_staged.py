"""The tridiagonal kernel (K10) against ``qpsim_tpu``, float64 on the CPU.

The CUDA kernel (``csrc/tridiag.cu`` on the shared-memory line solve
``csrc/adi_staged.cuh``) cannot run here, so its blocking is held through
the NumPy transcription ``tests/adi_transcription.py`` (``tridiag_lines``):
rows and cols layouts, ragged last blocks, the launched chunk count (≥ 32
on lines of ≥ 256 cells, the last chunk padded with identity rows) and
K = 1, the two-pass form (W < K), and ``sub[..., 0]`` / ``sup[..., -1]``
holding NaN, which the kernel must never read.  Each case is held to
``tridiag_solve_pallas(..., interpret=True)`` and to JAX ``tridiag_solve``
at a scaled error ≤ 1e-10 on strongly dominant lines, lines with zero
couplings (an interval boundary, an isolated cell, a cut at a chunk
boundary) and Crank–Nicolson lines at α·s = 10³ (b = 1 + 2α, a = c = −α).

The wrapper's layout choice (``layout_of``) is held on the tensors the
``adi`` backend hands it (rows in the x half, cols in the y half, no
copy) and on a broadcast and other layouts (a copy); ``thomas`` on CPU
tensors runs the plain Thomas solve and launches nothing.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from qpsim_tpu.ops import tridiag as jt  # noqa: E402
from qpsim_tpu.ops.pallas_tridiag import tridiag_solve_pallas  # noqa: E402

import adi_transcription as tr  # noqa: E402
from qpsim_tpu_torch.ops import tridiag as tt  # noqa: E402
from qpsim_tpu_torch.ops import tridiag_cuda  # noqa: E402
from qpsim_tpu_torch.ops.adi_cuda import AdiPlanes, adi_x_half_plain, adi_y_half_plain  # noqa: E402
from qpsim_tpu_torch.ops.adi_sep import pick_chunks  # noqa: E402

#: the transcription's lines per block: rows (x half) and cols (y half)
_TL = {"rows": 4, "cols": 8}


def _system(shape, kind: str, seed=0):
    """(sub, diag, sup, rhs) of ``shape``, NaN in the entries the solve ignores.

    ``dominant``: |b| ≥ 2, |a|, |c| ≤ 0.3.  ``masked``: the same with an
    interval boundary, an isolated identity cell and both couplings cut
    at the launched kernel's first chunk boundary.  ``cn``: Crank–Nicolson
    lines at α·s = 10³, the weakest dominance the ADI backends meet.
    """
    rng = np.random.default_rng(seed)
    n = shape[-1]
    if kind == "cn":
        alpha = 1e3
        sub, sup = np.full(shape, -alpha), np.full(shape, -alpha)
        diag = np.full(shape, 1.0 + 2.0 * alpha)
    else:
        sub = rng.uniform(-0.3, -0.1, shape)
        sup = rng.uniform(-0.3, -0.1, shape)
        diag = rng.uniform(2.0, 3.0, shape)
    rhs = rng.uniform(-1.0, 1.0, shape)
    if kind == "masked" and n >= 7:
        m = -(-n // tr.launch_chunks(n))  # rows per chunk of the launched K
        cuts = {m, n // 2} if m < n else {n // 2}
        for p in cuts:  # an interval boundary between p − 1 and p
            sub[..., p] = 0.0
            sup[..., p - 1] = 0.0
        i = min(n - 2, 3)  # an isolated cell: an identity row
        sub[..., i] = sup[..., i] = 0.0
        diag[..., i] = 1.0
        sup[..., i - 1] = sub[..., i + 1] = 0.0
    sub[..., 0] = np.nan
    sup[..., -1] = np.nan
    return sub, diag, sup, rhs


def _scaled(got, ref) -> float:
    return float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))


def _references(system):
    j = [jnp.asarray(a) for a in system]
    return np.asarray(tridiag_solve_pallas(*j, interpret=True)), np.asarray(jt.tridiag_solve(*j))


@pytest.mark.parametrize("kind", ["dominant", "masked", "cn"])
@pytest.mark.parametrize("n", [2, 7, 257, 1000, 1024])
@pytest.mark.parametrize("form", ["rows", "cols"])
def test_transcription_matches_jax(form, n, kind):
    # 3 lead indices × 5 lines: ragged last blocks in both forms
    system = _system((3, 5, n), kind, seed=n)
    pallas, scan = _references(system)
    got = tr.tridiag_lines(*system, form, tl=_TL[form])
    assert np.all(np.isfinite(got))
    assert _scaled(got, pallas) <= 1e-10
    assert _scaled(got, scan) <= 1e-10


@pytest.mark.parametrize("kind", ["masked", "cn"])
@pytest.mark.parametrize("n", [257, 1024])
@pytest.mark.parametrize("form", ["rows", "cols"])
def test_transcription_thomas_sweep(form, n, kind):
    # K = 1: one chunk of n rows, the Thomas sweep
    system = _system((2, 3, n), kind, seed=1)
    pallas, _ = _references(system)
    got = tr.tridiag_lines(*system, form, k=1, tl=_TL[form])
    assert _scaled(got, pallas) <= 1e-10


@pytest.mark.parametrize("n,w", [(257, 16), (1024, 8), (1000, 4)])
@pytest.mark.parametrize("form", ["rows", "cols"])
def test_transcription_two_pass(form, n, w):
    # W < K chunks held at once: the two-pass form of lines too long for shared memory
    system = _system((2, 5, n), "masked", seed=2)
    pallas, _ = _references(system)
    k = tr.launch_chunks(n)
    assert k == 32 and k % w == 0
    got = tr.tridiag_lines(*system, form, k=k, tl=_TL[form], w=w)
    np.testing.assert_array_equal(got, tr.tridiag_lines(*system, form, k=k, tl=_TL[form]))
    assert _scaled(got, pallas) <= 1e-10


@pytest.mark.parametrize("n", [2, 7, 16, 257, 1000, 1023, 1024, 16385])
def test_launched_chunks_follow_the_adi_kernels(n):
    # the wrapper asks pick_chunks(n); the kernel raises to 32 from 256 cells on
    assert pick_chunks(n) == tr.pick_chunks(n)
    k = tr.launch_chunks(n)
    assert k == (32 if n >= 256 else pick_chunks(n))
    assert k <= n


def _planes(nb, nbp, ny, nx, seed=0):
    rng = np.random.default_rng(seed)
    plane = lambda lo, hi: torch.as_tensor(rng.uniform(lo, hi, (nbp, ny, nx)))
    return AdiPlanes(
        ax_lo=plane(0.5, 1.0), ax_hi=plane(0.5, 1.0), ax_diag=plane(-2.0, -1.0),
        ay_lo=plane(0.5, 1.0), ay_hi=plane(0.5, 1.0), ay_diag=plane(-2.0, -1.0),
        src=plane(0.0, 0.1), scale=torch.as_tensor(rng.uniform(1.0, 1.5, nb)),
    ), torch.as_tensor(rng.uniform(0.0, 1.0, (nb, ny, nx)))


@pytest.mark.parametrize("nb,nbp", [(3, 1), (3, 3), (1, 1)])
def test_adi_backend_halves_need_no_copy(nb, nbp):
    planes, u = _planes(nb, nbp, 6, 10)
    seen = []

    def spy(*args):
        seen.append(tridiag_cuda.layout_of(*args))
        return tt.tridiag_solve_thomas(*args)

    x = adi_x_half_plain(u, planes, 0.1, solve=spy)
    adi_y_half_plain(x, planes, 0.1, solve=spy)
    # x half: NB·Ny contiguous lines of Nx; y half: Nx adjacent columns of Ny per bin
    assert seen == [("rows", nb * 6, 10, 1), ("cols", 10, 6, nb)]


def test_layout_of_refuses_what_it_cannot_read_in_place():
    t = torch.ones(4, 5, 7, dtype=torch.float64)
    layout = tridiag_cuda.layout_of
    assert layout(t, t, t, t) == ("rows", 20, 7, 1)
    v = t.movedim(-2, -1)  # (4, 7, 5): lines of 5, 7 adjacent columns per lead index
    assert layout(v, v, v, v) == ("cols", 7, 5, 4)
    line = torch.ones(7, dtype=torch.float64)
    assert layout(line, t, t, t) is None  # a broadcast: different shapes
    assert layout(*torch.broadcast_tensors(line, t, t, t)) is None  # stride-0 views
    assert layout(t, t, t, t.transpose(0, 1).contiguous().transpose(0, 1)) is None  # other strides
    assert layout(v, v.contiguous(), v, v) is None  # mixed rows and cols
    assert layout(t[:, :, ::2], t[:, :, ::2], t[:, :, ::2], t[:, :, ::2]) is None  # a strided slice
    one = torch.ones(4, 7, 1, dtype=torch.float64).movedim(-2, -1)  # cols of one line: rows
    assert layout(one, one, one, one) == ("rows", 4, 7, 1)


@pytest.mark.parametrize("case", ["rows", "cols", "broadcast"])
def test_thomas_on_cpu_runs_the_plain_solve_and_launches_nothing(case, restore_solver):
    sub, diag, sup, rhs = (torch.as_tensor(a) for a in _system((3, 4, 33), "masked"))
    if case == "cols":
        cols = lambda t: t.transpose(-1, -2).contiguous().transpose(-1, -2)
        sub, diag, sup, rhs = (cols(t) for t in (sub, diag, sup, rhs))
        assert tridiag_cuda.layout_of(sub, diag, sup, rhs) == ("cols", 4, 33, 3)
    elif case == "broadcast":
        diag = diag[0, 0]
    before = dict(tridiag_cuda.LAUNCHES)
    got = tridiag_cuda.thomas(sub, diag, sup, rhs)
    np.testing.assert_array_equal(got.numpy(), tt.tridiag_solve_thomas(sub, diag, sup, rhs).numpy())
    tt.set_default_solver("pallas")
    np.testing.assert_array_equal(tt.tridiag_solve(sub, diag, sup, rhs).numpy(), got.numpy())
    full = torch.broadcast_tensors(sub, diag, sup, rhs)
    ref = np.asarray(jt.tridiag_solve(*(jnp.asarray(t.numpy()) for t in full)))
    assert _scaled(got.numpy(), ref) <= 1e-12
    assert tridiag_cuda.LAUNCHES == before


@pytest.fixture
def restore_solver():
    yield
    tt.set_default_solver("auto")
