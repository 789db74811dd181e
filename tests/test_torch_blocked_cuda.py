"""The column walk's register-blocked walk (``csrc/offset_walk.cu``) on the card.

Needs an NVIDIA card: every test is marked ``cuda`` and skips without one.
On the card, where JAX need not be installed:
``python -m pytest --noconftest -m cuda tests/test_torch_blocked_cuda.py``.

Held here, each against its plain version on the same inputs
(``chip_smoke.collision_setup`` and ``chip_smoke.walk_step``: random
states, the dt·g plane fused), as scaled max errors (max |kernel − plain|
/ max |plain|) at ``chip_smoke.blocked_tol`` (float64 1e-10): K5 at 1024²
× 100 in float32 and float64, with random gap ids (mixed warps), the
trap's coherent ids and K6; K5, K5 with gap ids and K6 where the column
lists are not one column per offset and anti-diagonal — the split ω
diagonals of NE 17 and 65 (extra terms) and the ω rows a difference and a
sum share at NE 72 (per-row sums), on a ragged tile; K3 and K4 on the
column walk from 17 to 64 bins; K8 and K9 at 16 to 100 bins; K5 at 256² ×
256 in the staged and the device-memory form; every (pixels, bins) form
the kernel is built for at 128² × 100; a film ensemble's 32 member ids at
8 bins; and a 100-bin engine run whose collisions all launch K5.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from qpsim_tpu_torch.ops import collisions_cuda, column_walk
from qpsim_tpu_torch.utils import profiling

pytestmark = pytest.mark.cuda

F32, F64 = torch.float32, torch.float64


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


def _smoke():
    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke

    return chip_smoke


def _err(kern, plain, q, ph, gen):
    cs = _smoke()
    got, ref = kern(q, ph, 0.05, gen), plain(q, ph, 0.05, gen)
    torch.cuda.synchronize()
    return max(cs.scaled_err(got[0], ref[0]), cs.scaled_err(got[1], ref[1]))


#: the launch-table key of each ``collision_setup`` kind's wrapper
WRAPPER = {"uniform": "collision_step", "gid": "collision_step_gid", "gid8": "collision_step_gid",
           "trap": "collision_step_gid", "analytic": "collision_step_analytic"}


def _launched(kind, blocked, before):
    """Launches of ``kind``'s wrapper since ``before`` (a copy of ``LAUNCHES``)."""
    name = WRAPPER[kind].replace("collision_step", "collision_step_blocked" if blocked else "collision_step")
    return collisions_cuda.LAUNCHES[name] - before[name]


@pytest.mark.parametrize(
    "ne,n,dtype,kind",
    [(100, 1024, F32, "uniform"), (100, 1024, F64, "uniform"), (100, 1024, F32, "gid"),
     (100, 1024, F32, "trap"), (100, 1024, F32, "analytic"), (100, 1024, F64, "analytic")],
)
def test_blocked_walk_matches_the_plain_step(ne, n, dtype, kind):
    cs = _smoke()
    kern, plain, *_, q, ph, gen = cs.collision_setup(ne, n, dtype, kind=kind, blocked=True)
    before = dict(collisions_cuda.LAUNCHES)
    err = _err(kern, plain, q, ph, gen)
    assert _launched(kind, True, before) == 1
    assert err <= cs.blocked_tol(dtype, ne), err


#: split ω diagonals (17, 65) and ω rows shared by a difference and a sum
#: (72, on 45² pixels: a ragged last tile), each kernel form and dtype
SPLIT_AND_SHARED = [(ne, n, dtype, kind, phonons)
                    for ne, n in ((17, 128), (65, 128), (72, 45))
                    for kind in ("uniform", "gid", "analytic")
                    for dtype in (F32, F64)
                    for phonons in ((True, False) if ne == 72 and kind == "uniform" else (True,))]


@pytest.mark.parametrize("ne,n,dtype,kind,phonons", SPLIT_AND_SHARED)
def test_blocked_walk_on_split_and_shared_rows_matches_the_plain_step(ne, n, dtype, kind, phonons):
    from qpsim_tpu_torch.ops.collisions_blocked_cuda import build_column_tables

    cs = _smoke()
    kern, plain, plan, *_, q, ph, gen = cs.collision_setup(
        ne, n, dtype, kind=kind, phonons=phonons, gamma=0.12 if kind == "analytic" else 0.0,
        blocked=True, pixel_chunk=1024)
    if kind != "analytic":  # the column lists walk extra terms (17, 65) and per-row sums (72)
        t = build_column_tables(plan)
        assert t.slow_rows.numel() > 1
        assert (t.x_scat.numel() + t.x_rec.numel() > 0) == (ne != 72)
    before = dict(collisions_cuda.LAUNCHES)
    err = _err(kern, plain, q, ph, gen)
    assert _launched(kind, True, before) == 1
    assert err <= cs.blocked_tol(dtype, ne), err


@pytest.mark.parametrize("dtype", [F32, F64])
@pytest.mark.parametrize("ne,kind", [(17, "uniform"), (33, "gid8"), (50, "analytic"), (64, "uniform")])
def test_k3_and_k4_on_the_column_walk_match_the_plain_step(ne, kind, dtype):
    cs = _smoke()
    assert collisions_cuda.walk_bins(ne) is None  # beyond the pair walk's bins
    kern, plain, *_, q, ph, gen = cs.collision_setup(
        ne, (45, 50), dtype, kind=kind, gamma=0.12 if kind == "analytic" else 0.0, pixel_chunk=1024)
    before = dict(collisions_cuda.LAUNCHES)
    err = _err(kern, plain, q, ph, gen)
    assert _launched(kind, False, before) == 1
    assert err <= cs.blocked_tol(dtype, ne), err


#: K8 (one column per offset and anti-diagonal) and K9 (per (offset, ω
#: row) group: the split 66 and the shared 72), with and without phonons
OFFSET_WALKS = [("loop", 72, "uniform"), ("loop", 100, "gid"), ("loop", 16, "gid9"),
                ("rows", 66, "uniform"), ("rows", 72, "uniform")]


@pytest.mark.parametrize("phonons", [True, False])
@pytest.mark.parametrize("dtype", [F32, F64])
@pytest.mark.parametrize("form,ne,kind", OFFSET_WALKS)
def test_offset_walks_on_the_blocked_walk_match_their_plain_version(form, ne, kind, dtype, phonons):
    from qpsim_tpu_torch.ops.collisions_loop_cuda import collision_step_loop_plain

    cs = _smoke()
    *_, q, ph, _ = cs.collision_setup(ne, 128, dtype, kind="gid" if kind == "gid9" else kind,
                                      blocked=ne > 64, pixel_chunk=1024)
    step = cs.walk_step(form, ne, 128, kind=kind, phonons=phonons)
    before = dict(collisions_cuda.LAUNCHES)
    got, ref = step(q, ph), collision_step_loop_plain(step, q, ph)
    torch.cuda.synchronize()
    assert collisions_cuda.LAUNCHES[step.counter] - before[step.counter] == 1
    err = max(cs.scaled_err(got[0], ref[0]), cs.scaled_err(got[1], ref[1]))
    assert err <= cs.blocked_tol(dtype, ne), err


#: the (pixels, bins, dtype) forms csrc/offset_walk.cu is built for, staged
FORMS = [(1, 4, F64), (1, 4, F32), (1, 8, F32), (2, 4, F32)]


@pytest.mark.parametrize("kind", ["uniform", "gid8", "analytic"])
@pytest.mark.parametrize("pixels,bins,dtype", FORMS, ids=[f"P{p}-B{b}" for p, b, _ in FORMS])
def test_every_built_form_matches_the_plain_step(monkeypatch, pixels, bins, dtype, kind):
    cs = _smoke()
    monkeypatch.setattr(column_walk, "column_pixels", lambda *a, **k: pixels)
    monkeypatch.setattr(column_walk, "column_bins", lambda *a: bins)
    kern, plain, *_, q, ph, gen = cs.collision_setup(100, 128, dtype, kind=kind, blocked=True)
    assert _err(kern, plain, q, ph, gen) <= cs.blocked_tol(dtype, 100)


def test_an_ensembles_32_member_ids_match_the_plain_step_at_two_pixels_a_lane():
    from qpsim_tpu_torch.parallel import build_film_ensemble

    cs = _smoke()
    ens = build_film_ensemble(n_members=32, member_shape=(64, 64), num_energy_bins=8,
                              tau_r=np.linspace(200.0, 700.0, 32), tau_s=np.linspace(300.0, 600.0, 32))
    q, ph = ens.to_device(*cs.ensemble_state(ens))
    assert column_walk.column_pixels(q.dtype, 8, q[0].numel(), uniform=False) == 2
    step = ens.collision_half
    before = dict(collisions_cuda.LAUNCHES)
    got, ref = step(q, ph), step.plain(q, ph)
    torch.cuda.synchronize()
    assert collisions_cuda.LAUNCHES["collision_step_blocked_gid"] - before["collision_step_blocked_gid"] == 1
    err = max(cs.scaled_err(got[0], ref[0]), cs.scaled_err(got[1], ref[1]))
    assert err <= cs.blocked_tol(q.dtype, 8), err


def test_a_100_bin_engine_run_walks_every_k5_launch_blocked():
    from qpsim_tpu_torch import run_2d_crank_nicolson
    from qpsim_tpu_torch.geometry.mask import extract_edge_segments
    from qpsim_tpu_torch.models.params import BoundaryCondition

    mask = np.ones((64, 64), dtype=bool)
    mask[:4], mask[-4:], mask[:, :4], mask[:, -4:] = False, False, False, False
    edges = extract_edge_segments(mask)
    kw = dict(mask=mask, edges=edges,
              edge_conditions={e.edge_id: BoundaryCondition(kind="reflective") for e in edges},
              initial_field=np.where(mask, 1e-5, 0.0), diffusion_coefficient=6.0, dt=0.05,
              total_time=0.5, dx=1.0, store_every=5, energy_gap=180.0, energy_max_factor=4.0,
              num_energy_bins=100, enable_recombination=True, enable_scattering=True,
              bath_temperature=0.1, device="cuda", dtype=F32)
    before = profiling.counters()
    out = run_2d_crank_nicolson(**kw)
    after = profiling.counters()
    delta = {k: after[k] - before[k] for k in after}
    # every collision of the run (ten steps, no dt·g plane) is K5's
    collisions = {k: v for k, v in delta.items() if k.startswith("collision_step") and v}
    assert set(collisions) == {"collision_step_blocked"} and collisions["collision_step_blocked"] >= 10
    assert np.all(np.isfinite(out[1][-1][mask]))
