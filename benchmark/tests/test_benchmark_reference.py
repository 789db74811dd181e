"""The plain reference against the program's plain versions on the CPU, in float64,
where the two must agree to rounding: the same physics, worked out apart."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from benchmark.reference import uniform_film
from benchmark.tests.tinycell import DATA


def _job(ne: int, n: int):
    cfg = json.loads((DATA / "configs" / "tiny_film.json").read_text())
    cfg["physics"]["num_energy_bins"] = ne
    cfg["dtype"] = "float64"
    mask = np.zeros((n, n), dtype=bool)
    mask[8:-8, 8:-8] = True
    y, x = np.mgrid[0:n, 0:n] + 0.5
    field = 1e-5 + 1e-2 * np.exp(-((x - 17.3) ** 2 + (y - 20.1) ** 2) / 32.0)
    return cfg, mask, field


def _program(cfg, mask, field, steps, store):
    from qpsim_tpu_torch import run_2d_crank_nicolson
    from qpsim_tpu_torch.geometry.mask import extract_edge_segments
    from qpsim_tpu_torch.models.params import BoundaryCondition, ExternalGenerationSpec

    p = dict(cfg["physics"])
    gen = ExternalGenerationSpec(**p.pop("external_generation"))
    edges = extract_edge_segments(mask)
    phonons: dict = {}
    times, frames, mass, *_ = run_2d_crank_nicolson(
        mask=mask, edges=edges, edge_conditions={e.edge_id: BoundaryCondition(kind="reflective") for e in edges},
        initial_field=field, total_time=steps * p["dt"], store_every=store, external_generation=gen,
        phonon_history_out=phonons, snapshot_detail="integrated", device="cpu", dtype=torch.float64, **p)
    return {"times": times, "frames": frames, "mass": mass, "phonon_frames": phonons["phonon_frames"]}


@pytest.mark.parametrize("ne,n,steps,store", [(8, 40, 60, 20), (16, 36, 40, 20), (100, 20, 20, 10)])
def test_reference_agrees_with_the_programs_plain_path_in_float64(ne, n, steps, store):
    from benchmark import compare

    cfg, mask, field = _job(ne, n)
    ref = uniform_film.simulate(cfg, mask, field, steps, store, "cpu", torch.float64)
    got = compare.compare(_program(cfg, mask, field, steps, store), ref, mask)
    assert got["frames"] < 1e-12 and got["mass"] < 1e-12 and got["phonons"] < 1e-9, got


@pytest.mark.parametrize("ne", [8, 16, 100])
def test_the_fft_form_agrees_with_the_dense_form(ne):
    cfg, mask, _ = _job(ne, 20)
    film = uniform_film.Film(cfg, mask, "cpu", torch.float64)
    gen = torch.Generator().manual_seed(ne)
    q = 1e-4 * torch.rand((50, ne), generator=gen, dtype=torch.float64) * film.rho
    n = 1e-2 * torch.rand((50, film.nw), generator=gen, dtype=torch.float64)
    part = film.rho * torch.clamp(1.0 - q / film.rho, min=0.0)
    for a, b in zip(film._rates_fft(q, n, part), film._rates_dense(q, n, part)):
        assert torch.allclose(a, b, rtol=1e-11, atol=1e-11 * float(b.abs().max())), (a - b).abs().max()


def test_antidiagonal_sums_and_hankel_views():
    a = torch.arange(2 * 4 * 4, dtype=torch.float64).reshape(2, 4, 4)
    want = torch.stack([torch.stack([sum(a[c, i, m - i] for i in range(4) if 0 <= m - i < 4)
                                     for m in range(7)]) for c in range(2)])
    assert torch.equal(uniform_film._antidiagonal_sums(a), want)
    v = torch.arange(14, dtype=torch.float64).reshape(2, 7)
    h = uniform_film._hankel(v, 4)
    assert all(h[c, i, j] == v[c, i + j] for c in range(2) for i in range(4) for j in range(4))
