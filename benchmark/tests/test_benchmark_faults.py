"""The check fails where it must: the tiny cell run through the harness on the CPU with
the timed path broken underneath, and the control (the reference one precision lower)."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from benchmark import compare
from benchmark.tests.tinycell import DATA, ROOT, run_tiny


def _wrap_segments(monkeypatch, transform):
    """Break the engine's segment runner: ``transform(q_in, ph_in, q_out, ph_out) -> (q, ph)``."""
    from qpsim_tpu_torch.solver import spectral_runner

    real = spectral_runner.build_engine_program

    def build(**kw):
        prog = real(**kw)
        runner = prog.segment_runner

        def segment_runner(dt, length):
            run = runner(dt, length)

            def broken(q, ph, t):
                q2, ph2, stats, flags = run(q, ph, t)
                return (*transform(q, ph, q2, ph2), stats, flags)

            return broken

        prog.segment_runner = segment_runner
        return prog

    monkeypatch.setattr(spectral_runner, "build_engine_program", build)


def _half(q, ph, q2, ph2):
    """Half of the film's rows left out of the step: they keep their state."""
    rows = q.shape[1] // 2
    q2, ph2 = q2.clone(), ph2.clone()
    q2[:, :rows], ph2[:, :rows] = q[:, :rows], ph[:, :rows]
    return q2, ph2


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_a_broken_timed_path_reads_incorrect(monkeypatch, fault):
    if fault == "unchanged":
        _wrap_segments(monkeypatch, lambda q, ph, q2, ph2: (q, ph))
    elif fault == "half":
        _wrap_segments(monkeypatch, _half)
    else:
        import qpsim_tpu_torch

        real = qpsim_tpu_torch.run_2d_crank_nicolson

        def altered(**kw):
            times, frames, *rest = real(**kw)
            frames[1] = frames[1].copy()
            frames[1][20, 20] *= 1.01  # one cell of one answer a run checks, 1 % off where it is produced
            return (times, frames, *rest)

        monkeypatch.setattr(qpsim_tpu_torch, "run_2d_crank_nicolson", altered)
    rc, err, line = run_tiny()
    assert rc == 0, err
    assert line["correct"] is False, line["checks"]


def test_the_control_reads_incorrect():
    """The reference in bfloat16, put in the program's place, fails the tiny cell's limits
    and, by one number at least, every cell's."""
    from benchmark.reference import uniform_film

    cfg = json.loads((DATA / "configs" / "tiny_film.json").read_text())
    traffic = json.loads((DATA / "traffic" / "tiny.json").read_text())
    mask = np.zeros((40, 40), dtype=bool)
    mask[8:-8, 8:-8] = True
    y, x = np.mgrid[0:40, 0:40] + 0.5
    field = 1e-5 + 1e-2 * np.exp(-((x - 17.3) ** 2 + (y - 20.1) ** 2) / 32.0)
    run = lambda dtype: uniform_film.simulate(cfg, mask, field, traffic["check_steps"],
                                              traffic["store_every"], "cpu", dtype)
    got = compare.compare(run(torch.bfloat16), run(torch.float64), mask)
    for limits in [DATA / "limits" / "tiny.cell.json", *sorted((ROOT / "benchmark" / "limits").glob("*.json"))]:
        lim = json.loads(limits.read_text())
        assert any(got[n] > lim[n] for n in compare.NAMES), (limits.name, got)
