"""The engine's spans and counters (``qpsim_tpu_torch.utils.profiling``) on the CPU.

A 32² film × 8 bins, three stored segments, in both snapshot details:
under ``torch.profiler`` each call is one ``qpsim.run`` holding its build,
initial state, first frame, segments, drains, stored snapshots and finish,
each span inside its parent; with no profiler ``span`` is one shared no-op
and never opens a ``record_function``; the runner's copy counters match
the bytes counted by hand; each first frame is reduced on the host,
a resumed run's replayed one too; every key of the launch tables is classified by
the benchmark's ``program_launches_per_step``; and the results do not
depend on the profiler.
"""

from __future__ import annotations

import importlib.util
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from qpsim_tpu_torch import run_2d_crank_nicolson
from qpsim_tpu_torch.geometry.mask import extract_edge_segments
from qpsim_tpu_torch.models.params import BoundaryCondition, ExternalGenerationSpec
from qpsim_tpu_torch.ops import launch_tables
from qpsim_tpu_torch.utils import profiling

NE, STORE_EVERY, SEGMENTS = 8, 4, 3

#: each span's parent: the innermost span whose interval holds it
PARENTS = {
    "qpsim.run": {None},
    "qpsim.build": {"qpsim.run"},
    "qpsim.build.diffusion": {"qpsim.build"},
    "qpsim.build.collisions": {"qpsim.build"},
    "qpsim.initial_state": {"qpsim.run"},
    "qpsim.first_frame": {"qpsim.run"},
    "qpsim.segment": {"qpsim.run"},
    "qpsim.drain": {"qpsim.run"},
    "qpsim.store": {"qpsim.first_frame", "qpsim.drain"},
    "qpsim.copy_wait": {"qpsim.store", "qpsim.drain"},
    "qpsim.reduce": {"qpsim.store"},
    "qpsim.callback": {"qpsim.store"},
    "qpsim.finish": {"qpsim.run"},
}


def _film():
    mask = np.zeros((32, 32), dtype=bool)
    mask[2:30, 2:30] = True
    edges = extract_edge_segments(mask)
    y, x = np.mgrid[0:32, 0:32]
    field = 1e-5 * (1.0 + 0.5 * np.exp(-((x - 12.0) ** 2 + (y - 17.0) ** 2) / 18.0))
    return dict(
        mask=mask, edges=edges,
        edge_conditions={e.edge_id: BoundaryCondition(kind="reflective") for e in edges},
        initial_field=field, diffusion_coefficient=6.0, dt=0.05,
        total_time=0.05 * STORE_EVERY * SEGMENTS, dx=1.0, store_every=STORE_EVERY,
        energy_gap=180.0, energy_max_factor=4.0, num_energy_bins=NE,
        enable_recombination=True, enable_scattering=True, diffusion_backend="adi",
        external_generation=ExternalGenerationSpec(
            mode="pulse", pulse_start=0.1, pulse_duration=0.3, pulse_rate=2e-5),
        device="cpu",
    )


def _run(detail: str):
    """One call: its results, the phonon history, the frames the callback saw and
    the counters' change over the call."""
    phonons: dict = {}
    seen: list = []
    before = profiling.counters()
    out = run_2d_crank_nicolson(**_film(), snapshot_detail=detail, phonon_history_out=phonons,
                                progress_callback=lambda t, f: seen.append((t, f)))
    after = profiling.counters()
    return out, phonons, seen, {k: after[k] - before[k] for k in after}


def _spans(prof) -> list[tuple[str, int, int]]:
    """(name, start ns, end ns) of the profile's ``qpsim.*`` events, by start."""
    out = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events() if e.name().startswith("qpsim.")]
    return sorted(out, key=lambda s: (s[1], -s[2]))


def _parents(spans):
    """Each span with its innermost enclosing span (None for a root)."""
    stack: list = []
    out = []
    for s in spans:
        while stack and stack[-1][2] < s[1]:
            stack.pop()
        parent = stack[-1] if stack else None
        out.append((s, parent))
        stack.append(s)
    return out


@pytest.fixture(scope="module", params=["integrated", "full"])
def traced(request):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        result = _run(request.param)
    return request.param, _spans(prof), result


def test_one_run_holds_build_initial_state_and_first_frame_in_order(traced):
    _, spans, _ = traced
    names = [s[0] for s in spans]
    assert names.count("qpsim.run") == 1
    run = spans[0]
    assert run[0] == "qpsim.run"
    firsts = [next(s for s in spans if s[0] == n)
              for n in ("qpsim.build", "qpsim.initial_state", "qpsim.first_frame")]
    assert all(names.count(s[0]) == 1 for s in firsts)
    assert [s[1] for s in firsts] == sorted(s[1] for s in firsts)
    assert all(run[1] <= s[1] and s[2] <= run[2] for s in firsts)
    # the phases follow one another: each ends before the next begins
    assert firsts[0][2] <= firsts[1][1] and firsts[1][2] <= firsts[2][1]
    assert names.count("qpsim.build.diffusion") == names.count("qpsim.build.collisions") == 1
    assert names.count("qpsim.finish") == 1


def test_a_segment_and_a_drain_per_segment_and_a_store_per_frame(traced):
    _, spans, (out, _, seen, _) = traced
    counts = Counter(s[0] for s in spans)
    assert counts["qpsim.segment"] == counts["qpsim.drain"] == SEGMENTS
    assert len(out[0]) == len(seen) == SEGMENTS + 1
    assert counts["qpsim.store"] == counts["qpsim.reduce"] == counts["qpsim.callback"] == SEGMENTS + 1
    # one wait for each drain's statistics and each stored snapshot, the first frame's included
    assert counts["qpsim.copy_wait"] == SEGMENTS + SEGMENTS + 1
    assert set(counts) == set(PARENTS)


def test_every_span_lies_inside_its_parent(traced):
    _, spans, _ = traced
    for (name, start, end), parent in _parents(spans):
        if parent is None:
            assert name == "qpsim.run"
            continue
        assert parent[0] in PARENTS[name], (name, parent[0])
        assert parent[1] <= start and end <= parent[2], (name, parent[0])
    # a drain's store follows its statistics' wait; the first frame's store holds its copy's wait
    store_parents = Counter(p[0] for s, p in _parents(spans) if s[0] == "qpsim.store")
    assert store_parents == {"qpsim.first_frame": 1, "qpsim.drain": SEGMENTS}


def _hand_count(detail: str, nw: int) -> tuple[int, int]:
    """Bytes the runner copies to the host in one call of :func:`_film` (float64), and the
    part of them it copies before the first segment."""
    cells = 32 * 32
    stats0, stats_seg = 4, STORE_EVERY * 4  # Pauli statistics at t = 0 and a segment's stacked rows
    state0 = (NE + nw) * cells  # the first frame reads q and n_ph
    if detail == "integrated":
        frame = cells + NE + cells + nw  # the integrated frame, bin sums, phonon frame, ω sums
    else:
        frame = (NE + nw) * cells  # q and n_ph, reduced on the host
    return 8 * (stats0 + state0 + SEGMENTS * (stats_seg + frame)), 8 * (stats0 + state0)


def test_host_copy_counter_matches_the_count_by_hand(traced):
    detail, _, (_, phonons, _, delta) = traced
    nw = phonons["phonon_energy_bins"].size
    assert (delta["host_copy_bytes"], delta["initial_copy_bytes"]) == _hand_count(detail, nw)
    # no kernel launches on the CPU, and every launch table is in the snapshot
    assert set(delta) == {k for table in launch_tables() for k in table} | {
        "host_copy_bytes", "initial_copy_bytes", "first_frames_on_card", "first_frames_on_host"}
    assert all(delta[k] == 0 for table in launch_tables() for k in table)


def test_the_first_frame_is_reduced_on_the_host_on_the_cpu(traced):
    _, _, (_, _, _, delta) = traced
    assert (delta["first_frames_on_host"], delta["first_frames_on_card"]) == (1, 0)


def test_a_resumed_light_run_on_the_cpu_reduces_its_first_frame_on_the_host(tmp_path):
    from qpsim_tpu_torch.io.checkpoint import SimulationCheckpointer

    kw = dict(_film(), snapshot_detail="integrated")
    whole = run_2d_crank_nicolson(**kw)
    run_2d_crank_nicolson(**{**kw, "total_time": kw["total_time"] / SEGMENTS},
                          checkpointer=SimulationCheckpointer(tmp_path))
    before = profiling.counters()
    resumed = run_2d_crank_nicolson(**kw, checkpointer=SimulationCheckpointer(tmp_path))
    after = profiling.counters()
    assert [after[k] - before[k] for k in ("first_frames_on_host", "first_frames_on_card")] == [1, 0]
    np.testing.assert_array_equal(np.stack(resumed[1]), np.stack(whole[1]))
    assert resumed[2] == whole[2]


def test_every_launch_key_is_classified_for_the_benchmark():
    """A key a launch table gains has to be named a launch or a second count of one in
    ``benchmark/metrics/program_launches_per_step.py``, or the metric leaves it out."""
    path = Path(__file__).resolve().parents[1] / "benchmark" / "metrics" / "program_launches_per_step.py"
    spec = importlib.util.spec_from_file_location("program_launches_per_step", path)
    metric = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(metric)
    keys = {k for table in launch_tables() for k in table}
    assert not metric.LAUNCH_KEYS & metric.SUBCOUNT_KEYS
    assert keys == metric.LAUNCH_KEYS | metric.SUBCOUNT_KEYS


def test_results_do_not_depend_on_the_profiler(traced):
    detail, _, (out, phonons, seen, _) = traced
    out0, phonons0, seen0, _ = _run(detail)
    times, frames, mass, limits, eframes, ebins = out
    np.testing.assert_array_equal(times, out0[0])
    np.testing.assert_array_equal(np.stack(frames), np.stack(out0[1]))
    np.testing.assert_array_equal(mass, out0[2])
    np.testing.assert_array_equal(limits, out0[3])
    if detail == "full":
        np.testing.assert_array_equal(np.stack([np.stack(e) for e in eframes]),
                                      np.stack([np.stack(e) for e in out0[4]]))
    np.testing.assert_array_equal(np.stack(phonons["phonon_frames"]), np.stack(phonons0["phonon_frames"]))
    for (t, f), (t0, f0) in zip(seen, seen0, strict=True):
        assert t == t0
        np.testing.assert_array_equal(f, f0)


def test_span_without_a_profiler_is_the_shared_no_op(monkeypatch):
    entered = []

    class Counting:
        def __init__(self, name, args=None):
            entered.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    assert not torch.autograd._profiler_enabled()
    assert profiling.span("qpsim.run") is profiling.span("qpsim.drain") is profiling._NO_SPAN
    _run("integrated")
    assert entered == []
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("qpsim.run"):
            pass
    assert entered == ["qpsim.run"]
