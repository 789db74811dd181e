"""The program's spans in the trace's summary, and the readers of its counters."""

from __future__ import annotations

from types import SimpleNamespace

import pytest
from benchmark import trace
from benchmark.run import read_metric


class Event:
    """An event as ``torch.profiler``'s kineto results give it."""

    def __init__(self, name, start, dur, device="CPU", annotation=False):
        self._name, self._start, self._dur, self._device, self._annotation = name, start, dur, device, annotation

    def name(self):
        return self._name

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._dur

    def device_type(self):
        return f"DeviceType.{self._device}"

    def is_user_annotation(self):
        return self._annotation

    def activity_type(self):
        return "gpu_user_annotation" if self._annotation and self._device == "CUDA" else "kernel"


def _profile(events):
    return SimpleNamespace(profiler=SimpleNamespace(kineto_results=SimpleNamespace(events=lambda: events)))


def _summary():
    """One job: its set-up under qpsim.first_frame (mirrored onto the card, as the
    profiler mirrors a region that holds device work), a frame, and an end past the
    job's qpsim.run."""
    return trace.summarize(_profile([
        Event(trace.CALL, 0, 1_000_000),
        Event("qpsim.run", 10, 799_990),
        Event("qpsim.first_frame", 100_000, 300_000),
        Event("qpsim.first_frame", 150_000, 200_000, device="CUDA", annotation=True),
        Event(trace.FRAME, 450_000, 1),
        Event("kernel_a", 50_000, 10_000, device="CUDA"),
        Event("kernel_b", 500_000, 10_000, device="CUDA"),
        Event("kernel_c", 900_000, 5_000, device="CUDA"),
    ]), window_s=1e-3)


def test_a_span_mirrored_onto_the_card_is_no_device_operation():
    s = _summary()
    assert [op.name for op in s.ops] == ["kernel_a", "kernel_b", "kernel_c"]
    assert s.busy_s == pytest.approx(25e-6)


def test_an_idle_gap_under_a_span_carries_its_name():
    gaps = dict(_summary().idle_gaps)
    assert gaps["call set-up: qpsim.first_frame"] == pytest.approx(440e-6)  # 60 → 500 µs
    assert gaps["call set-up: qpsim.run"] == pytest.approx(50e-6)  # 0 → 50 µs, outside first_frame
    assert gaps["after the last frame: qpsim.run"] == pytest.approx(390e-6)  # 510 → 900 µs
    # past every span the label is the one a program without spans gets
    assert gaps["after the last frame: python"] == pytest.approx(95e-6)


@pytest.fixture
def counters(monkeypatch):
    """Sets the program's counters to the dict the test passes."""
    from qpsim_tpu_torch.ops import launch_tables
    from qpsim_tpu_torch.utils import profiling

    def use(values: dict):
        every = {k: 0 for table in launch_tables() for k in table}
        every |= {"host_copy_bytes": 0, "initial_copy_bytes": 0}
        monkeypatch.setattr(profiling, "counters", lambda: every | values)

    return use


def _run(jobs: int, steps: int = 20, store_every: int = 5):
    """A window of ``jobs`` completed jobs of ``steps`` steps, one more that failed."""
    calls = [SimpleNamespace(steps=steps, error=None) for _ in range(jobs)]
    calls.append(SimpleNamespace(steps=0, error="RuntimeError: no"))
    return SimpleNamespace(traffic={"store_every": store_every}, calls=calls,
                           completed=lambda: [c for c in calls if c.error is None])


def test_launches_per_step_count_each_launch_once(counters):
    # the warm-up's 5 steps and two jobs of 20 steps: two K2 halves and one K3 a step,
    # one more K3 a segment (9 segments) and one K10 in cols; the launches with a
    # generation plane, the cols form and the device-memory form are counted again
    # under their own keys, and not here
    counters({"adi_x_half": 45, "adi_y_half": 45, "collision_step": 54, "collision_step_with_gen": 54,
              "thomas": 1, "thomas_cols": 1, "column_walk_device": 3})
    assert read_metric("program_launches_per_step")(_run(2)) == pytest.approx(145 / 45)


@pytest.mark.parametrize("jobs", [1, 3, 10])
def test_host_copy_mb_per_job_is_a_window_jobs_own(counters, jobs):
    # each job copies 2 MB before its first segment and 0.25 MB a segment; the
    # warm-up job has one segment, a window job four
    initial, segments = 2_000_000 * (jobs + 1), 4 * jobs + 1
    counters({"host_copy_bytes": initial + 250_000 * segments, "initial_copy_bytes": initial})
    assert read_metric("host_copy_mb_per_job")(_run(jobs)) == pytest.approx(3.0)


def test_counter_readers_read_nothing_without_jobs_or_counters(counters, monkeypatch):
    from qpsim_tpu_torch.utils import profiling

    counters({})
    assert read_metric("program_launches_per_step")(_run(0)) is None
    assert read_metric("host_copy_mb_per_job")(_run(0)) is None
    # a program without the copy counters, or without any (the parents of the changes that added them)
    monkeypatch.setattr(profiling, "counters", lambda: {"host_copy_bytes": 1})
    assert read_metric("host_copy_mb_per_job")(_run(2)) is None
    monkeypatch.delattr(profiling, "counters")
    assert read_metric("program_launches_per_step")(_run(2)) is None
    assert read_metric("host_copy_mb_per_job")(_run(2)) is None
