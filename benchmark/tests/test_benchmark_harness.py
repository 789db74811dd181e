"""The harness: the tiny cell end to end, the files found by name, BENCHMARK.json's
contract, the work counts, and what a run's process loads."""

from __future__ import annotations

import ast
import inspect
import json
import re
import subprocess
import sys

import pytest
from benchmark.tests.tinycell import DATA, ROOT, run_tiny

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@pytest.mark.parametrize("trace", [0, 1])
def test_tiny_cell_prints_the_contract_line(trace):
    rc, err, line = run_tiny(trace=trace)
    assert rc == 0, err
    assert line is not None and list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    kind = "per_layer" if trace else "end_to_end"
    # on the CPU no kernel of the card's runs, so the rooflines find nothing to read
    names = {m["name"] for m in SPEC[kind] if "workloads" not in m and "roofline" not in m["name"]}
    assert names <= set(line["metrics"]), (names, line["metrics"])
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"]) and "breakdown" in line
        assert len(line["breakdown"]["device_ops"]) <= 10 and len(line["breakdown"]["idle_gaps"]) <= 10
    # the numbers compared, each beside its limit, are the last lines of standard error
    tail = err.strip().splitlines()[-3:]
    assert [t.split()[1] for t in tail] == ["frames", "mass", "phonons"] and all("limit" in t for t in tail)


def test_every_file_is_found_by_name():
    from benchmark.run import read_metric

    from qpsim_tpu_torch import run_2d_crank_nicolson

    engine = set(inspect.signature(run_2d_crank_nicolson).parameters)
    for c in SPEC["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"] and cfg["source"] == c["source"]
        assert set(cfg["physics"]) <= engine
        assert (ROOT / "benchmark" / "reference" / f"{cfg['reference']}.py").is_file()
    for w in SPEC["workloads"]:
        traffic = json.loads((ROOT / "benchmark" / "traffic" / f"{w['traffic']}.json").read_text())
        assert (ROOT / "benchmark" / "drivers" / f"{traffic['driver']}.py").is_file()
        assert traffic["steps_per_call"] % traffic["store_every"] == 0
        limits = json.loads((ROOT / "benchmark" / "limits" / f"{w['name']}.json").read_text())
        assert {"frames", "mass", "phonons"} <= set(limits)
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert callable(read_metric(m["name"]))
    assert (DATA / "traffic" / "tiny.json").is_file()


def test_benchmark_json_keeps_to_the_contract():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"] and SPEC["command"][1].startswith("benchmark/")
    assert 1 <= SPEC["run_seconds"] <= 51
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"}}
    for section, allowed in keys.items():
        for entry in SPEC[section]:
            assert set(entry) == allowed and NAME.match(entry["name"])
            assert 1 <= len(entry["why"]) <= 200
    metric_keys = {"end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
                   "per_layer": {"name", "unit", "better", "source", "layer", "moves", "workloads"}}
    names = set()
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for section, allowed in metric_keys.items():
        for m in SPEC[section]:
            assert set(m) <= allowed and NAME.match(m["name"]) and UNIT.match(m["unit"])
            assert m["better"] in ("lower", "higher") and m["name"] not in names
            names.add(m["name"])
            if section == "end_to_end":
                assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
            else:
                assert m["moves"] in e2e
    assert "setup_s" in e2e
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(set(pairs)) == len(pairs) and all(w["chips"] == 1 for w in SPEC["workloads"])


@pytest.mark.parametrize("ne,nw,collision,diffusion", [
    # by hand: q (16 planes) and n_ph (47) in and out once; the ADI step moves q alone
    (16, 47, 2 * (16 + 47) * 4, 2 * 16 * 4),
    (100, 299, 2 * (100 + 299) * 4, 2 * 100 * 4),
])
def test_work_counts_by_hand(ne, nw, collision, diffusion):
    from benchmark.reference import physics
    from benchmark.roofline import HBM_BYTES_PER_S, bound_s, state_bytes

    e, _ = physics.energy_grid(180.0, 1.0, 4.0, ne)
    assert physics.phonon_grid(e)[0].size == nw
    cells = 1008 * 1008
    assert state_bytes(ne + nw, cells, 4) == collision * cells
    assert state_bytes(ne, cells, 4) == diffusion * cells
    assert bound_s(collision * cells) == collision * cells / HBM_BYTES_PER_S


CHILD = """
import sys
sys.path.insert(0, {root!r})
from benchmark.tests.tinycell import run_tiny
rc, err, line = run_tiny()
assert rc == 0 and line["correct"], err
print(sorted({{m.split(".")[0] for m in sys.modules}} & {{"jax", "jaxlib", "flax", "qpsim_tpu"}}))
"""


def test_a_run_loads_no_jax():
    out = subprocess.run([sys.executable, "-c", CHILD.format(root=str(ROOT))],
                         capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


REFERENCE_CHILD = """
import sys
sys.path.insert(0, {root!r})
import numpy as np, torch, json
from benchmark.reference import uniform_film
cfg = json.load(open({cfg!r}))
mask = np.zeros((20, 20), bool); mask[4:-4, 4:-4] = True
uniform_film.simulate(cfg, mask, np.full((20, 20), 1e-5), 4, 2, "cpu", torch.float32)
print(sorted({{m.split(".")[0] for m in sys.modules}} & {{"jax", "jaxlib", "flax", "qpsim_tpu", "qpsim_tpu_torch"}}))
"""


def test_the_reference_imports_nothing_of_the_program():
    for path in (ROOT / "benchmark" / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            mods = ([a.name for a in node.names] if isinstance(node, ast.Import)
                    else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            assert not any(m.split(".")[0] in ("qpsim_tpu", "qpsim_tpu_torch", "jax", "jaxlib") for m in mods), path
    out = subprocess.run(
        [sys.executable, "-c", REFERENCE_CHILD.format(root=str(ROOT), cfg=str(DATA / "configs" / "tiny_film.json"))],
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.card
def test_a_cell_runs_on_the_card(card):
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "film16.pulse", "--seed", "5",
                          "--seconds", "1", "--trace", "0"], capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["kind"] == card
