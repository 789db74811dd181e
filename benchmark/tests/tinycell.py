"""A tiny cell of the benchmark (40 × 40 grid, 8 bins, 60-step jobs) run through the harness on the CPU."""

from __future__ import annotations

import io
import json
import sys
from contextlib import redirect_stderr, redirect_stdout
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
DATA = Path(__file__).resolve().parent / "data"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def tiny_spec() -> dict:
    """BENCHMARK.json with the tiny cell added."""
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny_film", "file": "benchmark/tests/data/configs/tiny_film.json",
                            "reduced": []})
    spec["workloads"].append({"name": "tiny.cell", "config": "tiny_film", "traffic": "tiny", "chips": 1})
    return spec


def run_tiny(seed: int = 2**31 + 17, seconds: float = 1.0, trace: int = 0) -> tuple[int, str, dict | None]:
    """One run of the tiny cell on the CPU: (exit code, standard error, the result line or None)."""
    from benchmark import run

    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = run.main(["--workload", "tiny.cell", "--seed", str(seed), "--seconds", str(seconds),
                       "--trace", str(trace)], device="cpu", spec=tiny_spec(), data=DATA)
    lines = out.getvalue().strip().splitlines()
    return rc, err.getvalue(), (json.loads(lines[-1]) if lines else None)
