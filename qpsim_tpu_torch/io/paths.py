"""Repo-rooted data directory layout (carried over from ``qpsim_tpu.io.paths``).

The same ``data/{setups,simulations,test_cases}`` directories under the
repository root, so that both packages read and write the same files.
"""

from __future__ import annotations

from pathlib import Path

BASE_DIR = Path(__file__).resolve().parent.parent.parent
DATA_DIR = BASE_DIR / "data"
SETUPS_DIR = DATA_DIR / "setups"
SIMULATIONS_DIR = DATA_DIR / "simulations"
TEST_CASES_DIR = DATA_DIR / "test_cases"


def ensure_data_dirs() -> None:
    for directory in (DATA_DIR, SETUPS_DIR, SIMULATIONS_DIR, TEST_CASES_DIR):
        directory.mkdir(parents=True, exist_ok=True)
