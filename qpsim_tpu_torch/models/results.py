"""Result and test-suite artifact types (JSON contract, reference models.py:214-266).

These are the shapes the storage layer serializes: simulation outputs with
NaN-masked frames, and the analytic test-case suite browsed by the viewers.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

__all__ = [
    "SimulationResultData",
    "TestCaseResultData",
    "TestGeometryGroupData",
    "TestSuiteData",
]

JsonDict = dict[str, Any]

#: NaN-masked 2D snapshot as stored in JSON (None marks outside-mask cells).
Frame2D = list[list[float | None]]


@dataclass
class SimulationResultData:
    simulation_id: str
    setup_id: str
    setup_name: str
    created_at: str
    times: list[float]
    frames: list[Frame2D]
    mass_over_time: list[float]
    color_limits: list[float]
    metadata: JsonDict = field(default_factory=dict)
    energy_frames: list[list[Frame2D]] | None = None
    phonon_frames: list[Frame2D] | None = None
    phonon_energy_frames: list[list[Frame2D]] | None = None
    phonon_energy_bins: list[float] | None = None
    phonon_metadata: JsonDict | None = None
    energy_bins: list[float] | None = None


@dataclass
class TestCaseResultData:
    __test__ = False  # keep pytest from collecting this as a test class
    case_id: str
    title: str
    boundary_label: str
    formula_latex: str
    initial_condition_latex: str
    description: str
    x: list[float]
    times: list[float]
    simulated: list[Any]
    analytic: list[Any]
    metadata: JsonDict = field(default_factory=dict)


@dataclass
class TestGeometryGroupData:
    __test__ = False
    geometry_id: str
    title: str
    description: str
    view_mode: str
    preview_mask: list[list[int]]
    cases: list[TestCaseResultData] = field(default_factory=list)
    case_count: int = 0
    group_file: str | None = None


@dataclass
class TestSuiteData:
    __test__ = False
    suite_id: str
    created_at: str
    cases: list[TestCaseResultData] = field(default_factory=list)
    geometry_groups: list[TestGeometryGroupData] = field(default_factory=list)
    metadata: JsonDict = field(default_factory=dict)
