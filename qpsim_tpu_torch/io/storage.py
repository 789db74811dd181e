"""Persistence: setups, simulations, precompute sidecars, test suites.

Carried over from ``qpsim_tpu.io.storage`` with the same file formats, so
a file written by either package loads in the other (and both follow the
reference simulator's ``qpsim/storage.py``):

* setups — JSON, ``data/setups/<slug>_<id12>.json``;
* precompute — ``.precompute.npz`` sidecar next to the setup JSON;
* simulations — JSON with NaN↔null frame encoding;
* test suites — **manifest format v3**: a manifest JSON whose geometry groups
  reference per-group sidecar JSON files in a same-named directory, with a
  path-escape guard; the legacy flat-case format is rejected.

Deserialization is reflection-driven: the dataclasses in ``models`` are the
single source of truth for field names and defaults, and loaders coerce JSON
payloads against them rather than repeating every field by hand.
"""

from __future__ import annotations

import json
import re
import uuid
from dataclasses import MISSING, asdict, fields
from pathlib import Path
from typing import Any, Callable

import numpy as np

from ..fields import canonicalize_initial_condition
from ..models.params import (
    BoundaryCondition,
    BoundaryFace,
    EdgeSegment,
    ExternalGenerationSpec,
    GeometryData,
    InitialConditionSpec,
    PhotonDriveSpec,
    SetupData,
    SimulationParameters,
    SimulationResultData,
    TestCaseResultData,
    TestGeometryGroupData,
    TestSuiteData,
    utc_now_iso,
)
from .paths import SETUPS_DIR, SIMULATIONS_DIR, TEST_CASES_DIR, ensure_data_dirs

TEST_SUITE_FORMAT_VERSION = 3

__all__ = [
    "TEST_SUITE_FORMAT_VERSION",
    "slugify_name",
    "frame_to_jsonable",
    "frame_from_jsonable",
    "serialize_setup",
    "deserialize_setup",
    "save_setup",
    "load_setup",
    "create_setup_id",
    "precompute_npz_path",
    "save_precomputed",
    "load_precomputed",
    "precomputed_exists",
    "serialize_simulation",
    "deserialize_simulation",
    "save_simulation",
    "load_simulation",
    "list_simulation_files",
    "create_simulation_id",
    "save_test_suite",
    "load_test_suite",
    "load_test_geometry_group",
    "deserialize_test_suite",
    "list_test_suite_files",
    "latest_test_suite_file",
]

_SLUG_UNSAFE = re.compile(r"[^a-zA-Z0-9_-]+")

#: Strings that deserialize as False (contract: how the reference reads
#: hand-edited boolean fields back in).
_FALSY_STRINGS = frozenset({"false", "0", "no", ""})


def slugify_name(name: str, fallback: str = "item") -> str:
    return _SLUG_UNSAFE.sub("_", name.strip()).strip("_") or fallback


def _as_bool(val: Any) -> bool:
    if isinstance(val, str):
        return val.lower() not in _FALSY_STRINGS
    return bool(val)


def _write_json(path: Path | str, payload: dict[str, Any]) -> Path:
    ensure_data_dirs()
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(payload, indent=2), encoding="utf-8")
    return path


def _read_json(path: Path) -> dict[str, Any]:
    return json.loads(Path(path).read_text(encoding="utf-8"))


def frame_to_jsonable(frame: np.ndarray) -> list[list[float | None]]:
    """2D array → nested lists with NaN encoded as null."""
    return [[None if np.isnan(v) else float(v) for v in row] for row in np.asarray(frame)]


def frame_from_jsonable(frame: list[list[float | None]]) -> np.ndarray:
    return np.array(
        [[np.nan if v is None else float(v) for v in row] for row in frame], dtype=np.float64
    )


# --- reflection-driven coercion ------------------------------------------------


def _float_list(values: Any) -> list[float]:
    return [float(v) for v in values]


def _float_list_or_none(values: Any) -> list[float] | None:
    return _float_list(values) if values else None


def _default_of(f) -> Any:
    if f.default is not MISSING:
        return f.default
    if f.default_factory is not MISSING:  # type: ignore[misc]
        return f.default_factory()  # type: ignore[misc]
    return MISSING


def _coercer_for(default: Any) -> Callable[[Any], Any]:
    """Pick a JSON→python coercer from a field's default value type."""
    if isinstance(default, bool):
        return _as_bool
    if isinstance(default, float):
        return float
    if isinstance(default, int):
        return int
    if isinstance(default, str):
        return str
    if isinstance(default, dict):
        return dict
    return lambda v: v


def _build_from_payload(cls, raw: dict[str, Any], overrides: dict[str, Callable] | None = None):
    """Construct ``cls`` from a JSON dict, defaulting and coercing per field.

    ``overrides`` maps a field name to ``raw-dict -> value`` for fields whose
    handling isn't derivable from the dataclass default (nested specs,
    nullable floats, falsy-means-default strings).
    """
    overrides = overrides or {}
    kwargs: dict[str, Any] = {}
    for f in fields(cls):
        if f.name in overrides:
            kwargs[f.name] = overrides[f.name](raw)
            continue
        default = _default_of(f)
        if default is MISSING:
            kwargs[f.name] = raw[f.name]
        elif f.name in raw:
            kwargs[f.name] = _coercer_for(default)(raw[f.name])
        else:
            kwargs[f.name] = default
    return cls(**kwargs)


# --- setups -----------------------------------------------------------------


def serialize_setup(setup: SetupData) -> dict[str, Any]:
    payload = asdict(setup)
    # File-format compatibility: the photon drive is a framework-only
    # extension (the reference lists the model as "Not yet Implemented").
    # A disabled drive writes NO key, so reference-era setups serialize
    # byte-identically and reference tooling sees nothing unfamiliar.
    params = payload.get("parameters", {})
    drive = params.get("photon_drive")
    if isinstance(drive, tuple):  # asdict preserves tuple drives
        drive = params["photon_drive"] = list(drive)
    if isinstance(drive, list):
        # multi-tone drives keep only their enabled modes; all-off -> no key
        kept = [
            d for d in drive
            if str(d.get("mode", "none")).strip().lower() != "none"
        ]
        if kept:
            params["photon_drive"] = kept
        else:
            params.pop("photon_drive", None)
    elif drive is not None and str(drive.get("mode", "none")).strip().lower() == "none":
        params.pop("photon_drive", None)
    return payload


def _generation_from(raw: Any) -> ExternalGenerationSpec:
    if not raw:
        return ExternalGenerationSpec()
    return _build_from_payload(ExternalGenerationSpec, raw)


def _nullable_float(name: str) -> Callable[[dict], float | None]:
    def pick(raw: dict) -> float | None:
        val = raw.get(name)
        return None if val is None else float(val)

    return pick


_PARAM_OVERRIDES: dict[str, Callable] = {
    # Required numerics (no dataclass default) arrive as JSON numbers/strings.
    "diffusion_coefficient": lambda p: float(p["diffusion_coefficient"]),
    "dt": lambda p: float(p["dt"]),
    "total_time": lambda p: float(p["total_time"]),
    "mesh_size": lambda p: float(p["mesh_size"]),
    # Falsy (null / "") means "use the registry default".
    "collision_solver": lambda p: str(p.get("collision_solver") or "fischer_catelani_local"),
    # tau_s / tau_r stay None when absent so tau_0 aliasing can resolve them.
    "tau_s": _nullable_float("tau_s"),
    "tau_r": _nullable_float("tau_r"),
    "external_generation": lambda p: _generation_from(p.get("external_generation")),
    # Absent in reference-era files (new capability): default = drive off.
    # A list payload is a multi-tone drive (one spec per mode, in order).
    "photon_drive": lambda p: _photon_drive_from(p.get("photon_drive")),
}


def _photon_drive_from(raw: Any):
    if not raw:
        return PhotonDriveSpec()
    coercions = {
        "window_start": _nullable_float("window_start"),
        "window_duration": _nullable_float("window_duration"),
    }
    if isinstance(raw, list):
        return [_build_from_payload(PhotonDriveSpec, r, coercions) for r in raw]
    return _build_from_payload(PhotonDriveSpec, raw, coercions)


def _parameters_from(raw: dict[str, Any]) -> SimulationParameters:
    return _build_from_payload(SimulationParameters, raw, _PARAM_OVERRIDES)


def _initial_condition_from(raw: dict[str, Any]) -> InitialConditionSpec:
    # Every IC field defaults empty on load ("", {}, False by slot type) —
    # deliberately NOT the dataclass defaults: a missing key in a hand-edited
    # file must not resurrect an example expression body.
    kwargs: dict[str, Any] = {}
    for f in fields(InitialConditionSpec):
        if f.name.endswith("_enabled"):
            kwargs[f.name] = _as_bool(raw.get(f.name, False))
        elif f.name.endswith("_params"):
            kwargs[f.name] = raw.get(f.name, {})
        else:
            kwargs[f.name] = raw.get(f.name, "")
    return InitialConditionSpec(**kwargs)


def _geometry_from(raw: dict[str, Any]) -> GeometryData:
    def edge_from(e: dict[str, Any]) -> EdgeSegment:
        faces = [BoundaryFace(**face) for face in e["faces"]]
        return EdgeSegment(**{**{k: e[k] for k in ("edge_id", "x0", "y0", "x1", "y1", "normal")}, "faces": faces})

    return _build_from_payload(
        GeometryData,
        raw,
        {
            "layer": lambda g: int(g["layer"]),
            "mesh_size": lambda g: float(g["mesh_size"]),
            "edges": lambda g: [edge_from(e) for e in g["edges"]],
            "bounds": lambda g: g.get("bounds"),
        },
    )


def deserialize_setup(payload: dict[str, Any]) -> SetupData:
    boundary_conditions = {
        edge_id: BoundaryCondition(
            kind=bc["kind"], value=bc.get("value"), aux_value=bc.get("aux_value")
        )
        for edge_id, bc in payload.get("boundary_conditions", {}).items()
    }
    return SetupData(
        setup_id=payload["setup_id"],
        name=payload["name"],
        created_at=payload.get("created_at", utc_now_iso()),
        geometry=_geometry_from(payload["geometry"]),
        boundary_conditions=boundary_conditions,
        parameters=_parameters_from(payload["parameters"]),
        initial_condition=canonicalize_initial_condition(
            _initial_condition_from(payload.get("initial_condition", {}))
        ),
    )


def save_setup(setup: SetupData, path: Path | None = None) -> Path:
    if path is None:
        path = SETUPS_DIR / f"{slugify_name(setup.name, 'setup')}_{setup.setup_id}.json"
    return _write_json(path, serialize_setup(setup))


def _deserialize_file(path: Path, what: str, fn):
    """Run a deserializer, reporting structural damage as ValueError.

    Hand-edited or corrupt files otherwise leak KeyError/TypeError/
    AttributeError through the loaders (found by mutation fuzzing), which
    callers with clean-error contracts (the CLI) don't catch.
    """
    try:
        return fn(_read_json(path))
    except ValueError:
        raise
    except (KeyError, TypeError, AttributeError, IndexError) as exc:
        raise ValueError(
            f"Corrupt or invalid {what} file {path}: {type(exc).__name__}: {exc}"
        ) from exc


def load_setup(path: str | Path) -> SetupData:
    return _deserialize_file(Path(path), "setup", deserialize_setup)


def create_setup_id() -> str:
    return uuid.uuid4().hex[:12]


# --- precompute sidecars -----------------------------------------------------


def precompute_npz_path(setup_path: Path) -> Path:
    return Path(setup_path).with_suffix(".precompute.npz")


def save_precomputed(setup_path: Path, arrays: dict) -> Path:
    npz_path = precompute_npz_path(setup_path)
    np.savez(str(npz_path), **arrays)
    return npz_path


def load_precomputed(setup_path: Path) -> dict:
    npz_path = precompute_npz_path(setup_path)
    try:
        return dict(np.load(str(npz_path), allow_pickle=False))
    except (ValueError, FileNotFoundError):
        raise
    except Exception as exc:  # truncated zip etc. (zipfile.BadZipFile)
        raise ValueError(
            f"Corrupt precompute sidecar {npz_path}: {type(exc).__name__}: {exc}"
        ) from exc


def precomputed_exists(setup_path: Path) -> bool:
    return precompute_npz_path(setup_path).exists()


# --- simulations --------------------------------------------------------------


def serialize_simulation(result: SimulationResultData) -> dict[str, Any]:
    return asdict(result)


_SIMULATION_OVERRIDES: dict[str, Callable] = {
    "created_at": lambda p: p.get("created_at", utc_now_iso()),
    "times": lambda p: _float_list(p["times"]),
    "mass_over_time": lambda p: _float_list(p["mass_over_time"]),
    "color_limits": lambda p: _float_list(p["color_limits"]),
    "energy_bins": lambda p: _float_list_or_none(p.get("energy_bins")),
    "phonon_energy_bins": lambda p: _float_list_or_none(p.get("phonon_energy_bins")),
}


def deserialize_simulation(payload: dict[str, Any]) -> SimulationResultData:
    return _build_from_payload(SimulationResultData, payload, _SIMULATION_OVERRIDES)


def save_simulation(result: SimulationResultData, path: Path | None = None) -> Path:
    if path is None:
        path = (
            SIMULATIONS_DIR
            / f"{slugify_name(result.setup_name, 'simulation')}_{result.simulation_id}.json"
        )
    return _write_json(path, serialize_simulation(result))


def load_simulation(path: str | Path) -> SimulationResultData:
    return _deserialize_file(Path(path), "simulation", deserialize_simulation)


def list_simulation_files() -> list[Path]:
    ensure_data_dirs()
    return sorted(SIMULATIONS_DIR.glob("*.json"))


def create_simulation_id() -> str:
    return uuid.uuid4().hex[:12]


# --- test suites (manifest v3 + per-group sidecars) ----------------------------


def _test_case_from(case: dict[str, Any]) -> TestCaseResultData:
    return _build_from_payload(
        TestCaseResultData,
        case,
        {
            "x": lambda c: _float_list(c.get("x", [])),
            "times": lambda c: _float_list(c["times"]),
        },
    )


def _int_mask(rows: Any) -> list[list[int]]:
    return [[int(v) for v in row] for row in rows]


def _group_from_inline(group: dict[str, Any]) -> TestGeometryGroupData:
    cases = [_test_case_from(c) for c in group.get("cases", [])]
    return _build_from_payload(
        TestGeometryGroupData,
        group,
        {
            "view_mode": lambda g: g.get("view_mode", "line1d"),
            "preview_mask": lambda g: _int_mask(g.get("preview_mask", [])),
            "cases": lambda g: cases,
            "case_count": lambda g: int(g.get("case_count", len(cases))),
            "group_file": lambda g: g.get("group_file"),
        },
    )


def _sidecar_path(manifest_path: Path, group_file: str) -> Path:
    suite_dir = manifest_path.with_suffix("")
    rel = Path(group_file)
    if rel.is_absolute():
        raise ValueError(f"Geometry group sidecar must be a relative path, got '{group_file}'.")
    resolved = (suite_dir / rel).resolve()
    try:
        resolved.relative_to(suite_dir.resolve())
    except ValueError as exc:
        raise ValueError(
            f"Geometry group sidecar '{group_file}' escapes suite directory '{suite_dir}'."
        ) from exc
    return resolved


def load_test_geometry_group(manifest_path: str | Path, geometry_id: str) -> TestGeometryGroupData:
    manifest_path = Path(manifest_path)
    payload = _read_json(manifest_path)
    raw = next(
        (g for g in payload.get("geometry_groups", []) if g.get("geometry_id") == geometry_id),
        None,
    )
    if raw is None:
        raise ValueError(f"Geometry group '{geometry_id}' not found in suite manifest.")
    if raw.get("cases"):
        return _group_from_inline(raw)
    group_file = raw.get("group_file")
    if not group_file:
        raise ValueError(f"Geometry group '{geometry_id}' has no group file reference.")
    group_payload = _read_json(_sidecar_path(manifest_path, str(group_file)))
    group = _group_from_inline(group_payload.get("group", group_payload))
    if group.case_count <= 0:
        group.case_count = int(raw.get("case_count", len(group.cases)))
    if not group.preview_mask:
        group.preview_mask = _int_mask(raw.get("preview_mask", []))
    group.group_file = group_file
    if group.case_count <= 0:
        group.case_count = len(group.cases)
    return group


def deserialize_test_suite(
    payload: dict[str, Any],
    manifest_path: Path | None = None,
    load_group_cases: bool = True,
) -> TestSuiteData:
    groups_raw = payload.get("geometry_groups")
    if not groups_raw:
        raise ValueError(
            "Test suite manifest missing 'geometry_groups'. "
            "Legacy flat-case suite format is no longer supported."
        )
    groups: list[TestGeometryGroupData] = []
    for raw in groups_raw:
        group = _group_from_inline(raw)
        if load_group_cases and not group.cases and manifest_path is not None and group.group_file:
            try:
                group = load_test_geometry_group(manifest_path, group.geometry_id)
            except Exception as exc:
                raise ValueError(
                    f"Failed to load geometry group '{group.geometry_id}' "
                    f"from sidecar '{group.group_file}'."
                ) from exc
        groups.append(group)
    cases: list[TestCaseResultData] = []
    for group in groups:
        cases.extend(group.cases)
    return TestSuiteData(
        suite_id=payload["suite_id"],
        created_at=payload.get("created_at", utc_now_iso()),
        cases=cases,
        geometry_groups=groups,
        metadata=payload.get("metadata", {}),
    )


def save_test_suite(suite: TestSuiteData, path: Path | None = None) -> Path:
    if path is None:
        path = TEST_CASES_DIR / f"test_suite_{suite.suite_id}.json"
    if not suite.geometry_groups:
        raise ValueError("Test suite must contain at least one geometry group.")
    suite_dir = path.with_suffix("")

    summaries: list[dict[str, Any]] = []
    for group in suite.geometry_groups:
        group_file = f"{slugify_name(group.geometry_id, 'group')}.json"
        full = TestGeometryGroupData(
            geometry_id=group.geometry_id,
            title=group.title,
            description=group.description,
            view_mode=group.view_mode,
            preview_mask=group.preview_mask,
            cases=list(group.cases),
            case_count=len(group.cases),
            group_file=group_file,
        )
        _write_json(suite_dir / group_file, {"suite_id": suite.suite_id, "group": asdict(full)})
        summary = {**asdict(full), "cases": []}
        summaries.append(summary)
    metadata = dict(suite.metadata or {})
    metadata["format_version"] = max(
        TEST_SUITE_FORMAT_VERSION, int(metadata.get("format_version", 0))
    )
    return _write_json(
        path,
        {
            "suite_id": suite.suite_id,
            "created_at": suite.created_at,
            "cases": [],
            "geometry_groups": summaries,
            "metadata": metadata,
        },
    )


def load_test_suite(path: str | Path, load_group_cases: bool = True) -> TestSuiteData:
    path = Path(path)
    return _deserialize_file(
        path,
        "test-suite manifest",
        lambda payload: deserialize_test_suite(
            payload, manifest_path=path, load_group_cases=load_group_cases
        ),
    )


def list_test_suite_files() -> list[Path]:
    ensure_data_dirs()
    return sorted(TEST_CASES_DIR.glob("*.json"))


def latest_test_suite_file() -> Path | None:
    files = list_test_suite_files()
    return max(files, key=lambda p: p.stat().st_mtime) if files else None
