"""Typed configuration model for qpsim_tpu_torch (carried over from qpsim_tpu).

These dataclasses are the JSON compatibility contract with the reference
simulator (``reference qpsim/models.py``): field NAMES, DEFAULTS and
validation SEMANTICS match so that setups, simulations and test suites
written by either implementation load in the other.  The prose around the
contract — helpers, rule tables, error text — is this repo's own.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from datetime import datetime, timezone
from typing import Any

from .geometry_types import BoundaryFace, EdgeSegment, GeometryData
from .results import (
    SimulationResultData,
    TestCaseResultData,
    TestGeometryGroupData,
    TestSuiteData,
)

__all__ = [
    "BOUNDARY_KINDS",
    "COLLISION_SOLVERS",
    "EXTERNAL_GENERATION_MODES",
    "BoundaryCondition",
    "BoundaryFace",
    "EdgeSegment",
    "GeometryData",
    "InitialConditionSpec",
    "ExternalGenerationSpec",
    "SimulationParameters",
    "SetupData",
    "SimulationResultData",
    "TestCaseResultData",
    "TestGeometryGroupData",
    "TestSuiteData",
    "normalize_collision_solver_name",
    "utc_now_iso",
]

#: Supported per-edge boundary-condition kinds (reference models.py:8-14).
BOUNDARY_KINDS = frozenset({"reflective", "neumann", "dirichlet", "absorbing", "robin"})

#: Boundary kinds whose discretization consumes a numeric ``value``.
_VALUE_CARRYING_KINDS = frozenset({"neumann", "dirichlet", "robin"})

#: Registered collision integrators (reference models.py:15).
COLLISION_SOLVERS = frozenset({"fischer_catelani_local"})

#: External quasiparticle generation modes (reference models.py:16).
EXTERNAL_GENERATION_MODES = frozenset({"none", "constant", "pulse", "custom"})

#: Shared default expression bodies (deduplicated across IC fields).
_DEFAULT_BLOB = "return np.exp(-((x-0.5)**2 + (y-0.5)**2) / 0.02)"
_DEFAULT_FULL_CUSTOM = _DEFAULT_BLOB + " * np.exp(-E / 500.0)"
_DEFAULT_FLAT_WEIGHTS = "return np.ones_like(E)"

JsonDict = dict[str, Any]


def _params_field() -> Any:
    """A fresh-dict dataclass field (every *_params slot in the contract)."""
    return field(default_factory=dict)


def _check(ok: bool, problem: str) -> None:
    if not ok:
        raise ValueError(problem)


def utc_now_iso() -> str:
    return datetime.now(timezone.utc).isoformat()


def normalize_collision_solver_name(value: str) -> str:
    name = str(value).strip().lower()
    _check(
        name in COLLISION_SOLVERS,
        f"Unsupported collision solver '{value}'. "
        f"Supported values: {', '.join(sorted(COLLISION_SOLVERS))}.",
    )
    return name


@dataclass
class BoundaryCondition:
    """Per-edge boundary condition.

    ``value`` / ``aux_value`` meaning by kind:
      reflective — unused; absorbing — unused;
      dirichlet — value = boundary density g;
      neumann   — value = inward flux q;
      robin     — value = beta (extraction), aux_value = gamma (injection).
    """

    kind: str
    value: float | None = None
    aux_value: float | None = None

    def normalized_kind(self) -> str:
        return self.kind.strip().lower()

    def validate(self) -> None:
        kind = self.normalized_kind()
        _check(kind in BOUNDARY_KINDS, f"Unsupported boundary condition kind: {self.kind}")
        if kind in _VALUE_CARRYING_KINDS:
            _check(self.value is not None, f"Boundary condition '{kind}' requires a numeric value")


@dataclass
class InitialConditionSpec:
    """Split spatial × energy initial condition for QPs and phonons.

    Mirrors reference models.py:82-108 field-for-field (JSON contract):
    QP spatial kinds gaussian/uniform/point/custom, QP energy kinds
    dos/fermi_dirac/uniform/custom, phonon energy kinds
    bose_einstein/uniform/custom, plus optional non-separable full-custom
    initializers F(x, y, E) on either species.
    """

    spatial_kind: str = ""
    spatial_params: JsonDict = _params_field()
    spatial_custom_body: str = _DEFAULT_BLOB
    spatial_custom_params: JsonDict = _params_field()
    energy_kind: str = ""
    energy_params: JsonDict = _params_field()
    energy_custom_body: str = _DEFAULT_FLAT_WEIGHTS
    energy_custom_params: JsonDict = _params_field()
    qp_full_custom_enabled: bool = False
    qp_full_custom_body: str = _DEFAULT_FULL_CUSTOM
    qp_full_custom_params: JsonDict = _params_field()
    phonon_spatial_kind: str = ""
    phonon_spatial_params: JsonDict = _params_field()
    phonon_spatial_custom_body: str = "return 1.0"
    phonon_spatial_custom_params: JsonDict = _params_field()
    phonon_energy_kind: str = ""
    phonon_energy_params: JsonDict = _params_field()
    phonon_energy_custom_body: str = _DEFAULT_FLAT_WEIGHTS
    phonon_energy_custom_params: JsonDict = _params_field()
    phonon_full_custom_enabled: bool = False
    phonon_full_custom_body: str = _DEFAULT_FULL_CUSTOM
    phonon_full_custom_params: JsonDict = _params_field()


@dataclass
class ExternalGenerationSpec:
    """External QP generation g_ext(E, x, y, t) in μeV⁻¹ μm⁻² ns⁻¹."""

    mode: str = "none"
    rate: float = 0.0
    pulse_start: float = 0.0
    pulse_duration: float = 10.0
    pulse_rate: float = 0.0
    custom_body: str = "return 0.0"
    custom_params: JsonDict = _params_field()

    def normalized_mode(self) -> str:
        return self.mode.strip().lower()

    def validate(self) -> None:
        _check(
            self.normalized_mode() in EXTERNAL_GENERATION_MODES,
            f"Unsupported external generation mode '{self.mode}'. "
            f"Supported: {', '.join(sorted(EXTERNAL_GENERATION_MODES))}.",
        )
        non_negative = {
            "constant rate": self.rate,
            "pulse rate": self.pulse_rate,
            "pulse_duration": self.pulse_duration,
        }
        for label, val in non_negative.items():
            _check(val >= 0, f"External generation {label} must be non-negative.")


@dataclass
class PhotonDriveSpec:
    """Resonator-photon drive (Fischer et al. 2024 pair-breaking photons).

    A single photon mode of energy ``photon_energy`` (µeV) and occupation
    ``occupancy`` (n̄) coupled to the QP gas with rate constant ``coupling``
    (the paper's c^QP_Phot, 1/ns).  ``include_scattering`` enables the
    number-conserving absorption/emission redistribution (paper Eq. 3);
    ``include_pair_breaking`` the generation/recombination vertex (Eqs.
    4–5, active only when ω > 2Δ).  An optional window gates the drive in
    time like a generation pulse.  New capability — the reference lists
    this model in its own "Not yet Implemented" queue.
    """

    mode: str = "none"                  # {"none", "photon"}
    photon_energy: float = 0.0          # ω (µeV)
    occupancy: float = 0.0              # n̄
    coupling: float = 0.0               # c (1/ns)
    include_scattering: bool = True
    include_pair_breaking: bool = True
    window_start: float | None = None   # ns; None = always on
    window_duration: float | None = None

    def normalized_mode(self) -> str:
        return self.mode.strip().lower()

    @property
    def enabled(self) -> bool:
        return self.normalized_mode() == "photon"

    def validate(self) -> None:
        _check(
            self.normalized_mode() in {"none", "photon"},
            f"Unsupported photon drive mode '{self.mode}'. Supported: none, photon.",
        )
        if not self.enabled:
            return
        _check(self.photon_energy > 0, "Photon drive photon_energy must be positive.")
        _check(self.occupancy >= 0, "Photon drive occupancy must be non-negative.")
        _check(self.coupling >= 0, "Photon drive coupling must be non-negative.")
        _check(
            self.include_scattering or self.include_pair_breaking,
            "Photon drive needs at least one of scattering / pair breaking enabled.",
        )
        if self.window_start is not None or self.window_duration is not None:
            _check(
                self.window_start is not None and self.window_duration is not None,
                "Photon drive window needs both window_start and window_duration.",
            )
            _check(self.window_duration >= 0, "Photon drive window_duration must be non-negative.")


def photon_drive_specs(photon_drive) -> tuple[PhotonDriveSpec, ...]:
    """Normalize a photon-drive argument to the tuple of ENABLED modes.

    Accepts ``None``, one :class:`PhotonDriveSpec`, or a sequence of them
    (a multi-tone drive, e.g. readout + pump — the modes apply
    sequentially each step, in order; each substep alone is an exact
    thermal fixed point, so the composition preserves detailed balance).
    Every spec is validated, enabled or not.
    """
    if photon_drive is None:
        return ()
    specs = (
        tuple(photon_drive)
        if isinstance(photon_drive, (list, tuple))
        else (photon_drive,)
    )
    for spec in specs:
        spec.validate()
    return tuple(s for s in specs if s.enabled)


@dataclass
class SimulationParameters:
    """All physics / numerics parameters for one run.

    Units: lengths μm, time ns, energies μeV, temperatures K, D in μm²/ns.
    ``energy_gap == 0`` selects the legacy scalar (energy-integrated) mode.
    """

    diffusion_coefficient: float
    dt: float
    total_time: float
    mesh_size: float
    store_every: int = 1
    energy_gap: float = 0.0
    energy_min_factor: float = 1.0
    energy_max_factor: float = 10.0
    num_energy_bins: int = 50
    dynes_gamma: float = 0.0
    gap_expression: str = ""
    collision_solver: str = "fischer_catelani_local"
    enable_diffusion: bool = True
    enable_recombination: bool = False
    enable_scattering: bool = False
    tau_0: float = 440.0
    tau_s: float | None = None
    tau_r: float | None = None
    T_c: float = 1.2
    bath_temperature: float = 0.1
    export_phonon_history: bool = False
    external_generation: ExternalGenerationSpec = field(default_factory=ExternalGenerationSpec)
    # one PhotonDriveSpec, or a list of them for multi-tone drives
    # (photon_drive_specs normalizes either form)
    photon_drive: PhotonDriveSpec | list[PhotonDriveSpec] = field(
        default_factory=PhotonDriveSpec
    )

    def __post_init__(self) -> None:
        self.collision_solver = normalize_collision_solver_name(self.collision_solver)
        self._resolve_taus()
        self._validate_timestep()
        self._validate_collisions()
        self._validate_energy_grid()
        self.external_generation.validate()
        if photon_drive_specs(self.photon_drive):
            _check(
                self.energy_gap > 0,
                "Photon drive needs the energy-resolved mode (energy_gap > 0).",
            )

    def _resolve_taus(self) -> None:
        # tau_0 is a convenience default for tau_s / tau_r; after resolution
        # it is re-synchronised to their mean (reference models.py:168-175).
        if self.tau_s is None:
            self.tau_s = float(self.tau_0)
        if self.tau_r is None:
            self.tau_r = float(self.tau_0)
        self.tau_0 = 0.5 * (self.tau_s + self.tau_r)

    def _validate_timestep(self) -> None:
        for label in ("dt", "total_time", "mesh_size"):
            _check(getattr(self, label) > 0, f"{label} must be positive.")
        _check(self.bath_temperature >= 0, "bath_temperature must be non-negative.")

    def _validate_collisions(self) -> None:
        if not (self.enable_recombination or self.enable_scattering):
            return
        suffix = "must be positive when recombination or scattering is enabled."
        for label in ("T_c", "tau_s", "tau_r"):
            _check(getattr(self, label) > 0, f"{label} {suffix}")

    def _validate_energy_grid(self) -> None:
        if self.energy_gap <= 0:
            return
        _check(self.energy_min_factor >= 1.0, "energy_min_factor must be >= 1.0 when energy_gap > 0.")
        _check(
            self.energy_max_factor > self.energy_min_factor,
            "energy_max_factor must be > energy_min_factor when energy_gap > 0.",
        )
        _check(self.num_energy_bins >= 2, "num_energy_bins must be >= 2 when energy_gap > 0.")


@dataclass
class SetupData:
    setup_id: str
    name: str
    created_at: str
    geometry: GeometryData
    boundary_conditions: dict[str, BoundaryCondition]
    parameters: SimulationParameters
    initial_condition: InitialConditionSpec
