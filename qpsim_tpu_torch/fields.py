"""Initial-condition and gap-map evaluation (host side).

Carried over from ``qpsim_tpu.fields`` and pinned equal to it: the numpy
arrays that seed a simulation — spatial profiles, energy weights, full
non-separable F(x, y, E) states for QPs and phonons, and the spatially
varying gap map Δ(x, y).  Evaluated on the host in float64 and uploaded
once; behaviour matches the reference's ``qpsim/initial_conditions.py``
(kinds, defaults, shape coercion rules, validation) with a single unified
Boltzmann constant (see ``qpsim_tpu_torch.constants``).

Coordinate convention: pixel centers normalised to (0, 1):
x = (col + 0.5)/nx, y = (row + 0.5)/ny.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from .expr.safe_eval import compile_safe_expression
from .models.params import InitialConditionSpec
from .ops.dos import bose_einstein_occupation, thermal_qp_weights

__all__ = [
    "default_initial_condition",
    "canonicalize_initial_condition",
    "build_initial_field",
    "build_initial_phonon_spatial_field",
    "build_initial_energy_weights",
    "build_initial_qp_energy_state",
    "build_initial_phonon_energy_weights",
    "build_initial_phonon_energy_state",
    "evaluate_gap_expression",
    "normalized_pixel_coords",
]

_DEFAULTS = {
    "spatial_custom_body": "return np.exp(-((x-0.5)**2 + (y-0.5)**2) / 0.02)",
    "energy_custom_body": "return np.ones_like(E)",
    "qp_full_custom_body": (
        "return np.exp(-((x-0.5)**2 + (y-0.5)**2) / 0.02) * np.exp(-E / 500.0)"
    ),
    "phonon_spatial_custom_body": "return 1.0",
    "phonon_energy_custom_body": "return np.ones_like(E)",
    "phonon_full_custom_body": (
        "return np.exp(-((x-0.5)**2 + (y-0.5)**2) / 0.02) * np.exp(-E / 500.0)"
    ),
}
_DEFAULT_SPATIAL = ("gaussian", {"amplitude": 1.0, "x0": 0.5, "y0": 0.5, "sigma": 0.12})
_DEFAULT_PH_SPATIAL = ("uniform", {"value": 1.0})


def _truthy(value: Any) -> bool:
    if isinstance(value, bool):
        return value
    if isinstance(value, str):
        return value.strip().lower() in {"1", "true", "yes", "on"}
    return bool(value)


def default_initial_condition() -> InitialConditionSpec:
    return InitialConditionSpec(
        spatial_kind=_DEFAULT_SPATIAL[0],
        spatial_params=dict(_DEFAULT_SPATIAL[1]),
        spatial_custom_body=_DEFAULTS["spatial_custom_body"],
        energy_kind="dos",
        energy_custom_body=_DEFAULTS["energy_custom_body"],
        qp_full_custom_body=_DEFAULTS["qp_full_custom_body"],
        phonon_spatial_kind=_DEFAULT_PH_SPATIAL[0],
        phonon_spatial_params=dict(_DEFAULT_PH_SPATIAL[1]),
        phonon_spatial_custom_body=_DEFAULTS["phonon_spatial_custom_body"],
        phonon_energy_kind="bose_einstein",
        phonon_energy_custom_body=_DEFAULTS["phonon_energy_custom_body"],
        phonon_full_custom_body=_DEFAULTS["phonon_full_custom_body"],
    )


def _resolve(kind: str | None, params, body, body_default, custom_params, fallback):
    kind_norm = str(kind or "").strip().lower()
    if not kind_norm:
        return fallback[0], dict(fallback[1]), body_default, {}
    return (
        kind_norm,
        dict(params or {}),
        str(body or body_default),
        dict(custom_params or {}),
    )


def canonicalize_initial_condition(spec: InitialConditionSpec) -> InitialConditionSpec:
    """Fill defaults and normalise kinds; output round-trips through JSON."""
    sk, sp, sb, scp = _resolve(
        spec.spatial_kind,
        spec.spatial_params,
        spec.spatial_custom_body,
        _DEFAULTS["spatial_custom_body"],
        spec.spatial_custom_params,
        _DEFAULT_SPATIAL,
    )
    ek, ep, eb, ecp = _resolve(
        spec.energy_kind,
        spec.energy_params,
        spec.energy_custom_body,
        _DEFAULTS["energy_custom_body"],
        spec.energy_custom_params,
        ("dos", {}),
    )
    psk, psp, psb, pscp = _resolve(
        spec.phonon_spatial_kind,
        spec.phonon_spatial_params,
        spec.phonon_spatial_custom_body,
        _DEFAULTS["phonon_spatial_custom_body"],
        spec.phonon_spatial_custom_params,
        _DEFAULT_PH_SPATIAL,
    )
    pek, pep, peb, pecp = _resolve(
        spec.phonon_energy_kind,
        spec.phonon_energy_params,
        spec.phonon_energy_custom_body,
        _DEFAULTS["phonon_energy_custom_body"],
        spec.phonon_energy_custom_params,
        ("bose_einstein", {}),
    )
    return InitialConditionSpec(
        spatial_kind=sk,
        spatial_params=sp,
        spatial_custom_body=sb,
        spatial_custom_params=scp,
        energy_kind=ek,
        energy_params=ep,
        energy_custom_body=eb,
        energy_custom_params=ecp,
        qp_full_custom_enabled=_truthy(spec.qp_full_custom_enabled),
        qp_full_custom_body=str(spec.qp_full_custom_body or _DEFAULTS["qp_full_custom_body"]),
        qp_full_custom_params=dict(spec.qp_full_custom_params or {}),
        phonon_spatial_kind=psk,
        phonon_spatial_params=psp,
        phonon_spatial_custom_body=psb,
        phonon_spatial_custom_params=pscp,
        phonon_energy_kind=pek,
        phonon_energy_params=pep,
        phonon_energy_custom_body=peb,
        phonon_energy_custom_params=pecp,
        phonon_full_custom_enabled=_truthy(spec.phonon_full_custom_enabled),
        phonon_full_custom_body=str(
            spec.phonon_full_custom_body or _DEFAULTS["phonon_full_custom_body"]
        ),
        phonon_full_custom_params=dict(spec.phonon_full_custom_params or {}),
    )


def normalized_pixel_coords(mask: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per-cell normalised (x, y) coordinate planes for a 2D mask."""
    ny, nx = mask.shape
    rows, cols = np.indices(mask.shape)
    return (cols + 0.5) / max(1, nx), (rows + 0.5) / max(1, ny)


def _eval_spatial_custom(
    body: str,
    x_norm: np.ndarray,
    y_norm: np.ndarray,
    mask: np.ndarray,
    params: dict,
) -> np.ndarray:
    """Vectorised evaluation with a per-pixel scalar fallback."""
    fn = compile_safe_expression(body, variable_names=("x", "y", "params"))
    mx, my = x_norm[mask], y_norm[mask]
    if mx.size == 0:
        return np.empty((0,), dtype=np.float64)
    try:
        raw = np.asarray(fn(x=mx, y=my, params=params), dtype=np.float64)
        if raw.ndim == 0:
            return np.full(mx.shape[0], float(raw))
        if raw.size == mx.size:
            return raw.reshape(mx.size)
        if raw.shape == mask.shape:
            return np.asarray(raw[mask], dtype=np.float64)
    except Exception:
        pass
    out = np.empty(mx.size, dtype=np.float64)
    for i in range(mx.size):
        out[i] = float(fn(x=float(mx[i]), y=float(my[i]), params=params))
    return out


def _spatial_profile(
    mask: np.ndarray,
    kind: str,
    params: dict[str, Any],
    custom_body: str,
    custom_params: dict[str, Any],
    default_uniform: float = 1.0,
) -> np.ndarray:
    if mask.ndim != 2:
        raise ValueError("Geometry mask must be 2D.")
    ny, nx = mask.shape
    x_norm, y_norm = normalized_pixel_coords(mask)
    field = np.zeros(mask.shape, dtype=np.float64)
    mode = str(kind or "").strip().lower()

    if mode == "gaussian":
        amp = float(params.get("amplitude", 1.0))
        x0 = float(params.get("x0", 0.5))
        y0 = float(params.get("y0", 0.5))
        sigma = max(1e-6, float(params.get("sigma", 0.12)))
        r2 = (x_norm - x0) ** 2 + (y_norm - y0) ** 2
        field = amp * np.exp(-r2 / (2.0 * sigma * sigma))
    elif mode == "uniform":
        field.fill(float(params.get("value", default_uniform)))
    elif mode == "point":
        value = float(params.get("value", 1.0))
        col = int(np.clip(round(float(params.get("x0", 0.5)) * (nx - 1)), 0, nx - 1))
        row = int(np.clip(round(float(params.get("y0", 0.5)) * (ny - 1)), 0, ny - 1))
        if mask[row, col]:
            field[row, col] = value
        else:
            inside = np.argwhere(mask)
            if inside.size:
                d2 = (inside[:, 0] - row) ** 2 + (inside[:, 1] - col) ** 2
                r, c = inside[int(np.argmin(d2))]
                field[int(r), int(c)] = value
    elif mode == "custom":
        field[mask] = _eval_spatial_custom(custom_body, x_norm, y_norm, mask, custom_params)
    else:
        raise ValueError(f"Unsupported spatial initial-condition kind: '{kind}'.")

    field[~mask] = 0.0
    if not np.all(np.isfinite(field[mask])):
        raise ValueError("Spatial initial-condition profile produced non-finite values.")
    return field


def build_initial_field(mask: np.ndarray, spec: InitialConditionSpec) -> np.ndarray:
    canon = canonicalize_initial_condition(spec)
    return _spatial_profile(
        np.asarray(mask, dtype=bool),
        canon.spatial_kind,
        canon.spatial_params,
        canon.spatial_custom_body,
        canon.spatial_custom_params,
    )


def build_initial_phonon_spatial_field(
    mask: np.ndarray, spec: InitialConditionSpec
) -> np.ndarray:
    canon = canonicalize_initial_condition(spec)
    return _spatial_profile(
        np.asarray(mask, dtype=bool),
        canon.phonon_spatial_kind,
        canon.phonon_spatial_params,
        canon.phonon_spatial_custom_body,
        canon.phonon_spatial_custom_params,
    )


def build_initial_energy_weights(
    E_bins: np.ndarray,
    gap: float,
    dynes_gamma: float,
    spec: InitialConditionSpec,
    bath_temperature: float,
) -> np.ndarray | None:
    """QP energy weights from an IC spec; None means 'use the DOS default'."""
    canon = canonicalize_initial_condition(spec)
    if canon.qp_full_custom_enabled:
        return None
    kind = canon.energy_kind
    if kind in {"", "dos", "default", "bcs_dos"}:
        return None
    if kind == "fermi_dirac":
        temp = float(canon.energy_params.get("temperature", bath_temperature))
        return thermal_qp_weights(E_bins, gap, temp, dynes_gamma)
    if kind == "uniform":
        value = float(canon.energy_params.get("value", 1.0))
        if value < 0:
            raise ValueError("Uniform energy profile value must be non-negative.")
        return np.full(np.asarray(E_bins).shape, value, dtype=np.float64)
    if kind == "custom":
        return _eval_energy_custom(
            canon.energy_custom_body or _DEFAULTS["energy_custom_body"],
            np.asarray(E_bins, dtype=np.float64),
            variable_names=("E", "gap", "params"),
            extra={"gap": float(gap)},
            params=canon.energy_custom_params,
            label="Custom energy profile",
        )
    raise ValueError(
        f"Unsupported energy initial-condition kind '{kind}'. "
        "Supported: dos, fermi_dirac, uniform, custom."
    )


def _eval_energy_custom(
    body: str,
    grid: np.ndarray,
    *,
    variable_names: tuple[str, ...],
    extra: dict[str, Any],
    params: dict[str, Any],
    label: str,
) -> np.ndarray:
    fn = compile_safe_expression(body.strip() or "0.0", variable_names=variable_names)
    p = dict(params or {})
    try:
        raw = np.asarray(fn(E=grid, params=p, **extra), dtype=np.float64)
    except Exception:
        raw = np.asarray(
            [float(fn(E=float(e), params=p, **extra)) for e in grid], dtype=np.float64
        )
    raw = raw.reshape(-1)
    if raw.size == 1:
        raw = np.full(grid.shape, float(raw[0]), dtype=np.float64)
    if raw.size != grid.size:
        raise ValueError(f"{label} must return {grid.size} values or a scalar; got {raw.size}.")
    if not np.all(np.isfinite(raw)):
        raise ValueError(f"{label} produced non-finite values.")
    if np.any(raw < 0):
        raise ValueError(f"{label} must be non-negative.")
    return raw


def _coerce_full_state(
    arr: np.ndarray, grid: np.ndarray, mask: np.ndarray, label: str
) -> np.ndarray:
    """Coerce a user array of any accepted shape into (NB, P) interior layout.

    Accepted: scalar, (NB,P), (P,NB), (NB,ny,nx), (ny,nx,NB), (ny,nx), (NB,),
    (P,), or anything with NB·P elements (reshaped row-major).
    """
    nb = int(grid.size)
    ny, nx = mask.shape
    p = int(mask.sum())
    a = np.asarray(arr, dtype=np.float64)
    if a.ndim == 0:
        return np.full((nb, p), float(a))
    if a.shape == (nb, p):
        return a
    if a.shape == (p, nb):
        return a.T
    if a.shape == (nb, ny, nx):
        return a[:, mask]
    if a.shape == (ny, nx, nb):
        return np.moveaxis(a, 2, 0)[:, mask]
    if a.shape == (ny, nx):
        return np.repeat(a[mask][None, :], nb, axis=0)
    if a.shape == (nb,):
        return np.repeat(a.reshape(nb, 1), p, axis=1)
    if a.shape == (p,):
        return np.repeat(a.reshape(1, p), nb, axis=0)
    if a.size == nb * p:
        return a.reshape(nb, p)
    raise ValueError(
        f"{label} expression returned shape {a.shape}; expected scalar, "
        f"(N_E,), (N_x*N_y,), (N_E, N_x*N_y), or full-grid shapes tied to mask {mask.shape}."
    )


def _eval_full_custom(
    mask: np.ndarray,
    grid: np.ndarray,
    body: str,
    params: dict[str, Any],
    label: str,
) -> np.ndarray:
    if mask.ndim != 2:
        raise ValueError("Geometry mask must be 2D.")
    nb = int(np.asarray(grid).size)
    if nb <= 0:
        raise ValueError("Energy bins must be non-empty for full custom profile evaluation.")
    fn = compile_safe_expression(body.strip(), variable_names=("x", "y", "E", "params"))
    ny, nx = mask.shape
    coords = np.argwhere(mask)
    p = coords.shape[0]
    xs = (coords[:, 1].astype(np.float64) + 0.5) / max(1, nx)
    ys = (coords[:, 0].astype(np.float64) + 0.5) / max(1, ny)
    es = np.asarray(grid, dtype=np.float64)
    try:
        raw = np.asarray(
            fn(x=xs[None, :], y=ys[None, :], E=es[:, None], params=params), dtype=np.float64
        )
    except Exception:
        raw = np.empty((nb, p), dtype=np.float64)
        for ie, energy in enumerate(es):
            for px in range(p):
                raw[ie, px] = float(
                    fn(x=float(xs[px]), y=float(ys[px]), E=float(energy), params=params)
                )
    state = _coerce_full_state(raw, es, mask, label)
    if not np.all(np.isfinite(state)):
        raise ValueError(f"{label} expression produced non-finite values.")
    if np.any(state < 0):
        raise ValueError(f"{label} expression must be non-negative.")
    return state


def build_initial_qp_energy_state(
    mask: np.ndarray,
    E_bins: np.ndarray,
    spec: InitialConditionSpec,
) -> np.ndarray | None:
    """Optional non-separable QP state (NE, P); None when not enabled."""
    canon = canonicalize_initial_condition(spec)
    if not canon.qp_full_custom_enabled:
        return None
    return _eval_full_custom(
        np.asarray(mask, dtype=bool),
        np.asarray(E_bins, dtype=np.float64),
        canon.qp_full_custom_body or _DEFAULTS["qp_full_custom_body"],
        dict(canon.qp_full_custom_params or {}),
        "Full quasiparticle profile",
    )


def build_initial_phonon_energy_weights(
    omega_bins: np.ndarray,
    spec: InitialConditionSpec,
    bath_temperature: float,
) -> np.ndarray:
    canon = canonicalize_initial_condition(spec)
    omega = np.asarray(omega_bins, dtype=np.float64).reshape(-1)
    if omega.size == 0:
        raise ValueError("omega_bins must be non-empty.")
    if not np.all(np.isfinite(omega)):
        raise ValueError("omega_bins must contain finite values.")
    if np.any(omega < 0):
        raise ValueError("omega_bins must be non-negative.")
    kind = canon.phonon_energy_kind
    if kind in {"", "bose_einstein", "be", "thermal"}:
        temp = float(canon.phonon_energy_params.get("temperature", bath_temperature))
        values = bose_einstein_occupation(omega, temp)
    elif kind == "uniform":
        value = float(canon.phonon_energy_params.get("value", 1.0))
        if value < 0:
            raise ValueError("Uniform phonon energy profile value must be non-negative.")
        values = np.full(omega.shape, value, dtype=np.float64)
    elif kind == "custom":
        values = _eval_energy_custom(
            canon.phonon_energy_custom_body or _DEFAULTS["phonon_energy_custom_body"],
            omega,
            variable_names=("E", "params"),
            extra={},
            params=canon.phonon_energy_custom_params,
            label="Custom phonon energy profile",
        )
    else:
        raise ValueError(
            f"Unsupported phonon energy initial-condition kind '{kind}'. "
            "Supported: bose_einstein, uniform, custom."
        )
    if not np.all(np.isfinite(values)):
        raise ValueError("Phonon energy profile produced non-finite values.")
    if np.any(values < 0):
        raise ValueError("Phonon energy profile must be non-negative.")
    return values


def build_initial_phonon_energy_state(
    mask: np.ndarray,
    omega_bins: np.ndarray,
    spec: InitialConditionSpec,
    bath_temperature: float,
) -> np.ndarray:
    """Phonon state (NW, P) from a spec: full-custom or spatial × energy."""
    canon = canonicalize_initial_condition(spec)
    m = np.asarray(mask, dtype=bool)
    omega = np.asarray(omega_bins, dtype=np.float64)
    if canon.phonon_full_custom_enabled:
        return _eval_full_custom(
            m,
            omega,
            canon.phonon_full_custom_body or _DEFAULTS["phonon_full_custom_body"],
            dict(canon.phonon_full_custom_params or {}),
            "Full phonon profile",
        )
    spatial = build_initial_phonon_spatial_field(m, canon)[m].reshape(1, -1)
    energy = build_initial_phonon_energy_weights(omega, canon, bath_temperature).reshape(-1, 1)
    state = energy * spatial
    if not np.all(np.isfinite(state)):
        raise ValueError("Phonon initial state produced non-finite values.")
    if np.any(state < 0):
        raise ValueError("Phonon initial state must be non-negative.")
    return state


def evaluate_gap_expression(
    expression: str,
    mask: np.ndarray,
    energy_gap_default: float,
) -> np.ndarray:
    """Evaluate the spatial gap map Δ(x, y) over interior pixels → (P,).

    Empty expression means a uniform gap; results must be finite and
    strictly positive.
    """
    m = np.asarray(mask, dtype=bool)
    p = int(m.sum())

    def check(values: np.ndarray) -> np.ndarray:
        arr = np.asarray(values, dtype=np.float64).reshape(-1)
        if arr.size != p:
            raise ValueError(
                f"Gap expression returned {arr.size} values; expected {p} interior pixels."
            )
        if not np.all(np.isfinite(arr)):
            raise ValueError("Gap expression produced non-finite values.")
        if np.any(arr <= 0.0):
            raise ValueError("Gap expression must produce strictly positive values.")
        return arr

    if not str(expression or "").strip():
        return check(np.full(p, energy_gap_default, dtype=np.float64))
    x_norm, y_norm = normalized_pixel_coords(m)
    return check(_eval_spatial_custom(str(expression), x_norm, y_norm, m, {}))
