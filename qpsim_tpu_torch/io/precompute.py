"""Precompute and cache-validation layer.

Carried over from ``qpsim_tpu.io.precompute``: the same ``.npz``-storable
payload (diffusion arrays D(E, x), the gap map, optional collision kernels)
and the same numeric fingerprint (including a SHA-256 mask hash and
gap-expression hash) used to detect stale caches, bit for bit, so a
payload saved by either package validates in the other.
"""

from __future__ import annotations

import hashlib
from typing import Any, Callable

import numpy as np

from ..fields import evaluate_gap_expression
from ..models.params import BoundaryCondition, EdgeSegment, SimulationParameters
from ..ops.dos import (
    diffusion_coefficient_of_energy,
    dynes_density_of_states,
    thermal_qp_weights,
)
from ..ops.energy_grid import build_energy_grid
from ..ops.kernels import recombination_kernel, scattering_kernel, thermal_generation_rate

__all__ = [
    "precompute_arrays",
    "validate_precomputed",
    "estimate_precompute_memory",
    "mask_hash",
    "gap_expression_hash",
]

_FINGERPRINT_LABELS = [
    "energy_gap",
    "energy_min_factor",
    "energy_max_factor",
    "num_energy_bins",
    "dynes_gamma",
    "diffusion_coefficient",
    "n_spatial",
    "mask_hash",
    "gap_expression",
]
_COLLISION_LABELS = ["tau_s", "tau_r", "T_c", "bath_temperature"]


def mask_hash(mask: np.ndarray) -> float:
    """Stable numeric hash of mask shape + topology (SHA-256 → 53-bit float)."""
    m = np.asarray(mask, dtype=bool)
    digest = hashlib.sha256()
    digest.update(np.asarray(m.shape, dtype=np.int64).tobytes())
    digest.update(np.packbits(m.astype(np.uint8, copy=False)).tobytes())
    return float(int.from_bytes(digest.digest()[:8], "big") % (2**53))


def gap_expression_hash(gap_expression: str) -> float:
    return float(int(hashlib.sha256(gap_expression.encode()).hexdigest()[:16], 16) % (2**53))


def _resolved_taus(params: SimulationParameters) -> tuple[float, float]:
    tau_s = float(params.tau_s if params.tau_s is not None else params.tau_0)
    tau_r = float(params.tau_r if params.tau_r is not None else params.tau_0)
    return tau_s, tau_r


def _fingerprint(
    params: SimulationParameters,
    mask: np.ndarray,
    include_collision_kernels: bool,
) -> np.ndarray:
    values = [
        params.energy_gap,
        params.energy_min_factor,
        params.energy_max_factor,
        float(params.num_energy_bins),
        params.dynes_gamma,
        params.diffusion_coefficient,
        float(np.asarray(mask, dtype=bool).sum()),
        mask_hash(mask),
        gap_expression_hash(params.gap_expression),
    ]
    if include_collision_kernels:
        tau_s, tau_r = _resolved_taus(params)
        values += [tau_s, tau_r, params.T_c, params.bath_temperature]
    return np.asarray(values, dtype=np.float64)


def _scalar_bool(value: Any) -> bool:
    if isinstance(value, np.ndarray):
        return bool(value.reshape(-1)[0]) if value.size else False
    return bool(value)


def validate_precomputed(
    precomputed: dict[str, Any],
    params: SimulationParameters,
    mask: np.ndarray,
) -> str | None:
    """Return None when the cache matches, else a labelled mismatch message."""
    for key in ("fingerprint", "E_bins", "gap_values", "is_uniform", "D_array"):
        if key not in precomputed:
            return f"Precomputed file missing required key '{key}'."

    n_spatial = int(np.asarray(mask, dtype=bool).sum())
    n_energy = int(params.num_energy_bins)

    def as_array(key: str) -> np.ndarray | None:
        try:
            return np.asarray(precomputed[key], dtype=np.float64)
        except Exception:
            return None

    e_bins = as_array("E_bins")
    if e_bins is None:
        return "Precomputed key 'E_bins' is not a valid numeric array."
    if e_bins.reshape(-1).size != n_energy:
        return f"E_bins length mismatch: stored {e_bins.reshape(-1).size} vs current {n_energy}."
    gap_values = as_array("gap_values")
    if gap_values is None:
        return "Precomputed key 'gap_values' is not a valid numeric array."
    if gap_values.reshape(-1).size != n_spatial:
        return (
            f"gap_values length mismatch: stored {gap_values.reshape(-1).size} "
            f"vs current {n_spatial}."
        )
    d_array = as_array("D_array")
    if d_array is None:
        return "Precomputed key 'D_array' is not a valid numeric array."
    if d_array.shape != (n_energy, n_spatial):
        return (
            "D_array shape mismatch: "
            f"stored {tuple(d_array.shape)} vs current {(n_energy, n_spatial)}."
        )

    stored = as_array("fingerprint")
    if stored is None:
        return "Precomputed key 'fingerprint' is not a valid numeric array."
    stored = stored.reshape(-1)
    has_kernels = any(
        k in precomputed
        for k in ("K_r", "K_s", "rho_bins", "G_therm", "K_r_all", "K_s_all", "rho_all", "G_therm_all")
    )
    include_kernels = _scalar_bool(precomputed.get("include_collision_kernels", has_kernels))
    current = _fingerprint(params, mask, include_kernels)
    labels = _FINGERPRINT_LABELS + (_COLLISION_LABELS if include_kernels else [])
    if stored.shape != current.shape:
        return f"Fingerprint size mismatch: stored {stored.shape} vs current {current.shape}."
    if not np.allclose(stored, current, rtol=1e-12, atol=1e-12):
        diffs = [
            f"{labels[i] if i < len(labels) else f'param[{i}]'}: stored={s}, current={c}"
            for i, (s, c) in enumerate(zip(stored, current))
            if abs(s - c) > 1e-12 * max(abs(s), abs(c), 1.0)
        ]
        return "Parameter mismatch: " + "; ".join(diffs)
    return None


def estimate_precompute_memory(
    n_spatial: int,
    n_energy: int,
    is_uniform: bool,
    include_collision_kernels: bool = False,
) -> int:
    """Estimated bytes of the precompute payload (float64 accounting)."""
    fb = 8
    base = fb * (n_energy * n_spatial + n_energy + n_spatial)
    if not include_collision_kernels:
        return base
    if is_uniform:
        return base + fb * (2 * n_energy**2 + 2 * n_energy)
    return base + fb * (2 * n_spatial * n_energy**2 + 2 * n_spatial * n_energy)


def precompute_arrays(
    mask: np.ndarray,
    edges: list[EdgeSegment],
    edge_conditions: dict[str, BoundaryCondition],
    params: SimulationParameters,
    progress_callback: Callable[[str], None] | None = None,
    *,
    include_collision_kernels: bool = False,
) -> dict[str, Any]:
    """Precompute diffusion (and optionally collision) arrays for a setup.

    Returned dict is npz-round-trippable and fingerprint-validated.  Kernels
    are computed once per unique gap value, then broadcast per pixel for
    storage compatibility with the reference layout.
    """
    if params.energy_gap <= 0:
        raise ValueError("precompute_arrays requires energy_gap > 0.")
    m = np.asarray(mask, dtype=bool)
    ne = params.num_energy_bins
    E_bins, dE = build_energy_grid(
        params.energy_gap, params.energy_min_factor, params.energy_max_factor, ne
    )
    notify = progress_callback or (lambda _msg: None)

    notify("Evaluating gap expression...")
    gap_values = evaluate_gap_expression(params.gap_expression, m, params.energy_gap)
    unique_gaps = np.unique(gap_values)
    is_uniform = unique_gaps.size == 1
    notify("Uniform gap values" if is_uniform else f"{unique_gaps.size} unique gap values")

    D_array = diffusion_coefficient_of_energy(
        params.diffusion_coefficient, E_bins[:, None], gap_values[None, :]
    )

    payload: dict[str, Any] = {
        "fingerprint": _fingerprint(params, m, include_collision_kernels),
        "include_collision_kernels": np.array(bool(include_collision_kernels)),
        "E_bins": E_bins,
        "gap_values": gap_values,
        "is_uniform": np.array(is_uniform),
        "D_array": D_array,
    }
    if not include_collision_kernels:
        notify("Precomputation complete (diffusion/gap arrays only).")
        return payload

    tau_s, tau_r = _resolved_taus(params)
    gamma = params.dynes_gamma

    def kernels_for(gap: float):
        kr = recombination_kernel(E_bins, gap, tau_r, params.T_c, params.bath_temperature)
        ks = scattering_kernel(E_bins, gap, tau_s, params.T_c, params.bath_temperature)
        rho = dynes_density_of_states(E_bins, gap, gamma)
        n_eq = thermal_qp_weights(E_bins, gap, params.bath_temperature, gamma)
        return kr, ks, rho, thermal_generation_rate(n_eq, kr, dE)

    if is_uniform:
        notify("Computing uniform kernels...")
        kr, ks, rho, g_therm = kernels_for(float(unique_gaps[0]))
        payload.update({"K_r": kr, "K_s": ks, "rho_bins": rho, "G_therm": g_therm})
    else:
        notify("Computing per-pixel kernels (caching by unique gap)...")
        cache = {float(g): kernels_for(float(g)) for g in unique_gaps}
        gap_idx = np.searchsorted(unique_gaps, gap_values)
        kr_stack = np.stack([cache[float(g)][0] for g in unique_gaps])
        ks_stack = np.stack([cache[float(g)][1] for g in unique_gaps])
        rho_stack = np.stack([cache[float(g)][2] for g in unique_gaps])
        gt_stack = np.stack([cache[float(g)][3] for g in unique_gaps])
        payload.update(
            {
                "K_r_all": kr_stack[gap_idx],
                "K_s_all": ks_stack[gap_idx],
                "rho_all": rho_stack[gap_idx],
                "G_therm_all": gt_stack[gap_idx],
            }
        )
    notify("Precomputation complete.")
    return payload
