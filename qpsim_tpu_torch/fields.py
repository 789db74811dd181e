"""Gap-map evaluation (host side).

The part of ``qpsim_tpu.fields`` that gap maps need: the normalised pixel
coordinates, the vectorised custom-expression evaluation with its
per-pixel scalar fallback, and :func:`evaluate_gap_expression`.  The
initial-condition builders (``initial_condition_spec``) stay in ROADMAP.md,
queue 1, item 4.

Coordinate convention: pixel centers normalised to (0, 1):
x = (col + 0.5)/nx, y = (row + 0.5)/ny.
"""

from __future__ import annotations

import numpy as np

from .expr.safe_eval import compile_safe_expression

__all__ = ["evaluate_gap_expression", "normalized_pixel_coords"]


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
