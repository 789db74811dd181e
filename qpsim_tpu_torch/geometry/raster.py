"""Polygon rasterization primitives (host-side, vectorised numpy).

Self-contained point-in-polygon and winding-number tests used by the GDS
pipeline and the analytic test-case geometries.  The reference leans on
``matplotlib.path`` for this (``geometry.py:98``, ``test_cases.py:538``);
here it is a dependency-free crossing/winding computation vectorised over
all query points at once, with an optional C++ fast path
(``qpsim_tpu_torch.geometry.gds``).
"""

from __future__ import annotations

import numpy as np

__all__ = ["points_in_polygon", "winding_numbers", "polygon_signed_area", "rasterize_polygons"]


def polygon_signed_area(points: np.ndarray) -> float:
    """Shoelace signed area; positive for counter-clockwise vertex order."""
    p = np.asarray(points, dtype=np.float64)
    if p.shape[0] < 3:
        return 0.0
    x, y = p[:, 0], p[:, 1]
    return 0.5 * float(np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y))


def winding_numbers(polygon: np.ndarray, points: np.ndarray) -> np.ndarray:
    """Signed winding number of ``polygon`` around each query point.

    Vectorised over points; edges vectorised too (P·V memory — fine for the
    polygon sizes GDS layouts produce per shape).
    """
    poly = np.asarray(polygon, dtype=np.float64)
    pts = np.asarray(points, dtype=np.float64)
    x0, y0 = poly[:, 0], poly[:, 1]
    x1, y1 = np.roll(x0, -1), np.roll(y0, -1)
    px = pts[:, 0][:, None]
    py = pts[:, 1][:, None]

    # cross > 0: point left of the directed edge
    cross = (x1 - x0)[None, :] * (py - y0[None, :]) - (px - x0[None, :]) * (y1 - y0)[None, :]
    upward = (y0[None, :] <= py) & (y1[None, :] > py)
    downward = (y0[None, :] > py) & (y1[None, :] <= py)
    wn = np.sum(upward & (cross > 0), axis=1) - np.sum(downward & (cross < 0), axis=1)
    return wn.astype(np.int32)


def points_in_polygon(polygon: np.ndarray, points: np.ndarray) -> np.ndarray:
    """Nonzero-winding containment test for each query point."""
    return winding_numbers(polygon, points) != 0


def rasterize_polygons(
    polygons: list[np.ndarray],
    x_centers: np.ndarray,
    y_centers: np.ndarray,
) -> np.ndarray:
    """Orientation-aware rasterization of a set of polygons onto a grid.

    Same cutout semantics as the reference's GDS mask builder
    (``geometry.py:92-104``): the dominant-area polygon's orientation counts
    +1, opposite-oriented contours count −1, and a cell is inside when the
    accumulated winding is positive — so holes drawn with reversed winding
    carve out material.
    """
    gx, gy = np.meshgrid(np.asarray(x_centers), np.asarray(y_centers))
    pts = np.column_stack([gx.ravel(), gy.ravel()])
    areas = np.array([polygon_signed_area(p) for p in polygons])
    dominant = np.sign(areas[int(np.argmax(np.abs(areas)))]) or 1.0

    accum = np.zeros(pts.shape[0], dtype=np.int32)
    for poly, area in zip(polygons, areas):
        sign = np.sign(area) or dominant
        weight = 1 if sign == dominant else -1
        accum += weight * points_in_polygon(poly, pts).astype(np.int32)
    return (accum > 0).reshape(len(y_centers), len(x_centers))
