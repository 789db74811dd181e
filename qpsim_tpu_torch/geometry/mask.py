"""Mask-based geometry utilities: boundary faces, edge segments, components.

Carried over from ``qpsim_tpu.geometry.mask`` (behavioural parity with the
reference ``qpsim/geometry.py:111-262``: edge ids, face back-pointers,
ordering, intrinsic rectangle sizing), face detection vectorised with numpy
shifts; the polygon tracer exports masks back to GDS layouts.
"""

from __future__ import annotations

import numpy as np

from ..models.params import BoundaryFace, EdgeSegment, GeometryData

__all__ = [
    "boundary_face_map",
    "extract_edge_segments",
    "connected_component_count",
    "create_intrinsic_geometry",
    "point_to_segment_distance",
    "mask_from_lists",
    "mask_to_polygons",
]


def mask_from_lists(mask_rows: list[list[int]]) -> np.ndarray:
    """Convert JSON-style nested int lists into a bool mask array."""
    return np.asarray(mask_rows, dtype=bool)


def boundary_face_map(mask: np.ndarray) -> dict[str, np.ndarray]:
    """Per-direction boolean planes marking interior cells with an exposed face.

    A cell (r, c) has an exposed face in direction d if it is inside the mask
    and its d-neighbour is outside (or off-grid).
    """
    m = np.asarray(mask, dtype=bool)
    if m.ndim != 2:
        raise ValueError("mask must be 2D.")
    pad = np.pad(m, 1, constant_values=False)
    return {
        "up": m & ~pad[:-2, 1:-1],
        "down": m & ~pad[2:, 1:-1],
        "left": m & ~pad[1:-1, :-2],
        "right": m & ~pad[1:-1, 2:],
    }


def _merge_runs(
    entries: list[tuple[int, int, BoundaryFace]],
) -> list[tuple[int, int, list[BoundaryFace]]]:
    """Merge sorted (start, end, face) unit intervals into maximal runs."""
    runs: list[tuple[int, int, list[BoundaryFace]]] = []
    start, end, faces = entries[0][0], entries[0][1], [entries[0][2]]
    for lo, hi, face in entries[1:]:
        if lo == end:
            end = hi
            faces.append(face)
        else:
            runs.append((start, end, faces))
            start, end, faces = lo, hi, [face]
    runs.append((start, end, faces))
    return runs


def extract_edge_segments(mask: np.ndarray) -> list[EdgeSegment]:
    """Extract maximal axis-aligned boundary edge segments with face lists.

    Segment ids are ``edge_0001`` onwards; horizontal groups are emitted
    before vertical ones, each sorted by (line coordinate, normal) to match
    the reference ordering so persisted boundary-condition maps stay valid.
    """
    m = np.asarray(mask, dtype=bool)
    faces = boundary_face_map(m)

    # Group faces by the grid line they sit on.  Horizontal faces of an
    # 'up' face at row r lie on line y=r; a 'down' face lies on y=r+1.
    horizontal: dict[tuple[str, int], list[tuple[int, int, BoundaryFace]]] = {}
    vertical: dict[tuple[str, int], list[tuple[int, int, BoundaryFace]]] = {}

    for direction, line_of in (("up", lambda r, c: r), ("down", lambda r, c: r + 1)):
        rows, cols = np.nonzero(faces[direction])
        for r, c in zip(rows.tolist(), cols.tolist()):
            key = (direction, line_of(r, c))
            horizontal.setdefault(key, []).append(
                (c, c + 1, BoundaryFace(row=r, col=c, direction=direction))
            )
    for direction, line_of in (("left", lambda r, c: c), ("right", lambda r, c: c + 1)):
        rows, cols = np.nonzero(faces[direction])
        for r, c in zip(rows.tolist(), cols.tolist()):
            key = (direction, line_of(r, c))
            vertical.setdefault(key, []).append(
                (r, r + 1, BoundaryFace(row=r, col=c, direction=direction))
            )

    segments: list[EdgeSegment] = []
    counter = 0

    def make_id() -> str:
        nonlocal counter
        counter += 1
        return f"edge_{counter:04d}"

    for (normal, y), entries in sorted(horizontal.items(), key=lambda kv: (kv[0][1], kv[0][0])):
        entries.sort(key=lambda e: e[0])
        for lo, hi, run_faces in _merge_runs(entries):
            segments.append(
                EdgeSegment(
                    edge_id=make_id(),
                    x0=float(lo),
                    y0=float(y),
                    x1=float(hi),
                    y1=float(y),
                    normal=normal,
                    faces=run_faces,
                )
            )
    for (normal, x), entries in sorted(vertical.items(), key=lambda kv: (kv[0][1], kv[0][0])):
        entries.sort(key=lambda e: e[0])
        for lo, hi, run_faces in _merge_runs(entries):
            segments.append(
                EdgeSegment(
                    edge_id=make_id(),
                    x0=float(x),
                    y0=float(lo),
                    x1=float(x),
                    y1=float(hi),
                    normal=normal,
                    faces=run_faces,
                )
            )
    return segments


def connected_component_count(mask: np.ndarray) -> int:
    """Number of 4-connected components of True cells (pure-numpy BFS)."""
    m = np.asarray(mask, dtype=bool)
    if m.ndim != 2:
        raise ValueError("Mask must be 2D.")
    try:
        from scipy import ndimage as ndi

        four_conn = np.array([[0, 1, 0], [1, 1, 1], [0, 1, 0]], dtype=np.int8)
        _, count = ndi.label(m, structure=four_conn)
        return int(count)
    except Exception:
        pass

    remaining = m.copy()
    count = 0
    while remaining.any():
        count += 1
        seed = np.zeros_like(remaining)
        r, c = np.argwhere(remaining)[0]
        seed[r, c] = True
        # Flood fill by iterated dilation restricted to the mask.
        while True:
            padded = np.pad(seed, 1, constant_values=False)
            grown = (
                seed
                | padded[:-2, 1:-1]
                | padded[2:, 1:-1]
                | padded[1:-1, :-2]
                | padded[1:-1, 2:]
            ) & remaining
            if np.array_equal(grown, seed):
                break
            seed = grown
        remaining &= ~seed
    return count


def create_intrinsic_geometry(
    mesh_size: float = 1.0, width: int = 120, height: int = 64
) -> GeometryData:
    """Built-in rectangle geometry with a padding margin (no GDS needed)."""
    mask = np.zeros((height, width), dtype=bool)
    pad_y = max(1, min(8, max(1, height // 4)))
    pad_x = max(1, min(8, max(1, width // 4)))
    if height - 2 * pad_y <= 0 or width - 2 * pad_x <= 0:
        mask[:, :] = True
    else:
        mask[pad_y:-pad_y, pad_x:-pad_x] = True
    return GeometryData(
        name="IntrinsicRectangle",
        source_path="intrinsic",
        layer=0,
        mesh_size=mesh_size,
        mask=mask.astype(int).tolist(),
        edges=extract_edge_segments(mask),
        bounds=[0.0, 0.0, float(width), float(height)],
    )


def point_to_segment_distance(px: float, py: float, edge: EdgeSegment) -> float:
    """Euclidean distance from a point to an edge segment (hover hit-testing)."""
    ax, ay, bx, by = edge.x0, edge.y0, edge.x1, edge.y1
    vx, vy = bx - ax, by - ay
    length_sq = vx * vx + vy * vy
    if length_sq <= 0.0:
        return float(np.hypot(px - ax, py - ay))
    t = np.clip(((px - ax) * vx + (py - ay) * vy) / length_sq, 0.0, 1.0)
    return float(np.hypot(px - (ax + t * vx), py - (ay + t * vy)))


def mask_to_polygons(
    mask: np.ndarray, dx: float = 1.0, origin: tuple[float, float] = (0.0, 0.0)
) -> list[np.ndarray]:
    """Trace a boolean mask into closed boundary polygons (GDS-exportable).

    Inverse of the rasterization pipeline: cell (r, c) covers
    [origin_x + c·dx, origin_x + (c+1)·dx] × [origin_y + r·dx, ...].  Outer
    contours come out counter-clockwise and holes clockwise — the same
    opposite-winding cutout convention the rasterizer consumes
    (``raster.rasterize_polygons``), so exporting with
    :func:`qpsim_tpu.geometry.gds.write_gds` and re-rasterizing at the cell
    centers reproduces the mask exactly.  Collinear run vertices are merged.
    """
    m = np.asarray(mask, dtype=bool)
    ny, nx = m.shape
    padded = np.zeros((ny + 2, nx + 2), dtype=bool)
    padded[1:-1, 1:-1] = m

    # boundary half-edges in grid units, oriented with the filled cell on
    # the left: outer loops CCW, holes CW
    segments: dict[tuple[int, int], list[tuple[int, int]]] = {}

    def add(p0, p1):
        segments.setdefault(p0, []).append(p1)

    rs, cs = np.nonzero(m)
    for r, c in zip(rs.tolist(), cs.tolist()):
        if not padded[r, c + 1]:  # south neighbour empty
            add((c, r), (c + 1, r))
        if not padded[r + 1, c + 2]:  # east neighbour empty
            add((c + 1, r), (c + 1, r + 1))
        if not padded[r + 2, c + 1]:  # north neighbour empty
            add((c + 1, r + 1), (c, r + 1))
        if not padded[r + 1, c]:  # west neighbour empty
            add((c, r + 1), (c, r))

    ox, oy = origin
    polygons: list[np.ndarray] = []
    while segments:
        start = next(iter(segments))
        loop = [start]
        prev_dir = None
        point = start
        while True:
            nexts = segments[point]
            if len(nexts) == 1 or prev_dir is None:
                nxt = nexts.pop(0)
            else:
                # checkerboard corner: two outgoing edges share this point —
                # turn left (relative to the incoming direction) so each
                # loop stays simple and self-consistent
                want = (-prev_dir[1], prev_dir[0])  # left turn
                pick = 0
                for i, cand in enumerate(nexts):
                    d = (cand[0] - point[0], cand[1] - point[1])
                    if d == want:
                        pick = i
                        break
                nxt = nexts.pop(pick)
            if not segments[point]:
                del segments[point]
            prev_dir = (nxt[0] - point[0], nxt[1] - point[1])
            if nxt == start:
                break
            loop.append(nxt)
            point = nxt
        pts = np.asarray(loop, dtype=np.float64)
        # merge collinear runs (all segments are axis-aligned unit steps)
        keep = np.ones(len(pts), dtype=bool)
        for i in range(len(pts)):
            a, b, c2 = pts[i - 1], pts[i], pts[(i + 1) % len(pts)]
            if (b - a)[0] * (c2 - b)[1] == (b - a)[1] * (c2 - b)[0]:
                keep[i] = False
        pts = pts[keep]
        pts = pts * dx + np.array([ox, oy])
        polygons.append(pts)
    return polygons
