"""Mask-based geometry utilities: boundary faces, edge segments, the intrinsic rectangle.

Carried over from ``qpsim_tpu.geometry.mask`` (behavioural parity with the
reference ``qpsim/geometry.py:111-262``: edge ids, face back-pointers,
ordering, intrinsic rectangle sizing).  Only the pieces the energy-resolved
engine needs are here; the GDS and polygon helpers come with the I/O port.
"""

from __future__ import annotations

import numpy as np

from ..models.params import BoundaryFace, EdgeSegment, GeometryData

__all__ = [
    "boundary_face_map",
    "extract_edge_segments",
    "create_intrinsic_geometry",
    "mask_from_lists",
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
