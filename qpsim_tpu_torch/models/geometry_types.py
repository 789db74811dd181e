"""Geometry-layer data types (JSON contract with reference models.py:52-79).

Kept separate from the run-configuration model: these are produced by the
geometry pipeline (``qpsim_tpu_torch.geometry``) and consumed by the solver's
boundary-condition assembly.
"""

from __future__ import annotations

from dataclasses import dataclass

__all__ = ["BoundaryFace", "EdgeSegment", "GeometryData"]


@dataclass
class BoundaryFace:
    """One exposed face of an interior cell (row, col) in direction up/down/left/right."""

    row: int
    col: int
    direction: str


@dataclass
class EdgeSegment:
    """A maximal axis-aligned run of boundary faces sharing one outward normal."""

    edge_id: str
    x0: float
    y0: float
    x1: float
    y1: float
    normal: str
    faces: list[BoundaryFace]


@dataclass
class GeometryData:
    name: str
    source_path: str
    layer: int
    mesh_size: float
    mask: list[list[int]]
    edges: list[EdgeSegment]
    bounds: list[float] | None = None
