"""GDSII chip-layout import: binary parser, flattener, rasterizer, writer.

Carried over from ``qpsim_tpu.geometry.gds``.  The reference delegates GDS
handling to the ``gdstk`` C++ library (reference
``qpsim/geometry.py:17-24,57-108``); this package, like ``qpsim_tpu``, ships
its own stack and needs no gdstk:

* a stream parser for the GDSII binary format (BOUNDARY polygons, PATH
  elements, SREF/AREF structure references with reflection/magnification/
  rotation transforms),
* top-level-cell discovery + recursive flattening,
* an orientation-aware mask rasterizer — the C++ scanline of
  ``native/gds_raster.cpp`` (compiled at first use with ``g++`` into
  ``build/qpsim_tpu_torch/``, named by a hash of the source and flags, and
  loaded with ctypes) with a vectorised numpy winding-number fallback where
  no compiler or source is present; :func:`native_raster_available` says
  which one runs.  Both are host code: a mask is rasterized once per run.
* a writer, so fixtures and round-trip tests need no external assets.

Mask semantics match the reference exactly: one-cell padding creates an
explicit outer boundary ring, grids are at least 8 cells per side, and
opposite-winding contours carve cutouts.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import struct
import subprocess
import tempfile
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterable

import numpy as np

from ..models.params import GeometryData
from ..utils.cuda_build import build_dir
from .mask import connected_component_count, extract_edge_segments
from .raster import polygon_signed_area, points_in_polygon

__all__ = [
    "GdsPolygon",
    "GdsCell",
    "GdsLibrary",
    "read_gds_library",
    "read_gds_polygons",
    "discover_gds_layers",
    "rasterize_gds_layer",
    "create_geometry_from_gds",
    "write_gds",
    "gds_support_available",
    "native_raster_available",
]

# record type ids (GDSII stream format)
_HEADER, _BGNLIB, _LIBNAME, _UNITS, _ENDLIB = 0x00, 0x01, 0x02, 0x03, 0x04
_BGNSTR, _STRNAME, _ENDSTR = 0x05, 0x06, 0x07
_BOUNDARY, _PATH, _SREF, _AREF = 0x08, 0x09, 0x0A, 0x0B
_LAYER, _DATATYPE, _XY, _ENDEL = 0x0D, 0x0E, 0x10, 0x11
_SNAME, _COLROW, _STRANS, _MAG, _ANGLE = 0x12, 0x13, 0x1A, 0x1B, 0x1C
_WIDTH, _PATHTYPE, _BGNEXTN, _ENDEXTN = 0x0F, 0x21, 0x30, 0x31


def gds_support_available() -> bool:
    """GDS import is always available (self-contained parser)."""
    return True


@dataclass
class GdsPolygon:
    layer: int
    datatype: int
    points: np.ndarray  # (V, 2) float64, user units
    #: True when stroked from a PATH element (the reference's gdstk-based
    #: pipeline reads only `cell.polygons`, which excludes paths — filter on
    #: this flag via include_paths=False for exact reference behavior)
    from_path: bool = False


@dataclass
class _Reference:
    cell_name: str
    origin: np.ndarray
    rotation_deg: float = 0.0
    magnification: float = 1.0
    x_reflection: bool = False
    columns: int = 1
    rows: int = 1
    col_step: np.ndarray | None = None
    row_step: np.ndarray | None = None


@dataclass
class GdsCell:
    name: str
    polygons: list[GdsPolygon] = field(default_factory=list)
    references: list[_Reference] = field(default_factory=list)


@dataclass
class GdsLibrary:
    name: str
    unit_user: float  # user units per database unit (typically 1e-3 → µm)
    unit_meters: float
    cells: dict[str, GdsCell]

    def top_level(self) -> list[GdsCell]:
        referenced = {r.cell_name for c in self.cells.values() for r in c.references}
        tops = [c for n, c in self.cells.items() if n not in referenced]
        return tops or list(self.cells.values())

    def flatten_cell(self, cell: GdsCell, _depth: int = 0) -> list[GdsPolygon]:
        """Recursively resolve references into transformed polygons."""
        if _depth > 64:
            raise ValueError("GDS reference nesting too deep (cycle?).")
        out = [
            GdsPolygon(p.layer, p.datatype, p.points.copy(), p.from_path)
            for p in cell.polygons
        ]
        for ref in cell.references:
            target = self.cells.get(ref.cell_name)
            if target is None:
                raise ValueError(f"GDS reference to unknown cell '{ref.cell_name}'.")
            base = self.flatten_cell(target, _depth + 1)
            for ci in range(ref.columns):
                for ri in range(ref.rows):
                    shift = ref.origin.copy()
                    if ref.col_step is not None:
                        shift = shift + ci * ref.col_step
                    if ref.row_step is not None:
                        shift = shift + ri * ref.row_step
                    for poly in base:
                        pts = poly.points.copy()
                        if ref.x_reflection:
                            pts[:, 1] = -pts[:, 1]
                        if ref.magnification != 1.0:
                            pts = pts * ref.magnification
                        if ref.rotation_deg:
                            th = np.deg2rad(ref.rotation_deg)
                            rot = np.array(
                                [[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]]
                            )
                            pts = pts @ rot.T
                        out.append(
                            GdsPolygon(poly.layer, poly.datatype, pts + shift, poly.from_path)
                        )
        return out


def _parse_real8(data: bytes, offset: int) -> float:
    """GDSII excess-64 base-16 floating point."""
    raw = struct.unpack_from(">Q", data, offset)[0]
    if raw == 0:
        return 0.0
    sign = -1.0 if raw >> 63 else 1.0
    exponent = ((raw >> 56) & 0x7F) - 64
    mantissa = raw & ((1 << 56) - 1)
    return sign * (mantissa / float(1 << 56)) * (16.0**exponent)


def _pack_real8(value: float) -> bytes:
    if value == 0.0:
        return b"\x00" * 8
    sign = 0
    if value < 0:
        sign = 1
        value = -value
    exponent = 64
    # normalise mantissa into [1/16, 1)
    while value >= 1.0:
        value /= 16.0
        exponent += 1
    while value < 1.0 / 16.0:
        value *= 16.0
        exponent -= 1
    mantissa = int(value * (1 << 56))
    raw = (sign << 63) | ((exponent & 0x7F) << 56) | (mantissa & ((1 << 56) - 1))
    return struct.pack(">Q", raw)


def _iter_records(data: bytes):
    pos = 0
    n = len(data)
    while pos + 4 <= n:
        length, rectype, _dtype = struct.unpack_from(">HBB", data, pos)
        if length < 4:
            break
        yield rectype, data[pos + 4 : pos + length]
        if rectype == _ENDLIB:
            return
        pos += length


def read_gds_library(path: str | Path) -> GdsLibrary:
    data = Path(path).read_bytes()
    if len(data) < 4 or struct.unpack_from(">HBB", data, 0)[1] != _HEADER:
        raise ValueError(f"Not a GDSII stream file (missing HEADER record): {path}")
    try:
        return _parse_library(path, data)
    except struct.error as exc:  # truncated/corrupt records -> clean error
        raise ValueError(f"Corrupt GDSII stream in {path}: {exc}") from exc


def _parse_library(path, data: bytes) -> GdsLibrary:
    lib_name = ""
    unit_user, unit_meters = 1e-3, 1e-9
    cells: dict[str, GdsCell] = {}
    current: GdsCell | None = None
    element: dict | None = None

    for rectype, payload in _iter_records(data):
        if rectype == _LIBNAME:
            lib_name = payload.rstrip(b"\x00").decode("ascii", "replace")
        elif rectype == _UNITS:
            unit_user = _parse_real8(payload, 0)
            unit_meters = _parse_real8(payload, 8)
        elif rectype == _BGNSTR:
            current = GdsCell(name="")
        elif rectype == _STRNAME and current is not None:
            current.name = payload.rstrip(b"\x00").decode("ascii", "replace")
        elif rectype == _ENDSTR and current is not None:
            cells[current.name] = current
            current = None
        elif rectype in (_BOUNDARY, _PATH, _SREF, _AREF):
            element = {"kind": rectype, "layer": 0, "datatype": 0, "strans": 0,
                       "mag": 1.0, "angle": 0.0, "colrow": (1, 1),
                       "width": 0.0, "pathtype": 0, "bgnextn": 0.0, "endextn": 0.0}
        elif element is not None:
            if rectype == _LAYER:
                element["layer"] = struct.unpack(">h", payload[:2])[0]
            elif rectype == _DATATYPE:
                element["datatype"] = struct.unpack(">h", payload[:2])[0]
            elif rectype == _SNAME:
                element["sname"] = payload.rstrip(b"\x00").decode("ascii", "replace")
            elif rectype == _STRANS:
                element["strans"] = struct.unpack(">H", payload[:2])[0]
            elif rectype == _MAG:
                element["mag"] = _parse_real8(payload, 0)
            elif rectype == _ANGLE:
                element["angle"] = _parse_real8(payload, 0)
            elif rectype == _COLROW:
                element["colrow"] = struct.unpack(">hh", payload[:4])
            elif rectype == _WIDTH:
                element["width"] = float(struct.unpack(">i", payload[:4])[0])
            elif rectype == _PATHTYPE:
                element["pathtype"] = struct.unpack(">h", payload[:2])[0]
            elif rectype == _BGNEXTN:
                element["bgnextn"] = float(struct.unpack(">i", payload[:4])[0])
            elif rectype == _ENDEXTN:
                element["endextn"] = float(struct.unpack(">i", payload[:4])[0])
            elif rectype == _XY:
                coords = np.frombuffer(payload, dtype=">i4").astype(np.float64)
                element["xy"] = coords.reshape(-1, 2)
            elif rectype == _ENDEL:
                if current is not None:
                    _finish_element(current, element, unit_user)
                element = None
    return GdsLibrary(name=lib_name, unit_user=unit_user, unit_meters=unit_meters, cells=cells)


def _finish_element(cell: GdsCell, element: dict, unit_user: float) -> None:
    kind = element["kind"]
    xy = element.get("xy")
    if xy is None:
        return
    if xy.shape[0] == 0:
        raise ValueError("GDSII element carries an empty XY record (corrupt stream)")
    pts = xy * unit_user  # database units → user units
    if kind == _BOUNDARY:
        points = pts
        # closed polygons repeat the first vertex; drop the duplicate
        if points.shape[0] >= 2 and np.allclose(points[0], points[-1]):
            points = points[:-1]
        cell.polygons.append(
            GdsPolygon(layer=int(element["layer"]), datatype=int(element["datatype"]), points=points)
        )
    elif kind in (_SREF, _AREF):
        origin = pts[0]
        cols, rows = element["colrow"] if kind == _AREF else (1, 1)
        col_step = row_step = None
        if kind == _AREF and pts.shape[0] >= 3:
            col_step = (pts[1] - origin) / max(1, cols)
            row_step = (pts[2] - origin) / max(1, rows)
        cell.references.append(
            _Reference(
                cell_name=element.get("sname", ""),
                origin=origin,
                rotation_deg=float(element.get("angle", 0.0)),
                magnification=float(element.get("mag", 1.0)),
                x_reflection=bool(element.get("strans", 0) & 0x8000),
                columns=int(cols),
                rows=int(rows),
                col_step=col_step,
                row_step=row_step,
            )
        )
    elif kind == _PATH:
        width = float(element.get("width", 0.0)) * unit_user
        poly = _path_to_polygon(
            pts,
            width,
            int(element.get("pathtype", 0)),
            float(element.get("bgnextn", 0.0)) * unit_user,
            float(element.get("endextn", 0.0)) * unit_user,
        )
        if poly is not None:
            cell.polygons.append(
                GdsPolygon(
                    layer=int(element["layer"]),
                    datatype=int(element["datatype"]),
                    points=poly,
                    from_path=True,
                )
            )


#: miter joins longer than this many half-widths fall back to a bevel
_MITER_LIMIT = 4.0
#: segments per semicircular (pathtype 1) end cap
_CAP_SEGMENTS = 8


def _path_to_polygon(
    pts: np.ndarray, width: float, pathtype: int, bgnextn: float, endextn: float
) -> np.ndarray | None:
    """Stroke a PATH centerline into a boundary polygon.

    The reference renders PATH elements through gdstk's path-to-polygon
    conversion; this is the self-contained equivalent: constant-width offset
    with mitred joins (bevelled past ``_MITER_LIMIT``), flush (pathtype 0),
    half-width-extended square (2), custom-extension (4) or semicircular
    (1, ``_CAP_SEGMENTS``-segment approximation) end caps.
    """
    pts = np.asarray(pts, dtype=np.float64)
    # a negative WIDTH means "absolute" (not scaled by magnification) in the
    # GDSII spec; the magnitude is the width either way
    width = abs(width)
    # drop zero-length segments
    if pts.shape[0] >= 2:
        keep = np.ones(pts.shape[0], dtype=bool)
        keep[1:] = np.linalg.norm(np.diff(pts, axis=0), axis=1) > 1e-12
        pts = pts[keep]
    if pts.shape[0] < 2 or width <= 0.0:
        return None
    h = 0.5 * width
    if pathtype == 2:
        ext0 = ext1 = h
    elif pathtype == 4:
        ext0, ext1 = bgnextn, endextn
    else:  # flush (0) and round (1): caps centred on the endpoints
        ext0 = ext1 = 0.0

    d = np.diff(pts, axis=0)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    normals = np.column_stack([-d[:, 1], d[:, 0]])
    p0 = pts[0] - ext0 * d[0]
    p1 = pts[-1] + ext1 * d[-1]

    def side(sign: float) -> list[np.ndarray]:
        out = [p0 + sign * h * normals[0]]
        for i in range(1, pts.shape[0] - 1):
            n_a, n_b = normals[i - 1], normals[i]
            denom = 1.0 + float(n_a @ n_b)
            if denom > 2.0 / (_MITER_LIMIT**2):
                out.append(pts[i] + sign * h * (n_a + n_b) / denom)
            else:  # near-reversal: bevel with both segment offsets
                out.append(pts[i] + sign * h * n_a)
                out.append(pts[i] + sign * h * n_b)
        out.append(p1 + sign * h * normals[-1])
        return out

    left = side(1.0)
    right = side(-1.0)

    def arc(center, frm, to) -> list[np.ndarray]:
        # the ring (left forward, right reversed) runs clockwise before the
        # final orientation fix, so caps bulge outward by decreasing angle
        a0 = np.arctan2(frm[1] - center[1], frm[0] - center[0])
        a1 = np.arctan2(to[1] - center[1], to[0] - center[0])
        while a1 >= a0:
            a1 -= 2.0 * np.pi
        angles = a0 + (a1 - a0) * np.arange(1, _CAP_SEGMENTS) / _CAP_SEGMENTS
        return [center + h * np.array([np.cos(t), np.sin(t)]) for t in angles]

    ring: list[np.ndarray] = []
    ring.extend(left)
    if pathtype == 1:
        ring.extend(arc(pts[-1], left[-1], right[-1]))
    ring.extend(reversed(right))
    if pathtype == 1:
        ring.extend(arc(pts[0], right[0], left[0]))
    poly = np.asarray(ring)
    if polygon_signed_area(poly) < 0:
        poly = poly[::-1]
    return poly


def read_gds_polygons(path: str | Path, include_paths: bool = True) -> list[GdsPolygon]:
    """All polygons of all top-level cells, flattened through references.

    ``include_paths=True`` (default) strokes PATH elements into polygons —
    a deliberate extension over the reference, whose gdstk pipeline reads
    only ``cell.polygons`` and silently drops paths
    (reference ``qpsim/geometry.py:38``).  Pass ``include_paths=False``
    to reproduce the reference's masks bit-for-bit on PATH-bearing layouts.
    """
    lib = read_gds_library(path)
    out: list[GdsPolygon] = []
    for top in lib.top_level():
        out.extend(lib.flatten_cell(top))
    if not include_paths:
        out = [p for p in out if not p.from_path]
    return out


def discover_gds_layers(gds_path: str | Path) -> list[int]:
    layers = sorted({p.layer for p in read_gds_polygons(gds_path)})
    if not layers:
        raise ValueError("No polygons were found in the selected GDS file.")
    return layers


# --- rasterization -----------------------------------------------------------

_native_lib = None
_native_checked = False

#: the rasterizer's source (shared with ``qpsim_tpu``, never edited here) and
#: the flags of ``native/Makefile``; the library goes to this package's build
#: directory, not beside either package
_NATIVE_SRC = Path(__file__).resolve().parents[2] / "native" / "gds_raster.cpp"
_CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17"]


def native_library_path() -> Path | None:
    """Where the rasterizer library of this source and these flags lives (None: no source)."""
    if not _NATIVE_SRC.is_file():
        return None
    h = hashlib.sha256(_NATIVE_SRC.read_bytes() + repr(_CXX_FLAGS).encode()).hexdigest()[:16]
    return build_dir() / f"libgdsraster_{h}.so"


def _build_native(target: Path) -> None:
    """Compile the rasterizer with the host C++ compiler; silent when there is none."""
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        return
    target.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=target.parent) as tmp_dir:
        tmp_lib = Path(tmp_dir) / target.name
        try:
            proc = subprocess.run(
                [cxx, *_CXX_FLAGS, "-o", str(tmp_lib), str(_NATIVE_SRC)],
                capture_output=True,
                timeout=120,
                check=False,
            )
        except (OSError, subprocess.SubprocessError):
            return
        if proc.returncode == 0:
            # rename into place: a concurrent build never sees half a library
            os.replace(tmp_lib, target)


def _load_native():
    global _native_lib, _native_checked
    if _native_checked:
        return _native_lib
    _native_checked = True
    so_path = native_library_path()
    if so_path is None:
        return None
    if not so_path.exists():
        _build_native(so_path)
    try:
        lib = ctypes.CDLL(str(so_path))
        lib.gds_accumulate_winding.argtypes = [
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_int64,
            ctypes.c_double,
            ctypes.c_double,
            ctypes.c_double,
            ctypes.c_double,
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.gds_accumulate_winding.restype = None
        _native_lib = lib
    except OSError:
        _native_lib = None
    return _native_lib


def native_raster_available() -> bool:
    return _load_native() is not None


def _winding_grid(
    polygons: list[np.ndarray],
    weights: list[int],
    x0: float,
    y0: float,
    mesh: float,
    nx: int,
    ny: int,
) -> np.ndarray:
    lib = _load_native()
    accum = np.zeros((ny, nx), dtype=np.int32)
    if lib is not None:
        acc_ptr = accum.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
        for poly, weight in zip(polygons, weights):
            p = np.ascontiguousarray(poly, dtype=np.float64)
            lib.gds_accumulate_winding(
                p.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                p.shape[0],
                x0,
                y0,
                mesh,
                mesh,
                nx,
                ny,
                int(weight),
                acc_ptr,
            )
        return accum
    # numpy fallback: chunked point-in-polygon winding accumulation
    xc = x0 + (np.arange(nx) + 0.5) * mesh
    yc = y0 + (np.arange(ny) + 0.5) * mesh
    gx, gy = np.meshgrid(xc, yc)
    pts = np.column_stack([gx.ravel(), gy.ravel()])
    flat = accum.reshape(-1)
    chunk = 262_144
    for poly, weight in zip(polygons, weights):
        for lo in range(0, pts.shape[0], chunk):
            inside = points_in_polygon(poly, pts[lo : lo + chunk])
            flat[lo : lo + chunk] += weight * inside.astype(np.int32)
    return accum


def rasterize_gds_layer(
    gds_path: str | Path,
    layer: int,
    mesh_size: float,
    include_paths: bool = True,
) -> tuple[np.ndarray, list[float]]:
    """Rasterize one layer onto a cell-centered grid → (mask, bounds).

    Reference semantics (geometry.py:57-108): one mesh cell of padding on
    every side (explicit outer boundary for edge picking), at least 8 cells
    per dimension, orientation-aware winding so reversed contours cut holes.
    """
    if mesh_size <= 0:
        raise ValueError("Mesh size must be positive.")
    polys = [
        p.points
        for p in read_gds_polygons(gds_path, include_paths=include_paths)
        if p.layer == int(layer)
    ]
    if not polys:
        raise ValueError(f"No polygons found on layer {layer}.")

    allpts = np.vstack(polys)
    min_x, min_y = allpts.min(axis=0) - mesh_size
    max_x, max_y = allpts.max(axis=0) + mesh_size
    nx = max(8, int(np.ceil((max_x - min_x) / mesh_size)))
    ny = max(8, int(np.ceil((max_y - min_y) / mesh_size)))

    areas = [polygon_signed_area(p) for p in polys]
    dominant = np.sign(areas[int(np.argmax(np.abs(areas)))]) or 1.0
    weights = [1 if (np.sign(a) or dominant) == dominant else -1 for a in areas]

    accum = _winding_grid(polys, weights, float(min_x), float(min_y), mesh_size, nx, ny)
    mask = accum > 0
    if not mask.any():
        raise ValueError("Layer rasterization produced an empty geometry mask.")
    return mask, [float(min_x), float(min_y), float(max_x), float(max_y)]


def create_geometry_from_gds(
    gds_path: str | Path, layer: int, mesh_size: float, include_paths: bool = True
) -> GeometryData:
    mask, bounds = rasterize_gds_layer(gds_path, layer, mesh_size, include_paths)
    n_components = connected_component_count(mask)
    if n_components != 1:
        raise ValueError(
            "Geometry must have exactly one connected region. "
            f"Found {n_components} connected regions."
        )
    return GeometryData(
        name=f"{Path(gds_path).stem}_L{layer}",
        source_path=str(gds_path),
        layer=int(layer),
        mesh_size=float(mesh_size),
        mask=mask.astype(int).tolist(),
        edges=extract_edge_segments(mask),
        bounds=bounds,
    )


# --- writer --------------------------------------------------------------------


def _record(rectype: int, dtype: int, payload: bytes = b"") -> bytes:
    return struct.pack(">HBB", 4 + len(payload), rectype, dtype) + payload


def _ascii_record(rectype: int, text: str) -> bytes:
    raw = text.encode("ascii")
    if len(raw) % 2:
        raw += b"\x00"
    return _record(rectype, 6, raw)


def write_gds(
    path: str | Path,
    polygons_by_cell: dict[str, Iterable[tuple[int, np.ndarray]]],
    *,
    lib_name: str = "QPSIMTPU",
    unit_user: float = 1e-3,
    unit_meters: float = 1e-9,
) -> Path:
    """Write a minimal GDSII file: cells of (layer, polygon-points) tuples.

    Points are in user units (µm by default) and converted to integer
    database units with the given UNITS record.  Enough for fixtures,
    round-trip tests, and exporting rasterized geometries back to layout.

    An entry may also be ``(layer, points, width)`` or
    ``(layer, points, width, pathtype)`` — written as a PATH element with
    the given centerline and width.
    """
    ts = struct.pack(">12h", 2026, 1, 1, 0, 0, 0, 2026, 1, 1, 0, 0, 0)
    blob = bytearray()
    blob += _record(_HEADER, 2, struct.pack(">h", 600))
    blob += _record(_BGNLIB, 2, ts)
    blob += _ascii_record(_LIBNAME, lib_name)
    blob += _record(_UNITS, 5, _pack_real8(unit_user) + _pack_real8(unit_meters))
    for cell_name, polys in polygons_by_cell.items():
        blob += _record(_BGNSTR, 2, ts)
        blob += _ascii_record(_STRNAME, cell_name)
        for entry in polys:
            layer, points = entry[0], entry[1]
            pts = np.asarray(points, dtype=np.float64)
            db = np.rint(pts / unit_user).astype(np.int64)
            if len(entry) >= 3:  # PATH: centerline + width (+ pathtype)
                blob += _record(_PATH, 0)
                blob += _record(_LAYER, 2, struct.pack(">h", int(layer)))
                blob += _record(_DATATYPE, 2, struct.pack(">h", 0))
                if len(entry) >= 4:
                    blob += _record(_PATHTYPE, 2, struct.pack(">h", int(entry[3])))
                width_db = int(round(float(entry[2]) / unit_user))
                blob += _record(_WIDTH, 3, struct.pack(">i", width_db))
                blob += _record(_XY, 3, db.astype(">i4").tobytes())
            else:
                closed = np.vstack([db, db[:1]])
                blob += _record(_BOUNDARY, 0)
                blob += _record(_LAYER, 2, struct.pack(">h", int(layer)))
                blob += _record(_DATATYPE, 2, struct.pack(">h", 0))
                blob += _record(_XY, 3, closed.astype(">i4").tobytes())
            blob += _record(_ENDEL, 0)
        blob += _record(_ENDSTR, 0)
    blob += _record(_ENDLIB, 0)
    out = Path(path)
    out.write_bytes(bytes(blob))
    return out
