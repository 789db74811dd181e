"""Masked diffusion operators on a dense 2D grid, split by direction.

The reference simulator assembles one sparse masked Laplacian and factorises
it with SuperLU (``reference qpsim/solver.py:152-321``).  Sparse LU has
no accelerator story, so this module represents the same operator as **dense
coefficient planes** over the full (Ny, Nx) grid, split into an x-part and a
y-part:

    (L u)[p] = (Lx u)[p] + (Ly u)[p]
    (Ld u)[p] = a_lo[p]·u[p−1] + a_hi[p]·u[p+1] + diag_d[p]·u[p]

with masked-out cells carrying all-zero coefficients (so ``(I − αL)u = u``
there and they stay inert).  The split form feeds two execution paths:

* **ADI** (Peaceman–Rachford): batched tridiagonal solves along x then y —
  exactly Crank–Nicolson for 1D strips, O(dt²-)consistent with unsplit CN in
  2D, and it scales to 1024² grids.
* **Dense spectral**: the split parts are assembled into the exact masked
  P×P matrix; a single symmetric eigendecomposition turns every CN solve
  into two dense matmuls (see ``qpsim_tpu_torch.solver.diffusion_backends``).

Boundary-condition discretisation matches the reference per-face formulas
(``solver.py:112-149``; variable-D variant ``solver.py:275-318``):

    reflective: no terms
    absorbing:  −2·D_p/dx² on the diagonal
    dirichlet:  −2·D_p/dx² diagonal, +2·D_p·g/dx² source
    neumann:    +D_p·q/dx source
    robin:      −D_p·β/dx diagonal, +D_p·γ/dx source

Interior couplings use the harmonic mean of the two cells' D when D varies
spatially (``solver.py:283``) and plain D elsewhere.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..models.params import BoundaryCondition, EdgeSegment
from ..geometry.mask import boundary_face_map

__all__ = [
    "BoundaryAssignmentError",
    "DirectionalStencil",
    "SplitOperator",
    "build_directional_stencils",
    "fold_diffusion",
    "assemble_dense_operator",
    "active_indices",
]


class BoundaryAssignmentError(ValueError):
    """An exposed boundary face has no boundary condition assigned."""


_X_DIRECTIONS = ("left", "right")
_Y_DIRECTIONS = ("up", "down")


@dataclass
class DirectionalStencil:
    """Unscaled (D-free) 1D stencil data for one grid direction.

    ``couple_lo``/``couple_hi`` flag interior couplings to the previous/next
    cell along the direction; ``bc_diag``/``bc_src`` collect the
    D-independent part of the boundary terms (1/dx factors already folded).
    """

    couple_lo: np.ndarray  # (Ny, Nx) float64 in {0, 1}
    couple_hi: np.ndarray
    bc_diag: np.ndarray  # (Ny, Nx) float64
    bc_src: np.ndarray  # (Ny, Nx) float64


@dataclass
class SplitOperator:
    """Diffusion operator with D folded in, ready for device upload.

    All arrays broadcast to (NB, Ny, Nx) where NB is the number of energy
    bins (1 in scalar mode).  ``diag`` already includes the −(a_lo + a_hi)
    interior part plus the D-scaled boundary diagonal.

    When D is spatially uniform per bin, every term is *linear in D*, so the
    operator factors as ``bin_scale[b] × (unit-D geometric arrays)``: the
    spatial arrays stay (1, Ny, Nx) and ``bin_scale`` holds D(E) as
    (NB, 1, 1).  Consumers must multiply lazily (broadcast at use) — this
    keeps (NB, Ny, Nx) coefficient planes out of device memory.
    ``bin_scale`` is None for spatially-varying D (harmonic-mean face
    coefficients are not separable).
    """

    ax_lo: np.ndarray
    ax_hi: np.ndarray
    ax_diag: np.ndarray
    sx: np.ndarray
    ay_lo: np.ndarray
    ay_hi: np.ndarray
    ay_diag: np.ndarray
    sy: np.ndarray
    mask: np.ndarray  # (Ny, Nx) bool
    bin_scale: np.ndarray | None = None  # (NB, 1, 1) or None

    @property
    def num_bins(self) -> int:
        if self.bin_scale is not None:
            return int(self.bin_scale.shape[0])
        return int(self.ax_lo.shape[0])

    def source_total(self) -> np.ndarray:
        return self.sx + self.sy

    def materialized(self, field: np.ndarray) -> np.ndarray:
        """One field with bin_scale folded in (host-side, for assembly/tests)."""
        if self.bin_scale is None:
            return field
        return self.bin_scale * field


def _face_bc_lookup(
    edges: list[EdgeSegment],
    edge_conditions: dict[str, BoundaryCondition],
) -> dict[tuple[int, int, str], BoundaryCondition]:
    missing = [e.edge_id for e in edges if e.edge_id not in edge_conditions]
    if missing:
        raise BoundaryAssignmentError(
            "All edges must be assigned boundary conditions before simulation. "
            f"Missing: {len(missing)}"
        )
    lookup: dict[tuple[int, int, str], BoundaryCondition] = {}
    for edge in edges:
        bc = edge_conditions[edge.edge_id]
        checked = BoundaryCondition(
            kind=bc.normalized_kind(), value=bc.value, aux_value=bc.aux_value
        )
        checked.validate()
        for face in edge.faces:
            lookup[(face.row, face.col, face.direction)] = checked
    return lookup


def build_directional_stencils(
    mask: np.ndarray,
    edges: list[EdgeSegment],
    edge_conditions: dict[str, BoundaryCondition],
    dx: float,
) -> tuple[DirectionalStencil, DirectionalStencil]:
    """Build (x_stencil, y_stencil) for a masked grid with per-edge BCs.

    Raises :class:`BoundaryAssignmentError` when any exposed face lacks a
    boundary condition (matching the reference's strictness).
    """
    if dx <= 0:
        raise ValueError("dx must be positive.")
    m = np.asarray(mask, dtype=bool)
    if m.ndim != 2:
        raise ValueError("mask must be 2D.")
    if not m.any():
        raise ValueError("Geometry mask has no interior points.")

    inv_dx = 1.0 / dx
    inv_dx2 = inv_dx * inv_dx
    faces = boundary_face_map(m)
    face_bc = _face_bc_lookup(edges, edge_conditions)

    def make(directions: tuple[str, str]) -> DirectionalStencil:
        lo_dir, hi_dir = directions
        couple_lo = (m & ~faces[lo_dir]).astype(np.float64)
        couple_hi = (m & ~faces[hi_dir]).astype(np.float64)
        bc_diag = np.zeros(m.shape, dtype=np.float64)
        bc_src = np.zeros(m.shape, dtype=np.float64)
        for direction in directions:
            rows, cols = np.nonzero(faces[direction])
            for r, c in zip(rows.tolist(), cols.tolist()):
                bc = face_bc.get((r, c, direction))
                if bc is None:
                    raise BoundaryAssignmentError(
                        f"Missing boundary condition for face at cell ({r}, {c}) "
                        f"direction '{direction}'."
                    )
                kind = bc.kind
                if kind == "reflective":
                    continue
                if kind == "absorbing":
                    bc_diag[r, c] += -2.0 * inv_dx2
                elif kind == "dirichlet":
                    g = float(bc.value or 0.0)
                    bc_diag[r, c] += -2.0 * inv_dx2
                    bc_src[r, c] += 2.0 * g * inv_dx2
                elif kind == "neumann":
                    bc_src[r, c] += float(bc.value or 0.0) * inv_dx
                elif kind == "robin":
                    bc_diag[r, c] += -float(bc.value or 0.0) * inv_dx
                    bc_src[r, c] += float(bc.aux_value or 0.0) * inv_dx
                else:  # pragma: no cover — BoundaryCondition.validate rejects this
                    raise BoundaryAssignmentError(f"Unsupported boundary kind: {kind}")
        return DirectionalStencil(couple_lo, couple_hi, bc_diag, bc_src)

    return make(_X_DIRECTIONS), make(_Y_DIRECTIONS)


def _shift_lo(arr: np.ndarray, axis: int) -> np.ndarray:
    """Value of the previous cell along axis (zero-padded)."""
    out = np.zeros_like(arr)
    src = [slice(None)] * arr.ndim
    dst = [slice(None)] * arr.ndim
    src[axis] = slice(None, -1)
    dst[axis] = slice(1, None)
    out[tuple(dst)] = arr[tuple(src)]
    return out


def _shift_hi(arr: np.ndarray, axis: int) -> np.ndarray:
    out = np.zeros_like(arr)
    src = [slice(None)] * arr.ndim
    dst = [slice(None)] * arr.ndim
    src[axis] = slice(1, None)
    dst[axis] = slice(None, -1)
    out[tuple(dst)] = arr[tuple(src)]
    return out


def fold_diffusion(
    x_st: DirectionalStencil,
    y_st: DirectionalStencil,
    mask: np.ndarray,
    dx: float,
    D: np.ndarray | float,
) -> SplitOperator:
    """Fold the diffusion coefficient into directional stencils.

    Parameters
    ----------
    D:
        scalar           — uniform everywhere (scalar mode);
        (NB,)            — per-energy-bin uniform D(E);
        (NB, Ny, Nx)     — per-bin, per-pixel D(E, x) (non-uniform gap);
                           interior couplings then use the harmonic mean of
                           neighbouring D and boundary terms scale by D_p.
    """
    m = np.asarray(mask, dtype=bool)
    inv_dx2 = 1.0 / (dx * dx)
    D_arr = np.asarray(D, dtype=np.float64)
    if D_arr.ndim == 0:
        D_arr = D_arr.reshape(1, 1, 1)
    elif D_arr.ndim == 1:
        D_arr = D_arr[:, None, None]
    elif D_arr.ndim != 3:
        raise ValueError("D must be scalar, (NB,) or (NB, Ny, Nx).")

    spatially_varying = D_arr.shape[1:] != (1, 1)

    def fold(st: DirectionalStencil, axis: int) -> tuple[np.ndarray, ...]:
        if spatially_varying:
            D_here = np.where(m, D_arr, 0.0)
            D_lo = _shift_lo(D_here, axis + 1)  # +1: leading bin axis
            D_hi = _shift_hi(D_here, axis + 1)
            denom_lo = np.maximum(D_here + D_lo, 1e-30)
            denom_hi = np.maximum(D_here + D_hi, 1e-30)
            D_face_lo = 2.0 * D_here * D_lo / denom_lo
            D_face_hi = 2.0 * D_here * D_hi / denom_hi
            a_lo = st.couple_lo[None] * D_face_lo * inv_dx2
            a_hi = st.couple_hi[None] * D_face_hi * inv_dx2
            diag = -(a_lo + a_hi) + st.bc_diag[None] * D_here
            src = st.bc_src[None] * D_here
        else:
            # uniform D per bin: every term is linear in D — keep unit-D
            # geometry and factor D out as bin_scale
            a_lo = st.couple_lo[None] * inv_dx2
            a_hi = st.couple_hi[None] * inv_dx2
            diag = -(a_lo + a_hi) + st.bc_diag[None]
            src = st.bc_src[None].copy()
        return a_lo, a_hi, diag, src

    ax_lo, ax_hi, ax_diag, sx = fold(x_st, axis=1)
    ay_lo, ay_hi, ay_diag, sy = fold(y_st, axis=0)
    return SplitOperator(
        ax_lo=ax_lo,
        ax_hi=ax_hi,
        ax_diag=ax_diag,
        sx=sx,
        ay_lo=ay_lo,
        ay_hi=ay_hi,
        ay_diag=ay_diag,
        sy=sy,
        mask=m,
        bin_scale=None if spatially_varying else D_arr,
    )


def active_indices(mask: np.ndarray) -> np.ndarray:
    """Row-major flat indices of interior cells (the reference's pixel order)."""
    return np.flatnonzero(np.asarray(mask, dtype=bool).ravel())


def assemble_dense_operator(op: SplitOperator) -> tuple[np.ndarray, np.ndarray]:
    """Assemble the exact masked P×P operator and P source vector per bin.

    Equals the reference's sparse ``build_laplacian_with_boundaries`` /
    ``build_variable_diffusion_laplacian`` matrices (with D folded in),
    restricted to interior cells in row-major order.  Used by the dense
    spectral backend and by operator-parity tests.
    """
    m = op.mask
    ny, nx = m.shape
    flat_active = active_indices(m)
    p = flat_active.size
    dense_to_compact = -np.ones(ny * nx, dtype=np.int64)
    dense_to_compact[flat_active] = np.arange(p)

    nb = op.num_bins
    L = np.zeros((nb, p, p), dtype=np.float64)
    src = np.zeros((nb, p), dtype=np.float64)

    ax_lo = op.materialized(op.ax_lo)
    ax_hi = op.materialized(op.ax_hi)
    ax_diag = op.materialized(op.ax_diag)
    ay_lo = op.materialized(op.ay_lo)
    ay_hi = op.materialized(op.ay_hi)
    ay_diag = op.materialized(op.ay_diag)
    sx = op.materialized(op.sx)
    sy = op.materialized(op.sy)

    rows_idx, cols_idx = np.nonzero(m)
    for k, (r, c) in enumerate(zip(rows_idx.tolist(), cols_idx.tolist())):
        for b in range(nb):
            bb = min(b, ax_lo.shape[0] - 1)
            L[b, k, k] += ax_diag[bb, r, c] + ay_diag[bb, r, c]
            src[b, k] = sx[bb, r, c] + sy[bb, r, c]
            if ax_lo[bb, r, c] != 0.0:
                q = dense_to_compact[r * nx + (c - 1)]
                L[b, k, q] += ax_lo[bb, r, c]
            if ax_hi[bb, r, c] != 0.0:
                q = dense_to_compact[r * nx + (c + 1)]
                L[b, k, q] += ax_hi[bb, r, c]
            if ay_lo[bb, r, c] != 0.0:
                q = dense_to_compact[(r - 1) * nx + c]
                L[b, k, q] += ay_lo[bb, r, c]
            if ay_hi[bb, r, c] != 0.0:
                q = dense_to_compact[(r + 1) * nx + c]
                L[b, k, q] += ay_hi[bb, r, c]
    return L, src
