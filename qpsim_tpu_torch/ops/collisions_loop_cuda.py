"""The collision substep walked by energy-offset columns: K8, and the column form it shares with K9.

Port of ``qpsim_tpu.ops.pallas_collisions_loop.build_pallas_collision_step_loop``
(K8), an explicit entry point of the JAX package that its ``auto``
dispatch never reaches.  On a uniform energy grid Eᵢ − Eⱼ and Eᵢ + Eⱼ
depend only on the offset k = i − j and the anti-diagonal s = i + j, so
every pair on one offset shares the phonon row ``diff_row[k]`` and every
pair on one anti-diagonal the row ``sum_row[s]``.  The substep is written
as **columns**: a scattering column has an offset k, an ω row and four
(G, NE, C) tables re-indexing dE·K^s₀ —

    e_up[i, c] = dE·K[i+k, i]   e_dn[i, c] = dE·K[i, i−k]
    a_up[i, c] = dE·K[i, i+k]   a_dn[i, c] = dE·K[i−k, i]

— and a recombination column an anti-diagonal s, an ω row and R[i, c] =
2dE·K^r₀[i, s−i].  K8 keeps one column per offset and per anti-diagonal
(the JAX builder's ``_offset_tables`` and ``_antidiag_table``, so it
returns ``None`` where a diagonal splits two ω bins); K9
(:mod:`qpsim_tpu_torch.ops.collisions_rows_cuda`) one per (offset, ω row)
and (anti-diagonal, ω row) group.  On CUDA tensors both launch the column
walk of :mod:`qpsim_tpu_torch.ops.column_walk` (``csrc/offset_walk.cu``,
which K5 and K6 launch too), on CPU tensors they run the plain column walk
(:func:`collision_step_loop_plain`).  They compute the collision substep
of K3 (:func:`~qpsim_tpu_torch.ops.collisions.collision_step_plain`)
without a generation plane.

The kernel reads e_dn and a_dn only (e_up[i] = e_dn[i+k], a_up[i] =
a_dn[i+k]), packed as one (G, NE, C, 2) table.  The host tables are built
in float64, as the JAX builders build theirs, and moved to the device once
per dtype.  The host helpers below are the JAX package's
(``pallas_collisions._uniform_pair_rows``, ``_grid_uniform``;
``pallas_collisions_loop._round_up``, ``_offset_tables``,
``_antidiag_table``), copied unchanged and pinned equal to them by
``tests/test_torch_offset_walks.py``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..utils.cuda_build import refuse_grad
from .collisions import _affine_growth_update, _relaxation_update
from .collisions_cuda import LAUNCHES
from .column_walk import ColumnTables, column_tables, launch_column_walk, row_lists
from .phonon_map import PhononFrequencyMap

__all__ = [
    "OffsetWalk",
    "WalkStep",
    "build_collision_step_loop",
    "collision_step_loop_plain",
]

_RHO_FLOOR = 1e-30


# ---------------------------------------------------------------- host helpers (JAX package's)


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _grid_uniform(E_bins: np.ndarray) -> bool:
    diffs = np.diff(E_bins)
    return E_bins.size < 2 or bool(np.allclose(diffs, diffs[0], rtol=1e-9))


def _uniform_pair_rows(E_bins: np.ndarray, pmap: PhononFrequencyMap):
    """Static ω-row tables for a uniform grid: diff_row[k]=ω(k·dE), sum_row[m].

    Returns ``None`` when the grid is non-uniform — or when the ω-bin
    assignment is NOT constant along the Toeplitz/Hankel diagonals (the ω
    grid's round-at-1e-12 dedup can split one diagonal over two bins, e.g.
    NE=11 at Δ=180, E_max/Δ=4).
    """
    ne = E_bins.size
    diffs = np.diff(E_bins)
    if ne > 1 and not np.allclose(diffs, diffs[0], rtol=1e-9):
        return None
    for k in range(1, ne):
        i = np.arange(k, ne)
        if not np.all(pmap.idx_diff[i, i - k] == pmap.idx_diff[k, 0]):
            return None
    for m in range(2 * ne - 1):
        i = np.arange(max(0, m - ne + 1), min(ne, m + 1))
        if not np.all(pmap.idx_sum[i, m - i] == pmap.idx_sum[i[0], m - i[0]]):
            return None
    diff_row = [int(pmap.idx_diff[k, 0]) for k in range(ne)]  # |E_k − E_0| = k·dE
    sum_row = [int(pmap.idx_sum[min(m, ne - 1), m - min(m, ne - 1)]) for m in range(2 * ne - 1)]
    return diff_row, sum_row


def _offset_tables(K: np.ndarray, ne: int, ne_pad: int, kp: int):
    """Per-offset coefficient tables for the scattering walk.

    e_up[j, k] = K[j+k, j]   (emission, source row j)
    e_dn[i, k] = K[i, i−k]   (emission, destination row i)
    a_up[i, k] = K[i, i+k]   (absorption, source row i)
    a_dn[j, k] = K[j−k, j]   (absorption, destination row j)
    Entries outside the valid triangle are zero.
    """
    e_up = np.zeros((ne_pad, kp))
    e_dn = np.zeros((ne_pad, kp))
    a_up = np.zeros((ne_pad, kp))
    a_dn = np.zeros((ne_pad, kp))
    for k in range(1, ne):
        j = np.arange(0, ne - k)
        e_up[j, k] = K[j + k, j]
        a_up[j, k] = K[j, j + k]
        i = np.arange(k, ne)
        e_dn[i, k] = K[i, i - k]
        a_dn[i, k] = K[i - k, i]
    return e_up, e_dn, a_up, a_dn


def _antidiag_table(K: np.ndarray, ne: int, ne_pad: int, sp: int) -> np.ndarray:
    """R[i, s] = K[i, s−i] (recombination anti-diagonals), zero-padded."""
    R = np.zeros((ne_pad, sp))
    for s in range(2 * ne - 1):
        i = np.arange(max(0, s - ne + 1), min(ne, s + 1))
        R[i, s] = K[i, s - i]
    return R


# ---------------------------------------------------------------- the column form


@dataclass
class OffsetWalk:
    """One substep in column form, on the host in float64 (see the module docstring).

    ``scat`` holds (e_up, e_dn, a_up, a_dn), each (G, NE, Cs), scaled by dE;
    ``rec`` R (G, NE, Cr), scaled by 2dE; either is None when its channel is
    off.  Columns are sorted by offset and by anti-diagonal.  ``gap_id`` is
    the dense (Ny·Nx,) plane of gap ids (None on a uniform gap).
    """

    num_energy_bins: int
    num_omega: int
    dt: float
    update_phonons: bool
    rho: np.ndarray  # (G, NE)
    scat_k: np.ndarray  # (Cs,) offsets
    scat_row: np.ndarray  # (Cs,) ω rows
    scat: tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray] | None
    rec_s: np.ndarray  # (Cr,) anti-diagonals, ascending
    rec_row: np.ndarray  # (Cr,) ω rows
    rec: np.ndarray | None
    gap_id: np.ndarray | None

    def row_lists(self) -> tuple[np.ndarray, np.ndarray]:
        """(row_ptr, row_code) of :func:`~qpsim_tpu_torch.ops.column_walk.row_lists`
        for this walk's channels."""
        return row_lists(self.num_omega, None if self.scat is None else self.scat_row,
                          None if self.rec is None else self.rec_row)


def collision_step_loop_plain(step: WalkStep, n_qp: torch.Tensor,
                              n_ph: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version of a K8 or K9 step: its column walk in PyTorch, one
    column at a time, vectorised over bins and pixels, on the step's device
    (whatever it is).  Inputs are not modified."""
    walk, tables = step.walk, step._checked(n_qp, n_ph)
    ne, nw = walk.num_energy_bins, walk.num_omega
    q = n_qp.reshape(ne, -1)
    ph = n_ph.reshape(nw, -1)
    gid = None if tables.gid is None else tables.gid.long()
    # a (G, NE[, C]) table as (NE, 1) on a uniform gap, (NE, P) per pixel
    per_px = (lambda t: t[0, :, None]) if gid is None else (lambda t: t[gid].T)
    rho = per_px(tables.rho)
    partner = rho * torch.clamp(1.0 - q / torch.clamp(rho, min=_RHO_FLOOR), min=0.0)
    loss = torch.zeros_like(q)
    gain = torch.zeros_like(q)
    phonons = walk.update_phonons
    if phonons:
        a_ph = torch.zeros_like(ph)
        b_ph = torch.zeros_like(ph)
    if tables.scat is not None:
        for c, (k, row) in enumerate(zip(walk.scat_k.tolist(), walk.scat_row.tolist())):
            n = ne - k
            d = ph[row]
            em = 1.0 + d  # emission: 1 + n_ph; absorption: n_ph
            # the column's pairs (m, m−k), m ≥ k: K[m, m−k] and K[m−k, m]
            ed, ad = per_px(tables.scat[:, :, c, 0])[k:], per_px(tables.scat[:, :, c, 1])[k:]
            loss[k:] += ed * em * partner[:n]  # emission i → i−k
            gain[k:] += ad * d * q[:n]  # absorption i−k → i
            loss[:n] += ad * d * partner[k:]  # absorption i → i+k
            gain[:n] += ed * em * q[k:]  # emission i+k → i
            if phonons:
                p_em = (ed * q[k:] * partner[:n]).sum(0)
                p_ab = (ad * q[:n] * partner[k:]).sum(0)
                a_ph[row] += p_em
                b_ph[row] += p_em - p_ab
    if tables.rec is not None:
        for c, (s, row) in enumerate(zip(walk.rec_s.tolist(), walk.rec_row.tolist())):
            lo, hi = max(0, s - ne + 1), min(ne - 1, s) + 1
            sv = ph[row]
            r = per_px(tables.rec[:, :, c])[lo:hi]
            q_s = q[s - hi + 1 : s - lo + 1].flip(0)  # q_s[i] = q[s − i]
            p_s = partner[s - hi + 1 : s - lo + 1].flip(0)
            loss[lo:hi] += r * (1.0 + sv) * q_s
            gain[lo:hi] += r * sv * p_s
            if phonons:
                k_r = 0.5 * r  # dE·K^r₀
                rec = (k_r * q[lo:hi] * q_s).sum(0)
                pb = (k_r * partner[lo:hi] * p_s).sum(0)
                a_ph[row] += rec
                b_ph[row] += rec - pb
    q_new = _relaxation_update(q, partner * gain, loss, walk.dt).reshape(n_qp.shape)
    if not phonons:
        return q_new, n_ph
    ph_new = ph.clone()  # rows no column lands on stay as they are
    t = tables.touched
    ph_new[t] = _affine_growth_update(ph[t], a_ph[t], b_ph[t], walk.dt)
    return q_new, ph_new.reshape(n_ph.shape)


class WalkStep:
    """``step(n_qp, n_ph) -> (n_qp, n_ph)`` of an :class:`OffsetWalk`.

    On CUDA tensors it launches ``csrc/offset_walk.cu`` (counted as
    ``counter`` in ``collisions_cuda.LAUNCHES``) or raises; on CPU tensors
    it runs :func:`collision_step_loop_plain`.  The tensors must lie on the device
    the step was built for; its tables move there once per dtype.
    """

    def __init__(self, walk: OffsetWalk, device, counter: str):
        self.walk = walk
        self.device = torch.device(device)
        self.counter = counter
        self._tables: dict[torch.dtype, ColumnTables] = {}

    def tables(self, dtype: torch.dtype) -> ColumnTables:
        if dtype not in self._tables:
            w = self.walk
            self._tables[dtype] = column_tables(
                num_energy_bins=w.num_energy_bins, num_omega=w.num_omega, scat_k=w.scat_k,
                scat_row=w.scat_row, scat=w.scat, rec_s=w.rec_s, rec_row=w.rec_row, rec=w.rec,
                device=self.device, dtype=dtype, rho=w.rho, gap_id=w.gap_id,
            )
        return self._tables[dtype]

    def _checked(self, n_qp: torch.Tensor, n_ph: torch.Tensor) -> ColumnTables:
        dev = self.device
        for name, t in (("n_qp", n_qp), ("n_ph", n_ph)):
            if t.device.type != dev.type or (dev.index is not None and t.device.index != dev.index):
                raise ValueError(f"{name} is on {t.device}; this step was built for {dev}")
            if t.dtype != n_qp.dtype or not t.is_contiguous():
                raise ValueError("n_qp and n_ph must be contiguous and of one dtype")
        ne, nw = self.walk.num_energy_bins, self.walk.num_omega
        if n_qp.ndim != 3 or n_qp.shape[0] != ne:
            raise ValueError(f"n_qp must be ({ne}, Ny, Nx), got {tuple(n_qp.shape)}")
        if tuple(n_ph.shape) != (nw, *n_qp.shape[1:]):
            raise ValueError(f"n_ph must be ({nw}, Ny, Nx), got {tuple(n_ph.shape)}")
        gid = self.walk.gap_id
        if gid is not None and gid.size != n_qp.shape[1] * n_qp.shape[2]:
            raise ValueError(f"the gap-id plane holds {gid.size} pixels, the state {tuple(n_qp.shape[1:])}")
        return self.tables(n_qp.dtype)

    def __call__(self, n_qp: torch.Tensor, n_ph: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        refuse_grad(f"the offset-walk kernel ({self.counter})",
                    "ops.collisions_loop_cuda.collision_step_loop_plain", n_qp, n_ph)
        if n_qp.device.type == "cpu":
            return collision_step_loop_plain(self, n_qp, n_ph)
        tables = self._checked(n_qp, n_ph)
        out = launch_column_walk(tables, n_qp, n_ph, self.walk.dt, None, self.walk.update_phonons)
        LAUNCHES[self.counter] += 1
        return out


def _identity(n_qp, n_ph):
    return n_qp, n_ph


def build_collision_step_loop(
    *,
    E_bins: np.ndarray,
    dE: float,
    rho: np.ndarray,
    K_s0: np.ndarray | None,
    K_r0: np.ndarray | None,
    pmap: PhononFrequencyMap,
    dt: float,
    update_phonons: bool = True,
    gap_id: np.ndarray | None = None,
    device="cuda",
):
    """K8: ``step(n_qp, n_ph)`` for one collision substep, or ``None``.

    The contract of ``build_pallas_collision_step_loop``: states (NE, Ny,
    Nx) and (NW, Ny, Nx); ``None`` for NE < 2 or where an ω diagonal splits
    (``_uniform_pair_rows``); the identity with neither channel on.  A gap
    map passes ``rho``/``K_s0``/``K_r0`` stacked (G, NE)/(G, NE, NE) with
    the dense (Ny, Nx) ``gap_id`` plane (0 on masked-out cells), any G (the
    kernel reads int32 ids); such a step
    counts its launches as ``collision_step_loop_gid``, a uniform gap as
    ``collision_step_loop``.
    """
    e = np.asarray(E_bins, dtype=np.float64)
    ne = int(e.size)
    if ne < 2:
        return None
    rows = _uniform_pair_rows(e, pmap)
    if rows is None:
        return None
    diff_row, sum_row = rows
    if K_s0 is None and K_r0 is None:
        return _identity
    rho_g = np.asarray(rho, dtype=np.float64)
    if rho_g.ndim == 1:
        rho_g = rho_g[None]
    n_gaps = rho_g.shape[0]
    multi_gap = gap_id is not None and n_gaps > 1
    used = n_gaps if multi_gap else 1  # without ids every pixel takes gap 0's tables
    stack = lambda K: np.asarray(K, dtype=np.float64).reshape(n_gaps, ne, ne)[:used]
    gid = None
    if multi_gap:
        gid = np.asarray(gap_id).reshape(-1)
        if gid.size and (gid.min() < 0 or gid.max() >= n_gaps):
            raise ValueError(f"gap ids must lie in [0, {n_gaps})")
    scat = None
    if K_s0 is not None:
        tabs = [_offset_tables(K, ne, ne, ne) for K in stack(K_s0)]
        # column k = 1 … NE − 1 (the tables' column 0 is empty)
        scat = tuple(float(dE) * np.stack([t[i] for t in tabs])[:, :, 1:] for i in range(4))
    rec = None
    if K_r0 is not None:
        rec = (2.0 * float(dE)) * np.stack([_antidiag_table(K, ne, ne, 2 * ne - 1) for K in stack(K_r0)])
    walk = OffsetWalk(
        num_energy_bins=ne, num_omega=pmap.num_omega, dt=float(dt),
        update_phonons=bool(update_phonons), rho=rho_g[:used],
        scat_k=np.arange(1, ne), scat_row=np.asarray(diff_row[1:], np.int64), scat=scat,
        rec_s=np.arange(2 * ne - 1), rec_row=np.asarray(sum_row, np.int64), rec=rec,
        gap_id=gid,
    )
    return WalkStep(walk, device, "collision_step_loop_gid" if multi_gap else "collision_step_loop")
