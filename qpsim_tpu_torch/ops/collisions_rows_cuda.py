"""The collision substep over static (offset, ω row) columns: K9.

Port of ``qpsim_tpu.ops.pallas_collisions_rows.build_pallas_collision_step_rows``
(K9), an explicit entry point of the JAX package (experimental there, never
auto-dispatched).  It walks the offsets and anti-diagonals as K8 does
(:mod:`qpsim_tpu_torch.ops.collisions_loop_cuda`), but keeps one column per
(offset, ω row) and (anti-diagonal, ω row) group, so a diagonal whose pairs
the ω grid splits over two bins becomes two columns and stays exact.  The
same CUDA kernel (``csrc/offset_walk.cu``, launched through
:mod:`qpsim_tpu_torch.ops.column_walk`) runs both; this module builds
K9's columns (:func:`columns`, also K5's and K6's grouping).  Uniform gap
only.

The grouping (:func:`_scattering_columns`, :func:`_recombination_columns`)
is the JAX builder's (``pallas_collisions_rows.py:136-178``), copied with
its tables unpadded, and pinned equal to it by
``tests/test_torch_offset_walks.py``.
"""

from __future__ import annotations

import numpy as np

from .collisions_loop_cuda import (
    OffsetWalk,
    WalkStep,
    _grid_uniform,
    _identity,
    collision_step_loop_plain,
)
from .phonon_map import PhononFrequencyMap

__all__ = [
    "MAX_ROWS_BINS",
    "build_collision_step_rows",
    "columns",
    "collision_step_rows_plain",
    "rows_walk",
]

#: energy bins the JAX builder takes (``_MAX_ROWS_BINS``, a Mosaic compile
#: limit of the TPU kernel).  The CUDA kernel does not need it; it is kept
#: so that both builders return ``None`` for the same grids.
MAX_ROWS_BINS = 72


def _scattering_columns(K_s0: np.ndarray, idx_diff: np.ndarray, ne: int, ne_pad: int):
    """One column per (offset k, ω row): ``(cols, (eu, ed, au, ad))``, each
    table (ne_pad, len(cols)) with zeros for pairs outside the group."""
    Ksm = np.asarray(K_s0, dtype=np.float64)
    scat_cols: list[tuple[int, int]] = []  # (offset k, ω row)
    cols_eu, cols_ed, cols_au, cols_ad = [], [], [], []
    for k in range(1, ne):
        i_all = np.arange(k, ne)
        dks = idx_diff[i_all, i_all - k]
        for dk in np.unique(dks):
            sel = i_all[dks == dk]
            j = sel - k
            eu = np.zeros(ne_pad); eu[j] = Ksm[sel, j]
            ed = np.zeros(ne_pad); ed[sel] = Ksm[sel, j]
            au = np.zeros(ne_pad); au[j] = Ksm[j, sel]
            ad = np.zeros(ne_pad); ad[sel] = Ksm[j, sel]
            scat_cols.append((k, int(dk)))
            cols_eu.append(eu); cols_ed.append(ed)
            cols_au.append(au); cols_ad.append(ad)
    pack = lambda cols: np.stack(cols, axis=1)
    return scat_cols, (pack(cols_eu), pack(cols_ed), pack(cols_au), pack(cols_ad))


def _recombination_columns(K_r0: np.ndarray, idx_sum: np.ndarray, ne: int, ne_pad: int):
    """One column per (anti-diagonal s, ω row): ``(cols, R)``, R (ne_pad, len(cols))."""
    Krm = np.asarray(K_r0, dtype=np.float64)
    ns = 2 * ne - 1
    rec_cols: list[tuple[int, int]] = []  # (anti-diagonal s, ω row)
    cols_r = []
    for srow in range(ns):
        i_lo = max(0, srow - ne + 1)
        i_hi = min(ne, srow + 1)
        i_all = np.arange(i_lo, i_hi)
        mss = idx_sum[i_all, srow - i_all]
        for ms in np.unique(mss):
            sel = i_all[mss == ms]
            rc = np.zeros(ne_pad); rc[sel] = Krm[sel, srow - sel]
            rec_cols.append((srow, int(ms)))
            cols_r.append(rc)
    return rec_cols, np.stack(cols_r, axis=1)


#: K9's plain version: the column walk of K8's (one function for both forms)
collision_step_rows_plain = collision_step_loop_plain


def columns(K_s0, K_r0, idx_diff, idx_sum, ne: int):
    """K9's grouping of per-gap stacks ``K_s0``/``K_r0`` (G, NE, NE), either
    None when its channel is off: ``(scat_k, scat_row, scat, rec_s, rec_row,
    rec)`` with ``scat`` the four (G, NE, Cs) tables of
    :func:`_scattering_columns` and ``rec`` (G, NE, Cr), unscaled.  The
    grouping depends only on the ω maps, so every gap has the same columns."""
    idx_diff, idx_sum = np.asarray(idx_diff), np.asarray(idx_sum)
    empty = np.zeros(0, np.int64)
    scat_k = scat_row = rec_s = rec_row = empty
    scat = rec = None
    if K_s0 is not None:
        per_gap = [_scattering_columns(K, idx_diff, ne, ne) for K in np.asarray(K_s0, np.float64)]
        cols = per_gap[0][0]
        scat_k, scat_row = (np.asarray([c[i] for c in cols], np.int64) for i in (0, 1))
        scat = tuple(np.stack([tabs[i] for _, tabs in per_gap]) for i in range(4))
    if K_r0 is not None:
        per_gap = [_recombination_columns(K, idx_sum, ne, ne) for K in np.asarray(K_r0, np.float64)]
        cols = per_gap[0][0]
        rec_s, rec_row = (np.asarray([c[i] for c in cols], np.int64) for i in (0, 1))
        rec = np.stack([r_tab for _, r_tab in per_gap])
    return scat_k, scat_row, scat, rec_s, rec_row, rec


def rows_walk(*, E_bins, dE, rho, K_s0, K_r0, pmap: PhononFrequencyMap, dt,
              update_phonons=True) -> OffsetWalk:
    """K9's column form at any NE ≥ 2 on a uniform grid (no bin cap)."""
    e = np.asarray(E_bins, dtype=np.float64)
    ne = int(e.size)
    stack = lambda K: None if K is None else np.asarray(K, dtype=np.float64)[None]
    scat_k, scat_row, scat, rec_s, rec_row, rec = columns(
        stack(K_s0), stack(K_r0), pmap.idx_diff, pmap.idx_sum, ne)
    return OffsetWalk(
        num_energy_bins=ne, num_omega=pmap.num_omega, dt=float(dt),
        update_phonons=bool(update_phonons), rho=np.asarray(rho, dtype=np.float64)[None],
        scat_k=scat_k, scat_row=scat_row,
        scat=None if scat is None else tuple(float(dE) * t for t in scat),
        rec_s=rec_s, rec_row=rec_row, rec=None if rec is None else (2.0 * float(dE)) * rec,
        gap_id=None,
    )


def build_collision_step_rows(
    *,
    E_bins: np.ndarray,
    dE: float,
    rho: np.ndarray,
    K_s0: np.ndarray | None,
    K_r0: np.ndarray | None,
    pmap: PhononFrequencyMap,
    dt: float,
    update_phonons: bool = True,
    device="cuda",
):
    """K9: ``step(n_qp, n_ph)`` for one collision substep, or ``None``.

    The contract of ``build_pallas_collision_step_rows``: ``None`` for NE < 2,
    NE > :data:`MAX_ROWS_BINS`, a per-gap (2-D) ``rho`` or a non-uniform
    grid; the identity with neither channel on; exact on split ω diagonals.
    Launches count as ``collision_step_rows``.
    """
    e = np.asarray(E_bins, dtype=np.float64)
    ne = int(e.size)
    if ne < 2 or ne > MAX_ROWS_BINS or np.asarray(rho, dtype=np.float64).ndim != 1:
        return None
    if not _grid_uniform(e):
        return None
    if K_s0 is None and K_r0 is None:
        return _identity
    walk = rows_walk(E_bins=e, dE=dE, rho=rho, K_s0=K_s0, K_r0=K_r0, pmap=pmap, dt=dt,
                     update_phonons=update_phonons)
    return WalkStep(walk, device, "collision_step_rows")
