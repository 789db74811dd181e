"""The column walk's device tables and launch: ``csrc/offset_walk.cu``, shared by K5, K6, K8 and K9.

The collision substep in column form (see
:mod:`qpsim_tpu_torch.ops.collisions_loop_cuda` for the columns): a
scattering column has an offset k ≥ 1, an ω row and, for every bin m ≥ k
whose pair (m, m − k) lies in the column's group, (K[m, m−k], K[m−k, m])·dE;
a recombination column an anti-diagonal s, an ω row and 2dE·K^r₀[i, s−i].
K8 groups by offset and anti-diagonal
(:mod:`~qpsim_tpu_torch.ops.collisions_loop_cuda`), K9, K5 and K6 by
(offset, ω row) and (anti-diagonal, ω row)
(:func:`~qpsim_tpu_torch.ops.collisions_rows_cuda.columns`).  This module
moves such host tables to the device (:func:`column_tables`), with the
dense copies and index arrays of the kernel's register-blocked walk, picks
the launch's form (:func:`column_form`: the tile's q and partner staged in
shared memory, or past what a block's shared memory holds — 908 bins in
float32, 454 in float64 — in a scratch buffer in device memory), pixels
per lane (:func:`column_pixels`) and bins per register block
(:func:`column_bins`), and launches the kernel (:func:`launch_column_walk`).
Every launch takes the register-blocked walk: the kernel has no other.
Gap ids are read as int32.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..utils.cuda_build import load_kernels, refuse_grad
from .collisions import AnalyticTables

__all__ = [
    "LAUNCHES",
    "MAX_SHARED_BYTES",
    "ColumnTables",
    "blocks_per_sm",
    "column_bins",
    "column_form",
    "column_pixels",
    "column_tables",
    "launch_column_walk",
    "row_lists",
]

#: dynamic shared memory a block may opt into on the H100 (227 KB); the
#: staged form's q and partner of a tile must fit it: NE ≤ 908 in float32,
#: 454 in float64 at one pixel per lane
MAX_SHARED_BYTES = 232_448

#: launches of the column walk's device-memory form since import (or since
#: the caller reset it), whichever wrapper launched it; each is also counted
#: under its wrapper's own name
LAUNCHES = {"column_walk_device": 0}

#: the dense tables' bin and anti-diagonal strides are multiples of this,
#: the widest register block (so every block's entries are aligned vector loads)
BIN_ALIGN = 8


def row_lists(num_omega: int, scat_row: np.ndarray | None, rec_row: np.ndarray | None):
    """(row_ptr, row_code): each ω row's columns, code = column·2 + kind
    (0 scattering, 1 recombination; a channel is off when its rows are
    None), in column order within a row."""
    rows = [np.zeros(0, np.int64)]
    codes = [np.zeros(0, np.int64)]
    if scat_row is not None:
        rows.append(np.asarray(scat_row, np.int64))
        codes.append(np.arange(len(scat_row), dtype=np.int64) * 2)
    if rec_row is not None:
        rows.append(np.asarray(rec_row, np.int64))
        codes.append(np.arange(len(rec_row), dtype=np.int64) * 2 + 1)
    row, code = np.concatenate(rows), np.concatenate(codes)
    order = np.argsort(row, kind="stable")
    row_ptr = np.zeros(num_omega + 1, dtype=np.int32)
    row_ptr[1:] = np.cumsum(np.bincount(row, minlength=num_omega))
    return row_ptr, code[order].astype(np.int32)


@dataclass
class ColumnTables:
    """The column walk's device tables, in the state dtype (``csrc/offset_walk.cu``).

    Table form (K5, K8, K9): ``rho`` (G, NE), ``scat`` (G, NE, Cs, 2) =
    (e_dn, a_dn), ``rec`` (G, NE, Cr), ``gid`` the (Ny·Nx,) int32 gap ids
    (None on a uniform gap).  Analytic form (K6): ``analytic`` gives Δ²
    and the Dynes constants, ``scat`` is (NE, Cs, 4) = (a, a', b, b') with
    e_dn = relu(a − b·Δ²), a_dn = relu(a' − b'·Δ²), ``rec`` (NE, Cr, 2) =
    (a_r, b_r) with R = a_r + b_r·Δ².  ``scat_t``/``rec_t`` are the same
    tables with the bin and column axes swapped, which the kernel's phonon
    side walks per ω row.  ``row_ptr``/``row_code`` list each ω row's
    columns, ``touched`` marks the rows some column lands on.

    The register-blocked walk reads each offset's and anti-diagonal's
    first column from dense copies, the same entries (G first in the table
    form, absent in the analytic form; bins padded with zeros to
    ``ne_pad``, anti-diagonals to ``s_pad``, multiples of
    :data:`BIN_ALIGN`): ``qs`` (NE, ne_pad) at [j][i] the pair of bins i ≠
    j (``scat`` at bin max(i, j), offset |i − j|), ``qr`` (NE, ne_pad) at
    [j][i] ``rec`` at bin i of anti-diagonal i + j, ``ps`` (NE, ne_pad) at
    [m][k − 1] ``scat`` at bin m of offset k, ``pr`` (NE, s_pad) at [i][s]
    ``rec`` at bin i of anti-diagonal s.  ``k_row``/``s_row`` give those
    columns' ω rows (a valid row too where no such column is, offset 0
    among them, and :data:`BIN_ALIGN` past the end), ``k_out``/``s_out``
    the row where the column alone lands on it (else −1), ``x_scat`` and
    ``x_rec`` the columns beyond the first (walked bin by bin) and
    ``slow_rows`` the ω rows summed column by column (several columns, or
    none).
    """

    num_energy_bins: int
    num_omega: int
    rho: torch.Tensor | None
    scat: torch.Tensor | None
    rec: torch.Tensor | None
    scat_t: torch.Tensor | None
    rec_t: torch.Tensor | None
    scat_k: torch.Tensor  # int32
    scat_row: torch.Tensor
    rec_s: torch.Tensor
    rec_row: torch.Tensor
    row_ptr: torch.Tensor
    row_code: torch.Tensor
    touched: torch.Tensor  # (NW,) bool
    gid: torch.Tensor | None
    qs: torch.Tensor | None
    qr: torch.Tensor | None
    ps: torch.Tensor | None
    pr: torch.Tensor | None
    ne_pad: int
    s_pad: int
    k_row: torch.Tensor  # int32
    k_out: torch.Tensor
    s_row: torch.Tensor
    s_out: torch.Tensor
    x_scat: torch.Tensor
    x_rec: torch.Tensor
    slow_rows: torch.Tensor
    analytic: AnalyticTables | None = None

    @property
    def n_scat(self) -> int:
        return 0 if self.scat is None else int(self.scat_k.numel())

    @property
    def n_rec(self) -> int:
        return 0 if self.rec is None else int(self.rec_s.numel())

    def kernel_tensors(self) -> list:
        """Every table the kernel reads (for byte counts), the copies apart
        (``scat_t``/``rec_t`` and the blocked walk's dense ``qs``, ``qr``,
        ``ps``, ``pr``): they repeat ``scat``/``rec``."""
        a = self.analytic
        extra = () if a is None else (a.g2, a.E, a.inv_E, a.e2, a.zi)
        return [t for t in (self.rho, self.scat, self.rec, self.scat_k, self.scat_row, self.rec_s,
                            self.rec_row, self.row_ptr, self.row_code, self.gid, *extra)
                if t is not None]


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _firsts(keys: np.ndarray, n: int):
    """(first, is_first): the first column of each key 0 … n − 1 in ``keys``
    (ascending; −1 where a key has none) and which columns are firsts."""
    first = np.full(n, -1, np.int64)
    is_first = np.r_[True, np.diff(keys) > 0] if keys.size else np.zeros(0, bool)
    first[keys[is_first]] = np.flatnonzero(is_first)
    return first, is_first


def blocked_tables(ne: int, row_ptr: np.ndarray, row_code: np.ndarray, scat_k, scat_row, scat_d,
                   rec_s, rec_row, rec_d, lead: int):
    """The blocked walk's host tables from the [bin][column] tables ``scat_d``
    (…, NE, Cs, w) and ``rec_d`` (…, NE, Cr[, w]), either None when its
    channel is off, with ``lead`` leading axes (1 for a gap axis, 0 in the
    analytic form): a dict of :class:`ColumnTables`' blocked fields in
    float64 / int64 (see there)."""
    ne_pad, s_pad = _round_up(ne, BIN_ALIGN), _round_up(2 * ne - 1, BIN_ALIGN)
    nw = len(row_ptr) - 1
    out = dict(qs=None, qr=None, ps=None, pr=None, ne_pad=ne_pad, s_pad=s_pad)
    owner = np.full(nw, -1, np.int64)  # rows one first column alone lands on: that column's code
    counts = np.diff(row_ptr)
    single = counts == 1
    owner[single] = row_code[row_ptr[:-1][single]]
    i, j = np.meshgrid(np.arange(ne), np.arange(ne), indexing="xy")  # [j][i]
    lead_ix = (slice(None),) * lead
    k_row = k_out = s_row = s_out = np.full(0, -1, np.int64)
    x_scat = x_rec = np.zeros(0, np.int64)
    written = np.zeros(nw, bool)
    if scat_d is not None:
        first, is_first = _firsts(np.asarray(scat_k, np.int64), ne)
        k_row = np.asarray(scat_row, np.int64)[np.maximum(first, 0)]
        k_out = np.where((first >= 0) & (owner[k_row] == 2 * first), k_row, -1)
        x_scat = np.flatnonzero(~is_first)
        k = np.abs(i - j)
        col = np.where(k > 0, first[k], -1)
        tail = scat_d.shape[lead + 2:]
        qs = np.zeros(scat_d.shape[:lead] + (ne, ne_pad) + tail)
        ok = col >= 0
        qs[lead_ix + (j[ok], i[ok])] = scat_d[lead_ix + (np.maximum(i, j)[ok], col[ok])]
        ps = np.zeros_like(qs)
        have = np.flatnonzero(first[1:] >= 0) + 1  # offsets with a column
        ps[lead_ix + (slice(None), have - 1)] = scat_d[lead_ix + (slice(None), first[have])]
        out.update(qs=qs, ps=ps)
        written[k_out[k_out >= 0]] = True
    if rec_d is not None:
        first, is_first = _firsts(np.asarray(rec_s, np.int64), 2 * ne - 1)
        s_row = np.asarray(rec_row, np.int64)[np.maximum(first, 0)]
        s_out = np.where((first >= 0) & (owner[s_row] == 2 * first + 1), s_row, -1)
        x_rec = np.flatnonzero(~is_first)
        tail = rec_d.shape[lead + 2:]
        col = first[i + j]
        qr = np.zeros(rec_d.shape[:lead] + (ne, ne_pad) + tail)
        ok = col >= 0
        qr[lead_ix + (j[ok], i[ok])] = rec_d[lead_ix + (i[ok], col[ok])]
        pr = np.zeros(rec_d.shape[:lead] + (ne, s_pad) + tail)
        have = np.flatnonzero(first >= 0)
        pr[lead_ix + (slice(None), have)] = rec_d[lead_ix + (slice(None), first[have])]
        out.update(qr=qr, pr=pr)
        written[s_out[s_out >= 0]] = True
    # the windows' loads read valid rows past the last offset and anti-diagonal
    # too (their tables are zero there): the last row repeated
    pad = lambda rows: np.concatenate([rows, np.repeat(rows[-1:], BIN_ALIGN)]) if rows.size else rows
    out.update(k_row=pad(k_row), k_out=k_out, s_row=pad(s_row), s_out=s_out, x_scat=x_scat,
               x_rec=x_rec, slow_rows=np.flatnonzero(~written))
    return out


def column_tables(*, num_energy_bins: int, num_omega: int, scat_k, scat_row, scat, rec_s, rec_row,
                  rec, device, dtype: torch.dtype, rho=None, gap_id=None, scat_b=None, rec_b=None,
                  analytic: AnalyticTables | None = None) -> ColumnTables:
    """:class:`ColumnTables` from host tables in float64.

    ``scat`` is the four (G, NE, Cs) tables (e_up, e_dn, a_up, a_dn) and
    ``rec`` (G, NE, Cr), each None when its channel is off; with
    ``analytic`` they are the Δ²-free parts (G = 1) and ``scat_b``/``rec_b``
    the Δ² slopes.  ``gap_id`` (an array or tensor of Ny·Nx ids, None on a
    uniform gap) is copied to the device as int32.  Columns must be sorted
    by offset and by anti-diagonal.
    """
    ne = int(num_energy_bins)
    as_dev = lambda a: None if a is None else torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                                              device=device)
    ints = lambda a: torch.as_tensor(np.ascontiguousarray(a, dtype=np.int32), device=device)
    scat_k = np.asarray(scat_k, np.int64)
    rec_s = np.asarray(rec_s, np.int64)
    if np.any(np.diff(scat_k) < 0) or np.any(np.diff(rec_s) < 0):
        raise ValueError("columns must be sorted by offset and by anti-diagonal")
    if analytic is None:  # (G, NE, C, 2), (G, NE, C); bins and columns swapped: axes 1, 2
        scat_d = None if scat is None else np.stack([scat[1], scat[3]], axis=-1)
        rec_d = rec
        swap = lambda a: None if a is None else np.swapaxes(a, 1, 2)
    else:  # (NE, C, 4), (NE, C, 2): axes 0, 1
        scat_d = None if scat is None else np.stack([scat[1][0], scat[3][0], scat_b[1][0],
                                                     scat_b[3][0]], axis=-1)
        rec_d = None if rec is None else np.stack([rec[0], rec_b[0]], axis=-1)
        swap = lambda a: None if a is None else np.swapaxes(a, 0, 1)
    row_ptr, row_code = row_lists(num_omega, None if scat is None else scat_row,
                                  None if rec is None else rec_row)
    blocked = blocked_tables(ne, row_ptr, row_code, scat_k, scat_row, scat_d, rec_s, rec_row, rec_d,
                             lead=int(analytic is None))
    gid = None
    if gap_id is not None:
        gid = torch.as_tensor(gap_id, device=device).reshape(-1).to(torch.int32).contiguous()
    return ColumnTables(
        num_energy_bins=ne, num_omega=int(num_omega),
        rho=as_dev(rho), scat=as_dev(scat_d), rec=as_dev(rec_d),
        scat_t=as_dev(swap(scat_d)), rec_t=as_dev(swap(rec_d)),
        scat_k=ints(scat_k), scat_row=ints(scat_row), rec_s=ints(rec_s), rec_row=ints(rec_row),
        row_ptr=ints(row_ptr), row_code=ints(row_code),
        touched=torch.as_tensor(np.diff(row_ptr) > 0, device=device),
        gid=gid, analytic=analytic,
        **{k: as_dev(blocked[k]) for k in ("qs", "qr", "ps", "pr")},
        ne_pad=blocked["ne_pad"], s_pad=blocked["s_pad"],
        **{k: ints(blocked[k]) for k in ("k_row", "k_out", "s_row", "s_out", "x_scat", "x_rec",
                                         "slow_rows")},
    )


def blocks_per_sm(smem: int) -> int:
    """Blocks of 256 threads an H100 SM holds by shared memory (228 KB, 1 KB
    reserved per block) and threads (2048)."""
    return min(8, 233_472 // (smem + 1024))


def column_form(dtype: torch.dtype, ne: int) -> str:
    """The column walk's launch form at NE bins: "staged" while q and partner
    of a 32-pixel tile (2·NE·32 entries) fit a block's shared memory
    (:data:`MAX_SHARED_BYTES`), else "device", which keeps them in a
    scratch buffer in device memory."""
    size = 4 if dtype == torch.float32 else 8
    return "staged" if 2 * ne * 32 * size <= MAX_SHARED_BYTES else "device"


def column_pixels(dtype: torch.dtype, ne: int, n_pix: int, uniform: bool = True) -> int:
    """Pixels per lane of the column walk's launch, the rule measured with
    ``tools/column_walk_levers.py`` (PERF.md §6): 2 in float32 while the
    tile (q and partner of 64 pixels) leaves 4 blocks per SM and the pixel
    count is even, on a uniform gap (one table base for every warp, no Δ²
    plane; ``uniform``) or at up to 16 bins (an ensemble's member ids),
    else 1 (the device-memory form launches at 1 whatever this says)."""
    if (dtype == torch.float32 and (uniform or ne <= 16) and n_pix % 2 == 0
            and blocks_per_sm(2 * ne * 64 * 4) >= 4):
        return 2
    return 1


def column_bins(dtype: torch.dtype, ne: int, pixels: int, form: str) -> int:
    """Bins per register block of the column walk's launch, the rule measured
    with ``tools/column_walk_levers.py`` (PERF.md §6): 8 in float32 at one
    pixel per lane where the staged tile leaves at most 3 blocks per SM by
    shared memory (the 8-bin block's 80 registers a thread cost no blocks
    there), else 4 (float64's 8-bin block spills)."""
    if dtype == torch.float32 and pixels == 1 and form == "staged" and (
            blocks_per_sm(2 * ne * 32 * 4) <= 3):
        return 8
    return 4


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def launch_column_walk(tables: ColumnTables, n_qp: torch.Tensor, n_ph: torch.Tensor, dt: float,
                       gen: torch.Tensor | None, update_phonons: bool,
                       form: str | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/offset_walk.cu`` on CUDA tensors (inputs checked by the
    caller) and return (q_out, ph_out), in :func:`column_form`'s form (or
    ``form``, "staged" or "device", to hold one against the other; a staged
    tile that does not fit raises) at :func:`column_pixels` pixels per lane
    and :func:`column_bins` bins per register block.  Counting under the
    wrapper's name is the caller's; a device-memory launch also counts in
    :data:`LAUNCHES`."""
    refuse_grad("the column walk kernel (csrc/offset_walk.cu)",
                "ops.collisions.collision_step_plain or ops.collisions_loop_cuda.collision_step_loop_plain",
                n_qp, n_ph, gen)
    if n_qp.device.type != "cuda":
        raise ValueError(f"column walk kernel runs on CUDA tensors, got {n_qp.device}")
    if n_qp.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"column walk kernel takes float32 or float64, got {n_qp.dtype}")
    ne = tables.num_energy_bins
    n_scat, n_rec = tables.n_scat, tables.n_rec
    for name, t in (("scat", tables.scat), ("rec", tables.rec), ("rho", tables.rho),
                    ("qs", tables.qs), ("qr", tables.qr), ("ps", tables.ps), ("pr", tables.pr)):
        if t is not None and (t.device != n_qp.device or t.dtype != n_qp.dtype):
            raise ValueError(f"table {name} is {t.dtype} on {t.device}, the state {n_qp.dtype} "
                             f"on {n_qp.device}")
    n_pix = n_qp.shape[1] * n_qp.shape[2]
    gid = tables.gid
    if gid is not None and (gid.device != n_qp.device or gid.numel() != n_pix
                            or gid.dtype != torch.int32 or not gid.is_contiguous()):
        raise ValueError(f"gap ids must be {n_pix} contiguous int32 entries on {n_qp.device}")
    form = column_form(n_qp.dtype, ne) if form is None else form
    if form not in ("staged", "device"):
        raise ValueError(f"column walk form must be 'staged' or 'device', got {form!r}")
    device_form = form == "device"
    pixels = column_pixels(n_qp.dtype, ne, n_pix, uniform=gid is None and tables.analytic is None)
    if device_form or n_ph.data_ptr() % (2 * n_ph.element_size()):
        pixels = 1  # a pair of column values is one load: pair-aligned rows only
    bins = column_bins(n_qp.dtype, ne, pixels, form)
    # the device-memory form's tiles: q and partner of 32 pixels per block
    scratch = (torch.empty(-(-n_pix // 32) * 2 * ne * 32, dtype=n_qp.dtype, device=n_qp.device)
               if device_form else None)
    lib = load_kernels()
    fn = lib.qp_column_walk_f32 if n_qp.dtype == torch.float32 else lib.qp_column_walk_f64
    q_out = torch.empty_like(n_qp)
    ph_out = torch.empty_like(n_ph) if update_phonons else n_ph
    a = tables.analytic
    t = tables
    err = fn(
        _ptr(n_qp), _ptr(n_ph), _ptr(gen), _ptr(q_out), _ptr(ph_out) if update_phonons else None,
        _ptr(gid), _ptr(t.rho), _ptr(t.scat), _ptr(t.scat_t), _ptr(t.rec), _ptr(t.rec_t),
        _ptr(t.qs), _ptr(t.qr), _ptr(t.ps), _ptr(t.pr), t.ne_pad, t.s_pad,
        *((None,) * 5 if a is None else map(_ptr, (a.g2, a.E, a.inv_E, a.e2, a.zi))),
        0.0 if a is None else float(a.gamma),
        _ptr(t.scat_k), _ptr(t.scat_row), n_scat, _ptr(t.rec_s), _ptr(t.rec_row), n_rec,
        _ptr(t.row_ptr), _ptr(t.row_code), _ptr(t.k_row), _ptr(t.k_out), _ptr(t.s_row),
        _ptr(t.s_out), _ptr(t.x_scat), int(t.x_scat.numel()), _ptr(t.x_rec), int(t.x_rec.numel()),
        _ptr(t.slow_rows), int(t.slow_rows.numel()),
        ne, n_pix, float(dt), int(update_phonons), int(pixels), int(bins), _ptr(scratch),
        torch.cuda.current_stream(n_qp.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"column walk kernel launch ({form} form, P={pixels}, B={bins}) failed "
                           f"with CUDA error {err}")
    LAUNCHES["column_walk_device"] += device_form
    return q_out, ph_out
