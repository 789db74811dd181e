"""The collision substep on the card: wrappers of the CUDA kernel ``csrc/collisions.cu``.

Port of ``qpsim_tpu.ops.pallas_collisions``:

* :func:`collision_step` — ``build_pallas_collision_step`` (kernel
  ``_make_kernel``, K3), for a uniform gap and for piecewise gap maps of at
  most :data:`MAX_GAP_IDS` unique gaps (per-pixel gap ids);
* :func:`collision_step_analytic` — ``build_pallas_collision_step_analytic``
  (kernel ``_make_analytic_kernel``, K4), for continuous gap maps;
* :func:`build_collision_step`, :func:`build_collision_step_analytic` —
  those two builders' form: the plan and the tables built once from host
  arrays, ``step(n_qp, n_ph[, gen])`` returned.

Each takes the arguments of its plain version
(:func:`qpsim_tpu_torch.ops.collisions.collision_step_plain`,
:func:`~qpsim_tpu_torch.ops.collisions.collision_step_analytic_plain`) plus
the kernel's tables.  For tensors on the CPU it runs that plain version;
for CUDA tensors it launches the kernel or raises — it never falls back.

The kernel walks each unordered pair once, diagonal-major: scattering pairs
(j + k, j) along the diagonals k, recombination pairs (s − j, j) along the
anti-diagonals s.  :func:`pair_walk` cuts each diagonal into groups, one
per ω row its pairs land on (a split ω diagonal is two groups);
:func:`build_kernel_tables` puts on the card the groups and their
constants, pair by pair in the walk's order — (dE·K^s₀[i, j],
dE·K^s₀[j, i]) and (2dE·K^r₀[i, j], 2dE·K^r₀[j, i]) per gap, or for the
analytic form the (a, b) pairs whose constants are affine in Δ² — packed
for the kernel's constant bank.  Up to 16 bins the walk holds a pixel's
bins in registers and covers 16 of them (:data:`WALK_BINS`; pairs past
NE carry zeros).  More bins, or constants too many for the bank, run the
column walk of K5 and K6 (``csrc/offset_walk.cu``), launched and counted
under the same names.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from ..utils.cuda_build import load_kernels, refuse_grad
from .collisions import (
    AnalyticTables,
    CollisionPlan,
    _device_dtype,
    build_analytic_plan,
    build_collision_plan_arrays,
    collision_step_analytic_plain,
    collision_step_plain,
)
from .column_walk import ColumnTables, launch_column_walk

__all__ = [
    "LAUNCHES",
    "MAX_GAP_IDS",
    "MAX_KERNEL_BINS",
    "WALK_BINS",
    "CollisionKernelTables",
    "PairWalk",
    "build_collision_step",
    "build_collision_step_analytic",
    "build_kernel_tables",
    "collision_step",
    "collision_step_analytic",
    "collision_step_analytic_plain",
    "collision_step_plain",
    "check_inputs",
    "count_launch",
    "launch_columns",
    "pair_walk",
    "walk_bins",
]

#: launches of each collision kernel since import (or since the caller reset
#: it), and how many of them took a generation plane: ``collision_step`` is
#: K3 on a uniform gap, ``collision_step_gid`` K3 with per-pixel gap ids,
#: ``collision_step_analytic`` K4; ``collision_step_blocked[_gid]`` is K5
#: and ``collision_step_blocked_analytic`` K6 (``ops.collisions_blocked_cuda``);
#: ``collision_step_loop[_gid]`` is K8 and ``collision_step_rows`` K9, the
#: offset walks (``ops.collisions_loop_cuda``, ``ops.collisions_rows_cuda``),
#: which take no generation plane
LAUNCHES = {
    f"{name}{form}{gen}": 0
    for name in ("collision_step", "collision_step_blocked")
    for form in ("", "_gid", "_analytic")
    for gen in ("", "_with_gen")
} | {"collision_step_loop": 0, "collision_step_loop_gid": 0, "collision_step_rows": 0}

#: energy bins K3 and K4 take (beyond WALK_BINS on the column walk)
MAX_KERNEL_BINS = 64

#: the bins the kernel holds in registers (kBins in the source): the walk
#: covers 16, bins past NE padded; more bins run the column walk of K5 and K6
WALK_BINS = 16

#: unique gaps K3's gap-id tables take (the JAX package's table-blend bound);
#: more distinct gaps go to K4
MAX_GAP_IDS = 8

#: the kernel's constant bank (kConstBytes in the source); a launch whose
#: constants exceed it runs the column walk
CONST_BANK_BYTES = 48 * 1024


def walk_bins(ne: int) -> int | None:
    """The bins the kernel's walk covers at NE bins: :data:`WALK_BINS`, or
    None beyond them (the column walk)."""
    return WALK_BINS if ne <= WALK_BINS else None


@dataclass
class PairWalk:
    """The kernel's walk on the host: its groups, in the kernel's order.

    Scattering groups of diagonal k are ``s_meta[s_ptr[k]:s_ptr[k + 1]]``,
    recombination groups of anti-diagonal s ``r_meta[r_ptr[s]:r_ptr[s + 1]]``;
    each meta row is (ω row, first entry).  A group's entries are the pairs
    of its diagonal in ``nb`` bins — (j + k, j) for j = 0 … nb − 1 − k,
    (s − j, j) for j = max(0, s − nb + 1) … ⌊s/2⌋ — and ``s_pairs`` /
    ``r_pairs`` give each entry's (i, j), or (−1, −1) where the pair lies
    past NE or on another group's row.  The kernel adds each group's sums
    into its row, so a row several groups reach (a difference and a sum on
    one ω) gathers them all and a row none reaches keeps zero rates.
    """

    nb: int
    s_ptr: np.ndarray  # (nb + 1,) int32
    r_ptr: np.ndarray  # (2nb,) int32
    s_meta: np.ndarray  # (scattering groups, 2) int32
    r_meta: np.ndarray  # (recombination groups, 2) int32
    s_pairs: np.ndarray  # (scattering entries, 2) int64
    r_pairs: np.ndarray  # (recombination entries, 2) int64


def _cut(rows: np.ndarray) -> list:
    """The distinct ω rows of a diagonal's pairs, in the order they first appear."""
    _, first = np.unique(rows, return_index=True)
    return [int(rows[f]) for f in np.sort(first)]


def pair_walk(plan: CollisionPlan, bins: int) -> PairWalk:
    """The groups of the kernel's walk for ``plan`` over ``bins`` ≥ NE bins (numpy).

    Raises where the kernel's unordered walk does not apply: ω maps that
    are not symmetric in (i, j), or energy bins that do not ascend.
    """
    ne, nw = plan.num_energy_bins, plan.num_omega
    nb = int(bins)
    if nb < ne:
        raise ValueError(f"a walk over {nb} bins cannot hold {ne}")
    idd, ids, sgn = plan.idx_diff_np, plan.idx_sum_np, plan.diff_sign_np
    if not (np.array_equal(idd, idd.T) and np.array_equal(ids, ids.T)):
        raise ValueError("the collision kernel walks unordered pairs: idx_diff and idx_sum "
                         "must be symmetric")
    lo = np.tril_indices(ne, -1)
    if plan.enable_scattering and not (np.all(sgn[lo] > 0) and np.all(sgn.T[lo] < 0)):
        raise ValueError("the collision kernel takes ascending energy bins")
    kinds = []
    for kind, on, n_diag in (("s", plan.enable_scattering, nb), ("r", plan.enable_recombination,
                                                               2 * nb - 1)):
        counts = np.zeros(n_diag, dtype=np.int64)
        groups, pairs = [], []
        for d in range(n_diag if on else 0):
            if kind == "s":  # diagonal k = d: pairs (j + d, j)
                j = np.arange(nb - d)
            else:  # anti-diagonal s = d: pairs (d − j, j), j ≤ d − j
                j = np.arange(max(0, d - nb + 1), d // 2 + 1)
            i = j + d if kind == "s" else d - j
            real = (i < ne) & (i != j) if kind == "s" else i < ne
            if not real.any():
                continue
            rows = np.where(real, (idd if kind == "s" else ids)[np.minimum(i, ne - 1), np.minimum(j, ne - 1)], -1)
            for row in _cut(rows[real]):
                member = rows == row
                groups.append((row, sum(len(p) for p in pairs)))
                pairs.append(np.where(member[:, None], np.stack([i, j], 1), -1))
                counts[d] += 1
        ptr = np.zeros(n_diag + 1, dtype=np.int32)
        ptr[1:] = np.cumsum(counts)
        kinds.append((ptr, np.array(groups, dtype=np.int32).reshape(-1, 2),
                      np.concatenate(pairs) if pairs else np.zeros((0, 2), np.int64)))
    (s_ptr, s_meta, s_pairs), (r_ptr, r_meta, r_pairs) = kinds
    return PairWalk(nb=nb, s_ptr=s_ptr, r_ptr=r_ptr, s_meta=s_meta, r_meta=r_meta,
                    s_pairs=s_pairs, r_pairs=r_pairs)


@dataclass
class CollisionKernelTables:
    """The walk's groups and constants on the card (:func:`build_kernel_tables`).

    ``consts`` is what the kernel copies into its constant bank before each
    launch: per gap [ρ (nb) | (K[i,j], K[j,i]) per scattering entry |
    (R[i,j], R[j,i]) per recombination entry], or on an analytic plan [E,
    1/E, E² − γ², −2Eγ (nb each) | (a_s[i,j], b_s[i,j], a_s[j,i],
    b_s[j,i]) per scattering entry | the same of 2dE·K^r₀ per
    recombination entry]; None on an analytic plan built without its
    :class:`AnalyticTables`.
    """

    nb: int  # the walk's bins (PairWalk.nb)
    analytic: bool
    consts: torch.Tensor | None  # (G, per gap) or (per launch,), state dtype
    n_scat: int  # scattering entries (per gap)
    n_rec: int
    scat_off: int  # where the entries' constants start within a gap
    rec_off: int
    s_ptr: torch.Tensor  # int32, as in PairWalk
    r_ptr: torch.Tensor
    s_meta: torch.Tensor
    r_meta: torch.Tensor
    rows: torch.Tensor  # int32: each group's ω row, the scattering groups' first
    #: the kernel's simple form: NE = WALK_BINS, both channels, one group per
    #: diagonal and no ω row that two groups reach (each group then sets its
    #: row's rates); elsewhere the general form, which adds them
    simple: bool = False

    @property
    def width(self) -> int:
        """Constants per entry: 2, or 4 on an analytic plan."""
        return 4 if self.analytic else 2

    def _part(self, off: int, n: int):
        if self.consts is None or n == 0:
            return None
        return self.consts[..., off: off + self.width * n].unflatten(-1, (n, self.width))

    @property
    def scat(self) -> torch.Tensor | None:
        """(…, n_scat, width): each scattering entry's constants."""
        return self._part(self.scat_off, self.n_scat)

    @property
    def rec(self) -> torch.Tensor | None:
        return self._part(self.rec_off, self.n_rec)

    @property
    def rho(self) -> torch.Tensor | None:
        """(G, nb): each gap's ρ, zero past NE (table form)."""
        return None if self.analytic or self.consts is None else self.consts[:, : self.nb]

    def kernel_tensors(self) -> list:
        """Every table the kernel reads (for byte counts), gap ids and Δ² apart."""
        return [t for t in (self.consts, self.s_ptr, self.r_ptr, self.s_meta, self.r_meta,
                            self.rows) if t is not None]


def _entries(pairs: np.ndarray, a: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
    """(…, entries, 2 or 4): (a[i,j], a[j,i]) of each entry's pair, or
    (a[i,j], b[i,j], a[j,i], b[j,i]); zero where the entry holds no pair."""
    dev = a.device
    i, j = (torch.as_tensor(np.maximum(pairs[:, c], 0), device=dev) for c in (0, 1))
    keep = torch.as_tensor(pairs[:, 0] >= 0, device=dev)
    cols = [a[..., i, j], a[..., j, i]] if b is None else [a[..., i, j], b[..., i, j],
                                                           a[..., j, i], b[..., j, i]]
    zero = torch.zeros((), dtype=a.dtype, device=dev)
    return torch.stack([torch.where(keep, c, zero) for c in cols], -1).contiguous()


def build_kernel_tables(plan: CollisionPlan, analytic: AnalyticTables | None = None
                        ) -> CollisionKernelTables | ColumnTables:
    """The kernel's device tables for ``plan`` (on the plan's device and dtype).

    Up to :data:`WALK_BINS` bins the pair walk's groups and constants — the
    plain version's, bit for bit: dE·K^s₀ and 2dE·K^r₀ formed as
    ``collision_step_plain`` forms them, or ``analytic``'s (a, b) tables.
    An analytic plan built without ``analytic`` gets the groups only
    (:func:`collision_step_analytic` refuses those on the card).  Beyond
    them, or where the constants exceed the kernel's constant bank, the
    column tables of K5 and K6
    (:func:`~qpsim_tpu_torch.ops.collisions_blocked_cuda.build_column_tables`),
    which the wrappers launch the column walk on.
    """
    dev = plan.emit_mask.device
    dtype = plan.emit_mask.dtype
    gather = plan.rho is not None
    if gather and plan.num_gaps > MAX_GAP_IDS:
        raise ValueError(
            f"{plan.num_gaps} unique gaps: the gap-id kernel takes at most {MAX_GAP_IDS} "
            "(continuous gap maps run the analytic kernel)"
        )
    nb = walk_bins(plan.num_energy_bins)
    if nb is None and (gather or analytic is not None):
        from .collisions_blocked_cuda import build_column_tables  # that module imports this one

        return build_column_tables(plan, None if gather else analytic)
    walk = pair_walk(plan, nb or plan.num_energy_bins)
    parts = []
    if gather:
        rho = torch.zeros((plan.num_gaps, walk.nb), dtype=dtype, device=dev)
        rho[:, : plan.num_energy_bins] = plan.rho
        parts.append(rho)
        dE = plan.dE
        if plan.enable_scattering:  # as collision_step_plain forms dE·K^s₀ and 2dE·K^r₀
            parts.append(_entries(walk.s_pairs, dE * plan.K_s0).flatten(-2))
        if plan.enable_recombination:
            parts.append(_entries(walk.r_pairs, 2.0 * dE * plan.K_r0).flatten(-2))
    elif analytic is not None:
        a = analytic
        head = torch.zeros((4, walk.nb), dtype=dtype, device=dev)
        for row, v in enumerate((a.E, a.inv_E, a.e2, a.zi)):
            head[row, : plan.num_energy_bins] = v
        parts.append(head.reshape(-1))
        if plan.enable_scattering:
            parts.append(_entries(walk.s_pairs, a.dEa_s, a.dEb_s).reshape(-1))
        if plan.enable_recombination:
            parts.append(_entries(walk.r_pairs, a.dEa2_r, a.dEb2_r).reshape(-1))
    consts = torch.cat(parts, -1).contiguous() if parts else None
    if consts is not None and consts.numel() * consts.element_size() > CONST_BANK_BYTES:
        from .collisions_blocked_cuda import build_column_tables  # that module imports this one

        return build_column_tables(plan, None if gather else analytic)
    width = 2 if gather else 4
    scat_off = walk.nb * (1 if gather else 4)
    n_scat = len(walk.s_pairs) if plan.enable_scattering else 0
    n_rec = len(walk.r_pairs) if plan.enable_recombination else 0
    rows = np.concatenate([walk.s_meta[:, 0], walk.r_meta[:, 0]])
    simple = (plan.num_energy_bins == walk.nb == WALK_BINS and plan.enable_scattering
              and plan.enable_recombination and len(walk.s_meta) == walk.nb - 1
              and len(walk.r_meta) == 2 * walk.nb - 1 and len(np.unique(rows)) == len(rows))
    ints = lambda a: torch.as_tensor(np.ascontiguousarray(a).reshape(-1), dtype=torch.int32, device=dev)
    return CollisionKernelTables(
        nb=walk.nb, analytic=not gather, consts=consts, n_scat=n_scat, n_rec=n_rec,
        scat_off=scat_off, rec_off=scat_off + width * n_scat,
        s_ptr=ints(walk.s_ptr), r_ptr=ints(walk.r_ptr), s_meta=ints(walk.s_meta),
        r_meta=ints(walk.r_meta), rows=ints(rows), simple=bool(simple),
    )


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def check_inputs(plan, n_qp, n_ph, gen, named_tables, max_bins: int | None) -> None:
    """Refuse a collision kernel's inputs that do not match ``plan``: shapes,
    dtype, device, contiguity of the states, ``gen`` and ``named_tables``
    ((name, tensor) pairs, None skipped), and more than ``max_bins`` bins
    (None: the column walk of K5/K6, which takes any number)."""
    if not plan.active:
        raise ValueError("collision kernel called with no collision channel enabled")
    if n_qp.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"collision kernel takes float32 or float64, got {n_qp.dtype}")
    ne, nw = plan.num_energy_bins, plan.num_omega
    if max_bins is not None and ne > max_bins:
        raise ValueError(f"collision kernel holds at most {max_bins} bins, got {ne}")
    if n_qp.ndim != 3 or n_qp.shape[0] != ne:
        raise ValueError(f"n_qp must be ({ne}, Ny, Nx), got {tuple(n_qp.shape)}")
    if tuple(n_ph.shape) != (nw, *n_qp.shape[1:]):
        raise ValueError(f"n_ph must be ({nw}, Ny, Nx), got {tuple(n_ph.shape)}")
    if gen is not None and tuple(gen.shape) != tuple(n_qp.shape[1:]):
        raise ValueError(f"gen must be (Ny, Nx), got {tuple(gen.shape)}")
    for name, t in (("n_qp", n_qp), ("n_ph", n_ph), ("gen", gen), *named_tables):
        if t is None:
            continue
        if t.device != n_qp.device:
            raise ValueError(f"{name} is on {t.device}, the state on {n_qp.device}")
        if t.dtype != n_qp.dtype:
            raise TypeError(f"{name} is {t.dtype}, the state {n_qp.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _outputs(plan, n_qp, n_ph):
    q_out = torch.empty_like(n_qp)
    ph_out = torch.empty_like(n_ph) if plan.update_phonons else n_ph
    return q_out, ph_out


def count_launch(name: str, gen) -> None:
    """Count one launch of ``name`` in :data:`LAUNCHES` (and of ``name_with_gen`` with a gen plane)."""
    LAUNCHES[name] += 1
    LAUNCHES[f"{name}_with_gen"] += gen is not None


#: per device, the stream of the last launch that wrote the kernel's constant bank
_BANK_STREAM: dict = {}


def _bank_stream(device: torch.device):
    """The current stream, ordered after the last launch of another stream.

    The kernel's constant bank is one per device, written before each launch
    on the launch's stream: a launch on a new stream first waits for the
    work already queued on the last one, so it cannot overwrite constants a
    kernel there has yet to read.  Inside a CUDA graph's capture the graph's
    own order holds (its replays must not overlap another stream's K3/K4
    launches).
    """
    stream = torch.cuda.current_stream(device)
    if torch.cuda.is_current_stream_capturing():
        return stream
    last = _BANK_STREAM.get(stream.device_index)
    if last is not None and last != stream:
        stream.wait_stream(last)
    _BANK_STREAM[stream.device_index] = stream
    return stream


def _launch(name: str, plan: CollisionPlan, tables: CollisionKernelTables, n_qp, n_ph, dt: float,
            gen, *, gid=None, analytic: AnalyticTables | None = None) -> tuple:
    """Launch ``qp_collision_step_<f32|f64>`` (K3 with ``tables.rho``, K4 with
    ``analytic``) on CUDA tensors already checked against ``plan``, on the
    current stream (:func:`_bank_stream`)."""
    if tables.nb != WALK_BINS:
        raise ValueError(f"the tables cover {tables.nb} bins; the kernel holds {WALK_BINS}")
    n_pix = n_qp.shape[1] * n_qp.shape[2]
    q_out, ph_out = _outputs(plan, n_qp, n_ph)
    c = tables.consts
    fn = getattr(load_kernels(), f"qp_collision_step_{'f32' if n_qp.dtype == torch.float32 else 'f64'}")
    stream = _bank_stream(n_qp.device)
    err = fn(
        _ptr(n_qp), _ptr(n_ph), _ptr(gen), _ptr(q_out), _ptr(ph_out) if plan.update_phonons else None,
        _ptr(c), c.numel(), c.shape[-1], tables.scat_off, tables.rec_off, _ptr(gid),
        None if analytic is None else _ptr(analytic.g2), 0.0 if analytic is None else float(analytic.gamma),
        _ptr(tables.s_ptr), _ptr(tables.r_ptr), _ptr(tables.s_meta), _ptr(tables.r_meta),
        _ptr(tables.rows), tables.s_meta.numel() // 2, tables.r_meta.numel() // 2,
        int(tables.simple), plan.num_energy_bins, tables.nb,
        plan.num_omega, n_pix, float(dt), int(plan.update_phonons),
        stream.cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {err}")
    count_launch(name, gen)
    return q_out, ph_out


def _on_device(name: str, tables: CollisionKernelTables, n_qp) -> None:
    for t in (tables.s_ptr, tables.r_ptr, tables.s_meta, tables.r_meta, tables.rows):
        if t.device != n_qp.device or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{name}: the walk's groups must be contiguous int32 on {n_qp.device}")


def launch_columns(name: str, plan: CollisionPlan, tables: ColumnTables, n_qp, n_ph, dt: float, gen,
                   analytic: AnalyticTables | None = None, max_bins: int | None = MAX_KERNEL_BINS) -> tuple:
    """Launch the column walk (``csrc/offset_walk.cu``) on CUDA tensors, counted as ``name``:
    K5/K6, and K3/K4 beyond the register buckets."""
    if n_qp.device.type != "cuda":
        raise ValueError(f"collision kernel runs on CUDA tensors, got {n_qp.device}")
    if not isinstance(tables, ColumnTables) or (tables.analytic is None) != (analytic is None):
        raise TypeError(f"{name} takes the column tables of build_column_tables(plan"
                        f"{'' if analytic is None else ', analytic'})")
    named = (("scat", tables.scat), ("rec", tables.rec), ("rho", tables.rho))
    if analytic is not None:
        named += (("g2", analytic.g2), ("E", analytic.E), ("e2", analytic.e2), ("zi", analytic.zi))
    check_inputs(plan, n_qp, n_ph, gen, named, max_bins)
    n_pix = n_qp.shape[1] * n_qp.shape[2]
    if analytic is not None and analytic.g2.numel() != n_pix:
        raise ValueError(f"the Δ² plane holds {analytic.g2.numel()} pixels, the state {n_pix}")
    out = launch_column_walk(tables, n_qp, n_ph, dt, gen, plan.update_phonons)
    count_launch(name, gen)
    return out


def _check_channels(plan: CollisionPlan, tables: CollisionKernelTables) -> None:
    """The tables hold constants for each channel the plan enables and has
    pairs for (one bin has no scattering pair), and for no other."""
    has_s = plan.enable_scattering and tables.s_meta.numel() > 0
    has_r = plan.enable_recombination and tables.r_meta.numel() > 0
    if (tables.scat is not None) != has_s or (tables.rec is not None) != has_r:
        raise ValueError("the tables' channels differ from the plan's")


def _table_step(plan: CollisionPlan, tables, n_qp, n_ph, dt: float, gen):
    """Launch K3 (``collision_step`` or, with gap ids, ``collision_step_gid``) on CUDA tensors."""
    name = "collision_step" if plan.gap_id is None else "collision_step_gid"
    if isinstance(tables, ColumnTables):
        return launch_columns(name, plan, tables, n_qp, n_ph, dt, gen)
    if n_qp.device.type != "cuda":
        raise ValueError(f"collision kernel runs on CUDA tensors, got {n_qp.device}")
    if tables.analytic or tables.consts is None:
        raise ValueError("an analytic plan runs the analytic collision kernel")
    check_inputs(plan, n_qp, n_ph, gen, (("consts", tables.consts),), MAX_KERNEL_BINS)
    _check_channels(plan, tables)
    n_pix = n_qp.shape[1] * n_qp.shape[2]
    gid = plan.gap_id
    if gid is not None and (gid.device != n_qp.device or gid.numel() != n_pix
                            or gid.dtype != torch.uint8 or not gid.is_contiguous()):
        raise ValueError(f"gap ids must be {n_pix} contiguous uint8 entries on {n_qp.device}")
    _on_device(name, tables, n_qp)
    return _launch(name, plan, tables, n_qp, n_ph, dt, gen, gid=gid)


def _analytic_step(plan: CollisionPlan, analytic: AnalyticTables, tables, n_qp, n_ph, dt: float, gen):
    """Launch K4 (``collision_step_analytic``) on CUDA tensors."""
    name = "collision_step_analytic"
    if isinstance(tables, ColumnTables):
        return launch_columns(name, plan, tables, n_qp, n_ph, dt, gen, analytic)
    if n_qp.device.type != "cuda":
        raise ValueError(f"collision kernel runs on CUDA tensors, got {n_qp.device}")
    if not tables.analytic or tables.consts is None:
        raise ValueError("the analytic kernel needs build_kernel_tables(plan, analytic)")
    a = analytic
    check_inputs(plan, n_qp, n_ph, gen, (("g2", a.g2), ("consts", tables.consts)), MAX_KERNEL_BINS)
    _check_channels(plan, tables)
    n_pix = n_qp.shape[1] * n_qp.shape[2]
    if a.g2.numel() != n_pix:
        raise ValueError(f"the Δ² plane holds {a.g2.numel()} pixels, the state {n_pix}")
    _on_device(name, tables, n_qp)
    return _launch(name, plan, tables, n_qp, n_ph, dt, gen, analytic=a)


def collision_step(
    plan: CollisionPlan,
    tables: CollisionKernelTables | ColumnTables,
    n_qp: torch.Tensor,
    n_ph: torch.Tensor,
    dt: float,
    gen: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One collision substep through K3 (plain version on the CPU).

    Same contract as :func:`collision_step_plain`: (NE, Ny, Nx) and
    (NW, Ny, Nx) states in, new states out (inputs untouched), ``gen`` an
    optional (Ny, Nx) plane of dt·g added to every bin first.  A plan with
    per-pixel gap ids launches the gap-id form (``collision_step_gid``),
    which reads the plan's uint8 ``gap_id`` plane.  ``tables`` come from
    :func:`build_kernel_tables`; beyond the register buckets they are the
    column walk's, launched and counted the same way.  The kernel runs on
    the current stream; its constants sit in one bank per device, so a
    launch on another stream than the last one's first waits for that
    stream's queued work.
    """
    refuse_grad("the collision kernel (K3)", "ops.collisions.collision_step_plain", n_qp, n_ph, gen)
    if n_qp.device.type == "cpu":
        return collision_step_plain(plan, n_qp, n_ph, dt, gen)
    return _table_step(plan, tables, n_qp, n_ph, dt, gen)


def collision_step_analytic(
    plan: CollisionPlan,
    analytic: AnalyticTables,
    tables: CollisionKernelTables | ColumnTables,
    n_qp: torch.Tensor,
    n_ph: torch.Tensor,
    dt: float,
    gen: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One analytic-gap collision substep through K4 (plain version on the CPU).

    Same contract as :func:`collision_step_analytic_plain`; ``tables`` are
    ``build_kernel_tables(plan, analytic)``.  Streams as in
    :func:`collision_step`.
    """
    refuse_grad("the analytic collision kernel (K4)", "ops.collisions.collision_step_analytic_plain",
                n_qp, n_ph, gen, analytic.g2)
    if n_qp.device.type == "cpu":
        return collision_step_analytic_plain(plan, analytic, n_qp, n_ph, dt, gen)
    return _analytic_step(plan, analytic, tables, n_qp, n_ph, dt, gen)


# ---------------------------------------------------------------- builders of the JAX form


def build_collision_step(*, E_bins: np.ndarray, dE: float, rho: np.ndarray, K_s0: np.ndarray | None,
                         K_r0: np.ndarray | None, pmap, dt: float, update_phonons: bool = True,
                         gap_id: np.ndarray | None = None, device="cuda", dtype: torch.dtype | None = None):
    """K3 in the form of ``qpsim_tpu.ops.pallas_collisions.build_pallas_collision_step``.

    ``step(n_qp, n_ph, gen=None) -> (n_qp, n_ph)`` for one substep of ``dt``,
    the plan and the kernel's tables built once on ``device`` in ``dtype``
    (float32 on CUDA, float64 on the CPU by default).  ``rho``/``K_s0``/
    ``K_r0`` are (NE,)/(NE, NE), or stacked per gap with a dense ``gap_id``
    plane (at most :data:`MAX_GAP_IDS` gaps); a channel is off when its
    kernel is None (neither: the identity, after the ``gen`` add).  Beyond
    64 bins the step is K5.  The kernel's float64 entry runs float64 on the
    card: the JAX package's Mosaic limit on float64 does not apply.  The
    step launches on CUDA tensors and runs the plain version on CPU ones.
    """
    device, dtype = _device_dtype(device, dtype)
    plan = build_collision_plan_arrays(
        dE=dE, rho=rho, K_r0=K_r0, K_s0=K_s0, pmap=pmap, enable_recombination=K_r0 is not None,
        enable_scattering=K_s0 is not None, update_phonons=update_phonons, device=device,
        dtype=dtype, gap_id=gap_id)
    del E_bins  # the grid is in pmap and the tables; the name keeps the JAX signature
    if not plan.active:
        return lambda n_qp, n_ph, gen=None: (n_qp if gen is None else n_qp + gen[None], n_ph)
    from .collisions_blocked_cuda import kernel_forms  # the dispatch; that module imports this one

    wrapper, tables_of = kernel_forms(plan.num_energy_bins, plan.num_gaps, analytic=False)
    tables = tables_of(plan)
    dt = float(dt)
    step = lambda n_qp, n_ph, gen=None: wrapper(plan, tables, n_qp, n_ph, dt, gen)
    # what a caller timing the kernel needs: its plan, tables and plain version
    step.plan, step.tables = plan, tables
    step.plain = lambda n_qp, n_ph, gen=None: collision_step_plain(plan, n_qp, n_ph, dt, gen)
    return step


def build_collision_step_analytic(*, E_bins: np.ndarray, dE: float, gap_plane: np.ndarray | None, pmap,
                                  dt: float, tau_s: float | None, tau_r: float | None, T_c: float,
                                  dynes_gamma: float = 0.0, update_phonons: bool = True,
                                  device="cuda", dtype: torch.dtype | None = None):
    """K4 in the form of ``build_pallas_collision_step_analytic``: the
    per-pixel constants from the dense (Ny, Nx) ``gap_plane`` (µeV);
    ``tau_s``/``tau_r`` None turn a channel off.  Same step as
    :func:`build_collision_step`; beyond 64 bins K6.

    With ``gap_plane=None`` the step takes the plane at call time,
    ``step(n_qp, n_ph, gap_plane, gen=None)``, as a spatially sharded
    caller needs (each shard passes its own rows): Δ² is formed from it in
    the state's dtype at every call, and everything else is built here once.
    """
    device, dtype = _device_dtype(device, dtype)
    call_time = gap_plane is None
    plan, atab = build_analytic_plan(
        E_bins=E_bins, dE=dE, gap_plane=np.zeros((1, 1)) if call_time else gap_plane, pmap=pmap,
        tau_s=tau_s, tau_r=tau_r, T_c=T_c, dynes_gamma=dynes_gamma, update_phonons=update_phonons,
        device=device, dtype=dtype)
    if not plan.active:
        identity = lambda n_qp, n_ph, gen=None: (n_qp if gen is None else n_qp + gen[None], n_ph)
        if call_time:  # the call-time form takes (and ignores) the plane
            return lambda n_qp, n_ph, gap_plane, gen=None: identity(n_qp, n_ph, gen)
        return identity
    from .collisions_blocked_cuda import kernel_forms  # the dispatch; that module imports this one

    wrapper, tables_of = kernel_forms(plan.num_energy_bins, 0, analytic=True)
    tables = tables_of(plan, atab)
    dt = float(dt)
    if not call_time:
        step = lambda n_qp, n_ph, gen=None: wrapper(plan, atab, tables, n_qp, n_ph, dt, gen)
        step.plan, step.tables, step.analytic = plan, tables, atab
        step.plain = lambda n_qp, n_ph, gen=None: collision_step_analytic_plain(plan, atab, n_qp, n_ph,
                                                                                dt, gen)
        return step

    def at_call(n_qp: torch.Tensor, gap_plane) -> tuple:
        """The Δ² tables of this call's plane (in n_qp's dtype), and the tables that hold them."""
        g2 = torch.as_tensor(gap_plane).to(n_qp.dtype).reshape(-1) ** 2
        a = replace(atab, g2=g2.contiguous())
        return a, (replace(tables, analytic=a) if isinstance(tables, ColumnTables) else tables)

    def step(n_qp, n_ph, gap_plane, gen=None):
        a, t = at_call(n_qp, gap_plane)
        return wrapper(plan, a, t, n_qp, n_ph, dt, gen)

    def plain(n_qp, n_ph, gap_plane, gen=None):
        return collision_step_analytic_plain(plan, at_call(n_qp, gap_plane)[0], n_qp, n_ph, dt, gen)

    step.plan, step.tables, step.analytic, step.plain = plan, tables, atab, plain
    return step
