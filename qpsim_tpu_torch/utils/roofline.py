"""The H100's peak rates and the work the port's kernels must do.

A kernel's bound is the least time the card could take for its work: the
larger of the bytes it must move (each input read once, each output
written once) over the card's memory rate, and the operations it does on
these inputs over the card's peak rate for their type.  The peaks are the
H100 SXM data sheet's.  ``chip_smoke.py`` and ``qpsim_tpu_torch.bench``
count bytes and operations with these functions, so their bounds agree.
"""

from __future__ import annotations

import torch

__all__ = ["HBM_BYTES_PER_S", "PEAK_FLOPS", "nbytes", "bound", "collision_work", "kernel_tensors",
           "adi_work", "adi_sep_work", "thomas_work"]

#: H100 SXM data-sheet peaks: HBM bytes/s and float32 (non-tensor) and float64 FLOP/s
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound(n_bytes: float, flops: float, dtype) -> dict:
    """bound_ms / bound_by of a kernel from its bytes and operations."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return dict(bound_ms=1e3 * max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations")


def collision_work(plan, q, ph, gen, tensors, analytic=False) -> tuple[int, int]:
    """(bytes, operations) of one collision substep on these inputs.

    Bytes: q and n_ph in and out (n_ph out only when phonons update), the
    gen plane and every table once.  Operations per pixel: what the
    function needs, however often a kernel re-forms a term.  K^s₀, K^r₀
    and their ω rows are symmetric in (i, j), so each constant is formed
    once per unordered pair {i, j}:
      scattering, i ≠ j (NE(NE − 1)/2 pairs): K·n and K + K·n (2), the
        four gathers loss_i, loss_j, gain_i, gain_j (8), the phonon row's
        emission and absorption terms (4) and their sums into a, b (3);
      recombination, i ≤ j (NE(NE + 1)/2 pairs): k·s and k + k·s (2),
        the phonon row's k·q_i·q_j and k·p_i·p_j (4) and their sums (3);
        the gathers loss_i += k(1 + s)·q_j, gain_i += k·s·p_j take 4 per
        ordered pair (NE²);
    then 16 per bin (partner, gain, relaxation), 1 per bin for gen and 10
    per ω row.  The analytic forms add 10 per bin for ρ and, per
    unordered pair, 3 for the scattering constant and 2 for the
    recombination constant from Δ².
    """
    ne, nw = plan.num_energy_bins, plan.num_omega
    n_pix = q.shape[1] * q.shape[2]
    n_s = ne * (ne - 1) // 2 if plan.enable_scattering else 0
    n_r = ne * (ne + 1) // 2 if plan.enable_recombination else 0
    n_r_ordered = ne * ne if plan.enable_recombination else 0
    per_px = 10 * n_s + 2 * n_r + 4 * n_r_ordered + 16 * ne + (ne if gen is not None else 0)
    if plan.update_phonons:
        per_px += 7 * n_s + 7 * n_r + 10 * nw
    if analytic:
        per_px += 10 * ne + 3 * n_s + 2 * n_r
    state = nbytes(q, q, ph, gen) + (nbytes(ph) if plan.update_phonons else 0)
    return state + nbytes(*tensors), per_px * n_pix


def kernel_tensors(tables, *planes) -> list:
    """What a K3/K4 launch reads besides the state (for byte counts): the
    pair walk's tables and ``planes`` (gap ids, Δ² and the Dynes
    constants), or beyond the register buckets the column walk's tables."""
    from ..ops.column_walk import ColumnTables

    if isinstance(tables, ColumnTables):
        return tables.kernel_tensors()
    return [*planes, *tables.kernel_tensors()]


def adi_work(u, planes) -> tuple[int, int]:
    """(bytes, operations) of one K2 half: u in, out, the 7 planes and the scale; ≈ 20 flops per element."""
    p = planes
    return nbytes(u, u, p.ax_lo, p.ax_hi, p.ax_diag, p.ay_lo, p.ay_hi, p.ay_diag, p.src, p.scale), 20 * u.numel()


def adi_sep_work(u, f, half: str) -> tuple[int, int]:
    """(bytes, operations) of one K1 half: u in, out, its packs; ≈ 15 flops per element."""
    packs = (f.xv, f.yv) + ((f.facx, f.ifx) if half == "x" else (f.facy, f.ify))
    return nbytes(u, u, *packs), 15 * u.numel()


def thomas_work(system) -> tuple[int, int]:
    """(bytes, operations) of the Thomas solve: a, b, c, r in, x out; ≈ 8 flops per element."""
    return nbytes(*system, system[3]), 8 * system[3].numel()
