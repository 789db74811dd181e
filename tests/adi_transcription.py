"""``qpsim_tpu_torch/csrc/adi_staged.cuh`` and its policies in NumPy.

The policies: K1 ``adi_sep.cu``, K2 ``adi.cu``, K7 ``adi_lines.cu``, K10
``tridiag.cu``.

The kernels' blocking, step by step: a block owns TL lines of one bin
(rows in the x half, columns in the y half, the last block ragged, its
lines past the grid solved as identity rows and never stored); one thread
per (line, Wang chunk) with the shared-memory layout of the header (M =
⌈n/K⌉ rows a chunk, K2's positions from n on identity rows never stored;
chunk pitch S = M, or M + 1 when M is even; x half (l·W + w)·S + i, y half
(w·S + i)·TL + l); the x half staged from the state with the rows outside
the grid zero, the y half read straight from the state as the forward
sweep walks; W chunks of a line held at once, in K / W waves, with the
two-pass form when W < K; the Wang stages in the TPU kernel's order; the
interface recurrence by one thread per line.  Each step is vectorised over
the block's threads, which changes no recurrence's order.  Shared memory
starts as NaN, so a read of a slot the kernel never wrote shows.  Imported
by the CPU tests of K1, K2, K7 and K10.
"""

import numpy as np


def pitch(m: int) -> int:
    return m + 1 if m % 2 == 0 else m


def pick_chunks(n: int) -> int:
    for k in (32, 16, 8, 4, 2):
        if n % k == 0 and n // k >= 8:
            return k
    return 1


def launch_chunks(n: int) -> int:
    """The K that K2 and K7 launch for a line of n asked to take
    ``pick_chunks(n)`` (``make_plan_raising_k``, leaving out the raise for
    chunks too long for shared memory): at least 32 from 256 cells on."""
    k = pick_chunks(n)
    return 32 if k < 32 and n >= 256 else k


class _Fused:
    """K2's policy: per-cell (a, c, rhs, b), A′ C′ D kept, 6 interface slots."""

    arrays, kept, slots = 4, 3, 6

    def __init__(self, u, planes, scale, alpha, x_half, k):
        self.u = u
        self.nb, self.ny, self.nx = u.shape
        self.planes = planes  # explicit lo, hi, diag, src, then solve lo, hi, diag; (NBp, Ny, Nx)
        self.scale, self.alpha, self.x_half, self.k = scale, alpha, x_half, k
        self.n_lines, self.n = (self.ny, self.nx) if x_half else (self.nx, self.ny)

    def state(self, b, line, p):
        ok = (line >= 0) & (line < self.n_lines) & (p < self.n)
        y, x = (line, p) if self.x_half else (p, line)
        return np.where(ok, self.u[b, np.clip(y, 0, self.ny - 1), np.clip(x, 0, self.nx - 1)], 0.0)

    def fetch(self, b, line, p, up, uc, dn):
        bp = b if self.planes[0].shape[0] > 1 else 0
        y, x = (line, p) if self.x_half else (p, line)
        valid = (line < self.n_lines) & (p < self.n)  # else an identity row
        y, x = np.where(valid, y, 0), np.where(valid, x, 0)
        elo, ehi, ediag, src, slo, shi, sdiag = (pl[bp, y, x] for pl in self.planes)
        a_s = self.alpha * self.scale[b]
        rhs = uc + a_s * (elo * up + ehi * dn + ediag * uc + src)
        a = np.where(p > 0, -a_s * slo, 0.0)
        c = np.where(p + 1 < self.n, -a_s * shi, 0.0)
        bb = 1.0 - a_s * sdiag
        return [np.where(valid, a, 0.0), np.where(valid, c, 0.0), np.where(valid, rhs, 0.0),
                np.where(valid, bb, 1.0)]

    def eliminate(self, b, c, m, get, put, keep_slots):
        """Stages 1–2; get(i) -> (a, c, d, b) arrays, put(i, A, C, D)."""
        cp = np.zeros_like(c, dtype=float)
        ap = np.full_like(cp, -1.0)
        dp = np.zeros_like(cp)
        rows = []
        for i in range(m):
            a_i, c_i, d_i, b_i = get(i)
            inv = 1.0 / (b_i - a_i * cp)
            cp = c_i * inv
            ap = -a_i * ap * inv
            dp = (d_i - a_i * dp) * inv
            rows.append([ap, cp, dp])
            put(i, ap, cp, dp)
        c_n, a_n, d_n = cp, ap, dp
        for i in range(m - 2, -1, -1):
            A, C, D = rows[i]
            d_n = D - C * d_n
            if self.k > 1:
                c_n = -C * c_n
                a_n = A - C * a_n
                put(i, a_n, c_n, d_n)
            else:
                put(i, A, C, d_n)
        if keep_slots is not None and self.k > 1:
            keep_slots([a_n, c_n, d_n, ap, cp, dp])

    def interface(self, b, slots):
        """slots (6, K, lines): aL, cL, dL, aR, cR, dR -> L into dL, R into dR."""
        s_al, s_cl, s_dl, s_ar, s_cr, s_dr = slots
        g = np.zeros(slots.shape[2])
        w = np.zeros_like(g)
        for j in range(self.k):
            a_l, a_r = s_al[j].copy(), s_ar[j].copy()
            inv = 1.0 / (1.0 - a_l * w)
            p = (s_dl[j] - a_l * g) * inv
            q = s_cl[j] * inv
            g = s_dr[j] - a_r * g + a_r * w * p
            w = s_cr[j] + a_r * w * q
            s_dl[j], s_cl[j], s_dr[j], s_cr[j] = p, q, g, w
        l_next = np.zeros_like(g)
        for j in range(self.k - 1, -1, -1):
            lj = s_dl[j] - s_cl[j] * l_next
            s_dr[j] = s_dr[j] - s_cr[j] * l_next
            s_dl[j] = lj
            l_next = lj

    def boundary(self, slots, c, l):
        zero = np.zeros(len(c))
        cm, cp1 = np.clip(c - 1, 0, self.k - 1), np.clip(c + 1, 0, self.k - 1)
        x_left = np.where(c > 0, slots[5][cm, l], zero) if self.k > 1 else zero
        x_right = np.where(c + 1 < self.k, slots[2][cp1, l], zero) if self.k > 1 else zero
        return x_left, x_right

    def finish_row(self, b, c, i, kept, x_left, x_right):
        A, C, D = kept
        return D - A * x_left - C * x_right if self.k > 1 else D


class _Lines(_Fused):
    """K7's policy: K2's stages on a given rhs, along axis −2 of (NB, N, B)."""

    def __init__(self, rhs, lo, di, hi, scale, alpha, k):
        self.u = rhs
        self.nb, self.n, self.n_lines = rhs.shape
        self.lo, self.di, self.hi = lo, di, hi
        self.scale, self.alpha, self.x_half, self.k = scale, alpha, False, k

    def state(self, b, line, p):
        return np.zeros(np.broadcast(line, p).shape)

    def fetch(self, b, line, p, up, uc, dn):
        bp = b if self.lo.shape[0] > 1 else 0
        valid = (line < self.n_lines) & (p < self.n)  # else an identity row
        y, x = np.where(valid, p, 0), np.where(valid, line, 0)
        a_s = self.alpha * self.scale[b]
        a, c = -a_s * self.lo[bp, y, x], -a_s * self.hi[bp, y, x]
        bb = 1.0 - a_s * self.di[bp, y, x]
        return [np.where(valid, a, 0.0), np.where(valid, c, 0.0), np.where(valid, self.u[b, y, x], 0.0),
                np.where(valid, bb, 1.0)]


class _Tridiag(_Fused):
    """K10's policy: K2's stages on four general per-cell arrays, given as
    (NB, lines, n) in the rows form (x half, NB = 1) and (lead, n, lines)
    in the cols form (y half, the lead index in place of the bin)."""

    def __init__(self, sub, diag, sup, rhs, rows, k):
        self.u = rhs
        self.arrs = (sub, diag, sup, rhs)
        self.x_half, self.k = rows, k
        self.nb = rhs.shape[0]
        self.n_lines, self.n = (rhs.shape[1], rhs.shape[2]) if rows else (rhs.shape[2], rhs.shape[1])

    def state(self, b, line, p):
        return np.zeros(np.broadcast(line, p).shape)

    def fetch(self, b, line, p, up, uc, dn):
        valid = (line < self.n_lines) & (p < self.n)  # else an identity row
        li, pi = np.where(valid, line, 0), np.where(valid, p, 0)
        a, bb, c, d = (arr[b, li, pi] if self.x_half else arr[b, pi, li] for arr in self.arrs)
        # sub[0] and sup[n − 1] are read as zero (the caller's arrays may hold anything there)
        a = np.where(valid & (p > 0), a, 0.0)
        c = np.where(valid & (p + 1 < self.n), c, 0.0)
        return [a, c, np.where(valid, d, 0.0), np.where(valid, bb, 1.0)]


class _Sep:
    """K1's policy: per-cell rhs, the host packs, 2 interface slots."""

    arrays, kept, slots = 1, 1, 2

    def __init__(self, u, xv, yv, fac, ifc, x_half):
        self.u = u
        self.nb, self.ny, self.nx = u.shape
        self.xv, self.yv, self.fac, self.ifc, self.x_half = xv, yv, fac, ifc, x_half
        self.k = fac.shape[3]
        self.n_lines, self.n = (self.ny, self.nx) if x_half else (self.nx, self.ny)

    state = _Fused.state

    def fetch(self, b, line, p, up, uc, dn):
        ev = (self.yv if self.x_half else self.xv)[b]
        s3 = (self.xv if self.x_half else self.yv)[b, 3]
        valid = line < self.n_lines
        li = np.where(valid, line, 0)
        rhs = uc + ev[0, li] * up + ev[1, li] * dn + ev[2, li] * uc
        rhs = rhs + ev[3, li] + s3[p]
        return [np.where(valid, rhs, 0.0)]

    def eliminate(self, b, c, m, get, put, keep_slots):
        pk = self.fac[b]
        dp = np.zeros(len(c))
        rows = []
        for i in range(m):
            (d_i,) = get(i)
            dp = (d_i - pk[0, i, c] * dp) * pk[1, i, c]
            rows.append(dp)
            put(i, dp)
        D = dp
        for i in range(m - 2, -1, -1):
            D = rows[i] - pk[2, i, c] * D
            put(i, D)
        if keep_slots is not None:
            keep_slots([D, dp])

    def interface(self, b, slots):
        s_left, s_right = slots
        itab = self.ifc[b]
        g = np.zeros(slots.shape[2])
        for j in range(self.k):
            row = itab[j]
            p = (s_left[j] - row[0] * g) * row[1]
            g = s_right[j] - row[2] * g + row[3] * p
            s_left[j], s_right[j] = p, g
        l_next = np.zeros_like(g)
        for j in range(self.k - 1, -1, -1):
            row = itab[j]
            lj = s_left[j] - row[4] * l_next
            s_right[j] = s_right[j] - row[5] * l_next
            s_left[j] = lj
            l_next = lj

    def boundary(self, slots, c, l):
        zero = np.zeros(len(c))
        cm, cp1 = np.clip(c - 1, 0, self.k - 1), np.clip(c + 1, 0, self.k - 1)
        return (np.where(c > 0, slots[1][cm, l], zero), np.where(c + 1 < self.k, slots[0][cp1, l], zero))

    def finish_row(self, b, c, i, kept, x_left, x_right):
        pk = self.fac[b]
        (D,) = kept
        return D - pk[3, i, c] * x_left - pk[4, i, c] * x_right


def _solve_half(pol, x_half: bool, k: int, tl: int, w: int) -> np.ndarray:
    nb, n_lines, n = pol.nb, pol.n_lines, pol.n
    m = -(-n // k)
    s = pitch(m)
    size = tl * w * s
    held = pol.arrays if x_half else pol.kept
    waves, span = k // w, w * m
    t = np.arange(tl * w)
    l = t // w if x_half else t % tl
    cw = t % w if x_half else t // tl
    at = (lambda l_, c_, i_: (l_ * w + c_) * s + i_) if x_half else (lambda l_, c_, i_: (c_ * s + i_) * tl + l_)
    out = np.full(pol.u.shape, np.nan)
    for b in range(nb):
        for line0 in range(0, n_lines, tl):
            smem = np.full(held * size, np.nan)
            slots = np.full((pol.slots, k, tl), np.nan)

            def stage(wave):
                ll, qq = np.meshgrid(np.arange(tl), np.arange(span), indexing="ij")
                ll, qq = ll.ravel(), qq.ravel()
                p = wave * span + qq
                line = line0 + ll
                vals = pol.fetch(b, line, p, pol.state(b, line - 1, p), pol.state(b, line, p),
                                 pol.state(b, line + 1, p))
                idx = at(ll, qq // m, qq % m)
                for j, v in enumerate(vals):
                    smem[j * size + idx] = v

            def run(wave, keep):
                c = wave * w + cw
                if x_half:
                    get = lambda i: [smem[j * size + at(l, cw, i)] for j in range(pol.arrays)]
                else:
                    def get(i):
                        p = c * m + i
                        line = line0 + l
                        return pol.fetch(b, line, p, pol.state(b, line - 1, p), pol.state(b, line, p),
                                         pol.state(b, line + 1, p))

                def put(i, *vals):
                    for j, v in enumerate(vals):
                        smem[j * size + at(l, cw, i)] = v

                keep_slots = None
                if keep:
                    def keep_slots(vals):
                        for f, v in enumerate(vals):
                            slots[f][c, l] = v
                pol.eliminate(b, c, m, get, put, keep_slots)

            for wave in range(waves):
                if x_half:
                    stage(wave)
                run(wave, True)
            if k > 1:
                pol.interface(b, slots)
            for wave in range(waves):
                c = wave * w + cw
                if waves > 1:
                    if x_half:
                        stage(wave)
                    run(wave, False)
                x_left, x_right = pol.boundary(slots, c, l)
                line = line0 + l
                for i in range(m):
                    kept = [smem[j * size + at(l, cw, i)] for j in range(pol.kept)]
                    x = pol.finish_row(b, c, i, kept, x_left, x_right)
                    p = c * m + i
                    ok = (line < n_lines) & (p < n)
                    if x_half:
                        out[b, line[ok], p[ok]] = x[ok]
                    else:
                        out[b, p[ok], line[ok]] = x[ok]
    return out


def fused_half(u, planes, alpha: float, half: str, *, tl: int, w: int | None = None,
               k: int | None = None) -> np.ndarray:
    """One K2 half on NumPy arrays: ``planes`` the AdiPlanes fields as
    arrays (ax_lo, ax_hi, ax_diag, ay_lo, ay_hi, ay_diag, src, scale); ``k``
    the chunk count launched (by default the kernel's, ``launch_chunks``),
    the last chunk padded with identity rows where it does not divide the
    line."""
    ax_lo, ax_hi, ax_diag, ay_lo, ay_hi, ay_diag, src, scale = planes
    x_half = half == "x"
    n = u.shape[2] if x_half else u.shape[1]
    k = launch_chunks(n) if k is None else k
    order = ((ay_lo, ay_hi, ay_diag, src, ax_lo, ax_hi, ax_diag) if x_half
             else (ax_lo, ax_hi, ax_diag, src, ay_lo, ay_hi, ay_diag))
    pol = _Fused(u, order, scale, alpha, x_half, k)
    return _solve_half(pol, x_half, k, tl, k if w is None else w)


def sep_half(u, xv, yv, fac, ifc, half: str, *, tl: int, w: int | None = None) -> np.ndarray:
    """One K1 half on NumPy arrays (the SepFactors fields of the half)."""
    x_half = half == "x"
    pol = _Sep(u, xv, yv, fac, ifc, x_half)
    k = fac.shape[3]
    return _solve_half(pol, x_half, k, tl, k if w is None else w)


def lines_solve(rhs, lo, di, hi, scale, alpha: float, k: int, *, tl: int,
                w: int | None = None) -> np.ndarray:
    """K7 on NumPy arrays: (I − α·s_b·L) x = rhs along axis −2 of (NB, N,
    B), in ``k`` chunks (the K launched: the last chunk padded with identity
    rows when ``k`` does not divide N)."""
    return _solve_half(_Lines(rhs, lo, di, hi, scale, alpha, k), False, k, tl, k if w is None else w)


def tridiag_lines(sub, diag, sup, rhs, form: str, *, k: int | None = None, tl: int,
                  w: int | None = None) -> np.ndarray:
    """K10 on NumPy arrays: T x = rhs along the last axis of (..., n) arrays
    of one shape, read as the kernel reads them: "rows" (every line on its
    own, as contiguous lines) or "cols" (lines j of a (..., lines, n)
    array, the movedim(−2, −1) view of (..., n, lines), as adjacent
    columns of each lead index); ``k`` the chunk count launched (by default
    the kernel's, ``launch_chunks``), the last chunk padded with identity
    rows where it does not divide n."""
    shape = rhs.shape
    n = shape[-1]
    k = launch_chunks(n) if k is None else k
    if form == "rows":
        arrs = [np.asarray(t, dtype=float).reshape(1, -1, n) for t in (sub, diag, sup, rhs)]
    else:
        arrs = [np.swapaxes(np.asarray(t, dtype=float).reshape(-1, shape[-2], n), 1, 2)
                for t in (sub, diag, sup, rhs)]
    out = _solve_half(_Tridiag(*arrs, form == "rows", k), form == "rows", k, tl, k if w is None else w)
    return (out if form == "rows" else np.swapaxes(out, 1, 2)).reshape(shape)
