"""``qpsim_tpu_torch/csrc/offset_walk.cu`` (the column walk of K5, K6, K8, K9) in NumPy.

The kernel's tile layout and walk, on the wrapper's real tables
(:class:`qpsim_tpu_torch.ops.column_walk.ColumnTables`): tiles of
32·P pixels, each of the warp's 32 lanes owning P neighbouring pixels; q
(+ dt·g) and partner staged [NE][32·P], zeros in a ragged tile's idle
pixels; the columns' phonon values read per pixel; the warp-uniform gap-id
test (one table base when all of the tile's ids agree, a per-pixel gather
otherwise).  The register-blocked walk in its order (the block of B bins,
offsets or anti-diagonals a task takes changes no sum's order, so it is
not modelled): per bin its scattering pass over every partner j ascending (the first
column of offset |i − j|, from the dense [partner][bin] copy ``qs``, the
phonon value of ``k_row``), then its recombination pass (``qr``, ``s_row``
of i + j), then the columns beyond the first (``x_scat``, ``x_rec``) from
the [bin][column] tables; each offset's first column summed over m
(``ps``) and each anti-diagonal's over i (``pr``), written to
``k_out``/``s_out``; the rows of ``slow_rows`` summed column by column in
their list's order, from the [column][bin] copies.  Each lane's walk is
vectorised over the tile's pixels, which changes no sum's order either.
``form="device"`` is the device-memory form (``kDevice``, P = 1): the
staging writes each block's q and partner into its own [2][NE][32] slice
of one scratch buffer, and the walk reads them from there.
Imported by the CPU tests of K5/K6 and K8/K9.
"""

import numpy as np


def relax(n, gain, loss, dt):
    mu = np.maximum(loss, 0.0)
    p_term = np.maximum(gain + (mu - loss) * n, 0.0)
    coeff = np.where(mu < 1e-14, dt, -np.expm1(-mu * dt) / np.maximum(mu, 1e-14))
    return np.maximum(np.exp(-mu * dt) * n + coeff * p_term, 0.0)


def affine(y, a, b, dt):
    x = np.clip(b * dt, -80.0, 80.0)
    tiny = np.abs(b) < 1e-14
    coeff = np.where(tiny, dt, np.expm1(x) / np.where(tiny, 1.0, b))
    return np.maximum(np.exp(x) * y + coeff * a, 0.0)


def analytic_rho(d2, e, inv_e, e2, zim, gamma):
    """(ρ, 1/ρ) in collision_math.cuh's order."""
    if gamma == 0.0:
        r2 = e2 - d2
        t = 1.0 / np.sqrt(np.maximum(r2, 1e-30))
        return np.where(r2 > 0, e * t, 0.0), np.where(r2 > 0, (r2 * t) * inv_e, 0.0)
    zr = e2 - d2
    r = np.sqrt(zr * zr + zim * zim)
    s = np.sqrt(np.maximum(0.5 * (r + zr), 0.0))
    tq = -np.sqrt(np.maximum(0.5 * (r - zr), 0.0))
    rho = np.maximum((e * s - gamma * tq) / np.maximum(r, 1e-30), 0.0)
    return rho, np.where(rho > 1e-30, 1.0 / np.maximum(rho, 1e-30), 0.0)


def _np(t):
    return None if t is None else t.detach().cpu().numpy()


def transcribe(tables, q, ph, gen, dt, update_phonons, pixels, form="staged"):
    """One substep of the kernel at ``pixels`` per lane in ``form`` ("staged"
    or "device"): (q_out, ph_out) as (NE, …), (NW, …)."""
    ne, nw = tables.num_energy_bins, tables.num_omega
    tile = 32 * pixels
    if form not in ("staged", "device") or (form == "device" and pixels != 1):
        raise ValueError(f"the {form} form runs at {pixels} pixels per lane")
    scat, rec, rho = _np(tables.scat), _np(tables.rec), _np(tables.rho)
    scat_t, rec_t = _np(tables.scat_t), _np(tables.rec_t)  # the phonon side's copies
    qs, qr, ps, pr = (_np(t) for t in (tables.qs, tables.qr, tables.ps, tables.pr))  # the blocked walk's
    k_row, k_out, s_row, s_out, x_scat, x_rec, slow_rows = (
        _np(t) for t in (tables.k_row, tables.k_out, tables.s_row, tables.s_out, tables.x_scat,
                         tables.x_rec, tables.slow_rows))
    scat_k, scat_row, rec_s, rec_row, row_ptr, row_code = (
        _np(t) for t in (tables.scat_k, tables.scat_row, tables.rec_s, tables.rec_row,
                         tables.row_ptr, tables.row_code))
    n_scat, n_rec = tables.n_scat, tables.n_rec
    a = tables.analytic
    qf, phf = np.asarray(q).reshape(ne, -1), np.asarray(ph).reshape(nw, -1)
    n_pix = qf.shape[1]
    g_flat = np.zeros(n_pix) if gen is None else np.asarray(gen).reshape(-1)
    if a is None:
        keys = np.zeros(n_pix, np.int64) if tables.gid is None else _np(tables.gid).astype(np.int64)
    else:
        keys = _np(a.g2)
        e_b, inv_e, e2, zim = (_np(t) for t in (a.E, a.inv_E, a.e2, a.zi))
    q_out, ph_out = np.empty_like(qf), phf.copy()
    scratch = np.full((-(-n_pix // tile), 2, ne, tile), np.nan) if form == "device" else None
    for t0 in range(0, n_pix, tile):
        p = t0 + np.arange(tile)
        valid = p < n_pix
        pc = np.minimum(p, n_pix - 1)  # idle pixels take the last pixel's key
        key = keys[pc]
        # staging, zeros in idle pixels
        sq = np.where(valid, qf[:, pc] + g_flat[pc], 0.0)
        if a is None:
            r = rho[key].T  # (NE, tile)
            sp = r * np.maximum(1.0 - sq / np.maximum(r, 1e-30), 0.0)
        else:
            rh, inv = analytic_rho(key[None], e_b[:, None], inv_e[:, None], e2[:, None],
                                   zim[:, None], a.gamma)
            sp = rh * np.maximum(1.0 - sq * inv, 0.0)
        sp = np.where(valid, sp, 0.0)
        if scratch is not None:  # the block's slice: written by the staging, read by the walk
            scratch[t0 // tile, 0], scratch[t0 // tile, 1] = sq, sp
            sq, sp = scratch[t0 // tile, 0], scratch[t0 // tile, 1]
        sd = np.where(valid, phf[scat_row[:n_scat]][:, pc], 0.0)
        ss = np.where(valid, phf[rec_row[:n_rec]][:, pc], 0.0)
        # the warp-uniform test over the lanes' P pixels
        if a is None and tables.gid is not None:
            lanes = key.reshape(32, pixels)
            mixed = not np.all((lanes == lanes[:, :1]).all(1) & (lanes[:, 0] == lanes[0, 0]))
            base = key if mixed else np.full(tile, lanes[0, 0])
        else:
            base = key

        def scat_at(m, c, by_column=False):
            if a is None:
                v = scat_t[base, c, m] if by_column else scat[base, m, c]
                return v[:, 0], v[:, 1]
            ea, aa, eb, ab = scat_t[c, m] if by_column else scat[m, c]
            return np.maximum(ea - eb * key, 0.0), np.maximum(aa - ab * key, 0.0)

        def rec_at(i, c, by_column=False):
            if a is None:
                return rec_t[base, c, i] if by_column else rec[base, i, c]
            ra, rb = rec_t[c, i] if by_column else rec[i, c]
            return ra + rb * key

        def ph_of(row):  # a row's phonon values
            return np.where(valid, phf[row, pc], 0.0)

        def pair_at(tab, *at):  # a pair of a dense copy (qs, ps), each pixel's
            if a is None:
                v = tab[(base,) + at]
                return v[:, 0], v[:, 1]
            ea, aa, eb, ab = tab[at]
            return np.maximum(ea - eb * key, 0.0), np.maximum(aa - ab * key, 0.0)

        def affine_at(tab, *at):  # an entry of a dense copy (qr, pr), each pixel's
            if a is None:
                return tab[(base,) + at]
            ra, rb = tab[at]
            return ra + rb * key

        def row_walk(row):
            e0, e1 = row_ptr[row], row_ptr[row + 1]
            if e0 == e1:
                return  # untouched: stays as it is
            acc_a, acc_b = np.zeros(tile), np.zeros(tile)
            for code in row_code[e0:e1]:
                c = int(code) >> 1
                if int(code) & 1 == 0:
                    k = scat_k[c]
                    em, ab = np.zeros(tile), np.zeros(tile)
                    for m in range(k, ne):
                        ke, ka = scat_at(m, c, by_column=True)
                        em = em + ke * sq[m] * sp[m - k]
                        ab = ab + ka * sq[m - k] * sp[m]
                    acc_a, acc_b = acc_a + em, acc_b + (em - ab)
                else:
                    s = rec_s[c]
                    rc, pb = np.zeros(tile), np.zeros(tile)
                    for i in range(max(0, s - ne + 1), min(ne - 1, s) + 1):
                        kr = 0.5 * rec_at(i, c, by_column=True)
                        rc = rc + kr * sq[i] * sq[s - i]
                        pb = pb + kr * sp[i] * sp[s - i]
                    acc_a, acc_b = acc_a + rc, acc_b + (rc - pb)
            ph_out[row, p[valid]] = affine(phf[row, pc], acc_a, acc_b, dt)[valid]

        # the QP side, bin by bin
        for i in range(ne):
            loss, gain = np.zeros(tile), np.zeros(tile)
            for j in range(ne) if n_scat else ():  # the scattering pass
                if j == i:
                    continue
                e, ab = pair_at(qs, j, i)
                d = ph_of(k_row[abs(i - j)])
                if i > j:
                    loss = loss + e * (1.0 + d) * sp[j]
                    gain = gain + ab * d * sq[j]
                else:
                    loss = loss + ab * d * sp[j]
                    gain = gain + e * (1.0 + d) * sq[j]
            for j in range(ne) if n_rec else ():  # the recombination pass
                r, v = affine_at(qr, j, i), ph_of(s_row[i + j])
                loss = loss + r * (1.0 + v) * sq[j]
                gain = gain + r * v * sp[j]
            for c in x_scat:
                k, d = scat_k[c], sd[c]
                if k <= i:
                    e, ab = scat_at(i, c)
                    loss = loss + e * (1.0 + d) * sp[i - k]
                    gain = gain + ab * d * sq[i - k]
                if i + k < ne:
                    e, ab = scat_at(i + k, c)
                    loss = loss + ab * d * sp[i + k]
                    gain = gain + e * (1.0 + d) * sq[i + k]
            for c in x_rec:
                j = rec_s[c] - i
                if 0 <= j < ne:
                    r = rec_at(i, c)
                    loss = loss + r * (1.0 + ss[c]) * sq[j]
                    gain = gain + r * ss[c] * sp[j]
            q_out[i, p[valid]] = relax(sq[i], sp[i] * gain, loss, dt)[valid]
        if not update_phonons:
            continue
        for k in range(1, ne) if n_scat else ():
            if k_out[k] < 0:
                continue
            em, ab = np.zeros(tile), np.zeros(tile)
            for m in range(k, ne):
                ke, ka = pair_at(ps, m, k - 1)
                em = em + ke * sq[m] * sp[m - k]
                ab = ab + ka * sq[m - k] * sp[m]
            ph_out[k_out[k], p[valid]] = affine(phf[k_out[k], pc], em, em - ab, dt)[valid]
        for s in range(2 * ne - 1) if n_rec else ():
            if s_out[s] < 0:
                continue
            rc, pb = np.zeros(tile), np.zeros(tile)
            for i in range(max(0, s - ne + 1), min(ne - 1, s) + 1):
                kr = 0.5 * affine_at(pr, i, s)
                rc = rc + kr * sq[i] * sq[s - i]
                pb = pb + kr * sp[i] * sp[s - i]
            ph_out[s_out[s], p[valid]] = affine(phf[s_out[s], pc], rc, rc - pb, dt)[valid]
        for row in slow_rows:
            row_walk(row)
    return q_out.reshape(np.shape(q)), (ph_out.reshape(np.shape(ph)) if update_phonons else np.asarray(ph))
