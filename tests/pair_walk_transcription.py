"""``qpsim_tpu_torch/csrc/collisions.cu`` (the pair walk of K3 and K4) in NumPy.

The kernel's walk on the wrapper's real tables
(:class:`qpsim_tpu_torch.ops.collisions_cuda.CollisionKernelTables`): q (+
dt·g), partner, gain and loss over the walk's ``nb`` bins (zeros past NE);
scattering diagonals k = 1 … nb − 1, then recombination anti-diagonals
s = 0 … 2nb − 2, each diagonal's groups in table order; per group its row
value, its entries in order (pairs (j + k, j); pairs (s − j, j) with
i > j, then the diagonal pair), the creation and destruction sums added
into the row's rates a and b (zero for a row no group reaches); then the
QP update and every row's update.  Each pixel's walk is
vectorised over pixels, which changes no sum's order.  ``dtype`` float32
runs it in single precision (NumPy rounds each product; the card may fuse
a multiply and an add).  Imported by the CPU tests of K3 and K4.
"""

import numpy as np

from column_walk_transcription import affine, analytic_rho, relax


def _np(t):
    return None if t is None else t.detach().cpu().numpy()


def transcribe(plan, tables, q, ph, gen, dt, analytic=None, dtype=np.float64):
    """One substep of the kernel: (q_out, ph_out) shaped as ``q``, ``ph``."""
    ne, nw, nb = plan.num_energy_bins, plan.num_omega, tables.nb
    one, half = dtype(1), dtype(0.5)
    dt = dtype(dt)
    qf = q.reshape(ne, -1).astype(dtype)
    phf = ph.reshape(nw, -1).astype(dtype)
    n_pix = qf.shape[1]
    if gen is not None:
        qf = qf + gen.reshape(1, -1).astype(dtype)
    tab = lambda t: None if t is None else _np(t).astype(dtype)
    scat, rec = tab(tables.scat), tab(tables.rec)
    if analytic is None:  # per-gap tables, each pixel's by its gap id
        gid = np.zeros(n_pix, np.int64) if plan.gap_id is None else _np(plan.gap_id).astype(np.int64)
        rho = tab(tables.rho).reshape(-1, nb)[gid].T  # (nb, P)
        pairs = lambda t: None if t is None else np.moveaxis(t[gid], 0, -1)  # (entries, 2, P)
        scat, rec = pairs(scat), pairs(rec)
        ks = lambda e: (scat[e, 0], scat[e, 1])
        kr = lambda e: (rec[e, 0], rec[e, 1])
        partner = lambda i, qi: rho[i] * np.maximum(one - qi / np.maximum(rho[i], dtype(1e-30)), 0)
    else:  # K4: constants affine in Δ², ρ in closed form
        d2 = _np(analytic.g2).astype(dtype)
        e, inv_e, e2, zim = (_np(v).astype(dtype) for v in (analytic.E, analytic.inv_E,
                                                            analytic.e2, analytic.zi))
        gamma = dtype(analytic.gamma)

        def partner(i, qi):
            rho_i, inv_i = analytic_rho(d2, e[i], inv_e[i], e2[i], zim[i], gamma)
            return rho_i * np.maximum(one - qi * inv_i, 0)

        ks = lambda x: (np.maximum(scat[x, 0] - scat[x, 1] * d2, 0),
                        np.maximum(scat[x, 2] - scat[x, 3] * d2, 0))
        kr = lambda x: (rec[x, 0] + rec[x, 1] * d2, rec[x, 2] + rec[x, 3] * d2)
    qv = np.zeros((nb, n_pix), dtype)
    pv = np.zeros((nb, n_pix), dtype)
    for i in range(ne):
        qv[i] = qf[i]
        pv[i] = partner(i, qf[i])
    gain = np.zeros((nb, n_pix), dtype)
    loss = np.zeros((nb, n_pix), dtype)
    a_row = np.zeros((nw, n_pix), dtype)
    b_row = np.zeros((nw, n_pix), dtype)

    def finish(meta, pos, neg):
        a_row[meta[0]] += pos
        b_row[meta[0]] += pos - neg

    s_ptr, r_ptr, s_meta, r_meta = (_np(t).reshape(-1, *shape) for t, shape in (
        (tables.s_ptr, ()), (tables.r_ptr, ()), (tables.s_meta, (2,)), (tables.r_meta, (2,))))
    for k in range(1, nb):
        for g in range(s_ptr[k], s_ptr[k + 1]):
            m = s_meta[g]
            n = phf[m[0]]
            n1 = one + n
            pos = neg = np.zeros(n_pix, dtype)
            for j in range(nb - k):
                i = j + k
                ke, ka = ks(m[1] + j)
                we, wa = ke * n1, ka * n
                loss[i] += we * pv[j]
                gain[j] += we * qv[i]
                loss[j] += wa * pv[i]
                gain[i] += wa * qv[j]
                pos = pos + (qv[i] * ke) * pv[j]
                neg = neg + (qv[j] * ka) * pv[i]
            finish(m, pos, neg)
    for s in range(2 * nb - 1):
        j0 = max(0, s - nb + 1)
        for g in range(r_ptr[s], r_ptr[s + 1]):
            m = r_meta[g]
            sv = phf[m[0]]
            s1 = one + sv
            pos = neg = np.zeros(n_pix, dtype)
            j = j0
            while 2 * j < s:
                i = s - j
                rij, rji = kr(m[1] + (j - j0))
                loss[i] += (rij * s1) * qv[j]
                gain[i] += (rij * sv) * pv[j]
                loss[j] += (rji * s1) * qv[i]
                gain[j] += (rji * sv) * pv[i]
                h = half * (rij + rji)
                pos = pos + h * (qv[i] * qv[j])
                neg = neg + h * (pv[i] * pv[j])
                j += 1
            if s % 2 == 0:
                i = s // 2
                rii, _ = kr(m[1] + (i - j0))
                loss[i] += (rii * s1) * qv[i]
                gain[i] += (rii * sv) * pv[i]
                h = half * rii
                pos = pos + (qv[i] * h) * qv[i]
                neg = neg + (pv[i] * h) * pv[i]
            finish(m, pos, neg)
    q_out = np.stack([relax(qv[i], pv[i] * gain[i], loss[i], dt) for i in range(ne)])
    if not plan.update_phonons:
        return q_out.reshape(q.shape), ph
    ph_out = affine(phf, a_row, b_row, dt)
    return q_out.reshape(q.shape), ph_out.reshape(ph.shape)
