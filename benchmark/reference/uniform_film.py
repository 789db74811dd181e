"""Plain reference of an energy-resolved run on a rectangular film with a uniform gap.

What it computes is the simulation the configuration states, worked out
again from the configuration alone (``physics``): quasiparticles n(E, x, y)
in NE bins and phonons n_ph(ω, x, y) on the pair-energy grid, stepped by
the Strang composition C(dt/2) [D(dt) C(dt)]^(L−1) D(dt) C(dt/2) over each
stored segment of L steps (the merged form: a step's trailing collision
half is fused with the next step's leading half), where

* C is the local Fischer–Catelani collision substep (scattering with the
  dynamic phonon occupation, recombination and pair breaking, the phonon
  update) with its exponential updates, after the generation increment
  dt·g(t) of a step has been added to every bin;
* D is one Peaceman–Rachford ADI step of Crank–Nicolson diffusion with
  D(E) = D₀·√(1 − (Δ/E)²) and reflective walls, each half solved exactly:
  the (I − a·L) systems of a line are the same for every line of a bin,
  so their inverse is formed once in float64 and applied as a matrix;

and each stored snapshot is reduced to the energy-integrated density
Σᵢ nᵢ·dE, the mass ∫ that dA and the phonon frame Σ_w n_ph,w·width_w.

The collision sums run over all pairs (i, j) of a pixel.  With a uniform
grid the phonon occupation a pair sees depends on i − j (scattering) or
i + j (recombination) only, and so do the kernels up to factors of Eᵢ
and Eⱼ; in float64 (the reference) each pair sum is then a convolution
over the bins, formed with FFTs (``_rates_fft``), and in a lower
precision (the control) the sums run over dense (pixels, NE, NE) pair
tensors (``_rates_dense``, whose occupation matrices are strided views of
one vector and whose ω rows are the sums along the pair matrix's
diagonals).  The two forms agree to rounding (the tests hold them to each
other).  The film is the mask's rectangle; cells outside it hold nothing
and stay empty, as the configuration's margin.

Everything runs in the ``dtype`` given on the ``device`` given, in blocks
of pixels; the time at which a step's generation is evaluated is formed
in the configuration's precision as t₀ + k·dt, the simulation's own rule.
Nothing of the program under test is imported.
"""

from __future__ import annotations

import numpy as np
import torch

from . import physics

_MU_FLOOR = 1e-14
_AFFINE_CLIP = 80.0
_RHO_FLOOR = 1e-30
#: elements of one (pixels, NE, NE) pair tensor in a block
_PAIR_BLOCK = 1 << 28


def _antidiagonal_sums(a: torch.Tensor) -> torch.Tensor:
    """(C, n, n) → (C, 2n − 1): out[:, m] = Σᵢ a[:, i, m − i]."""
    c, n, _ = a.shape
    padded = torch.nn.functional.pad(a, (0, n))  # (C, n, 2n)
    return padded.reshape(c, 2 * n * n)[:, : n * (2 * n - 1)].reshape(c, n, 2 * n - 1).sum(dim=1)


def _hankel(v: torch.Tensor, n: int) -> torch.Tensor:
    """(C, 2n − 1) → the (C, n, n) view h[:, i, j] = v[:, i + j]."""
    v = v.contiguous()
    return v.as_strided((v.shape[0], n, n), (v.stride(0), 1, 1))


class Film:
    """The tables of one configuration on one device and dtype."""

    def __init__(self, config: dict, mask: np.ndarray, device, dtype: torch.dtype):
        p = config["physics"]
        self.device, self.dtype = torch.device(device), dtype
        rows, cols = np.nonzero(mask)
        self.box = (rows.min(), rows.max() + 1, cols.min(), cols.max() + 1)
        r0, r1, c0, c1 = self.box
        if not mask[r0:r1, c0:c1].all() or int(mask.sum()) != (r1 - r0) * (c1 - c0):
            raise ValueError("this reference takes a film that is one full rectangle")
        self.mask = mask
        self.ny, self.nx = r1 - r0, c1 - c0
        self.dx = float(p["dx"])
        self.gap = gap = float(p["energy_gap"])
        e, de = physics.energy_grid(gap, p["energy_min_factor"], p["energy_max_factor"], p["num_energy_bins"])
        self.e, self.de, self.ne = e, de, e.size
        omega, idx_diff, idx_sum = physics.phonon_grid(e)
        self.omega, self.nw = omega, omega.size
        ne = self.ne
        i, j = np.meshgrid(np.arange(ne), np.arange(ne), indexing="ij")
        # ω index by |i − j| and by i + j; the grid is uniform, so a pair's
        # index is a function of one of the two alone
        self.dmap = np.array([idx_diff[k, 0] for k in range(ne)])
        self.smap = np.array([idx_sum[min(m, ne - 1), m - min(m, ne - 1)] for m in range(2 * ne - 1)])
        if not (np.array_equal(idx_diff, self.dmap[np.abs(i - j)]) and np.array_equal(idx_sum, self.smap[i + j])):
            raise ValueError("the pair-energy grid is not a function of i − j and i + j on this grid")
        tau_s = float(p.get("tau_s") or p["tau_0"])
        tau_r = float(p.get("tau_r") or p["tau_0"])
        self.scatter, self.recombine = bool(p["enable_scattering"]), bool(p["enable_recombination"])
        rho = physics.bcs_dos(e, gap)
        ks = de * physics.scattering_kernel(e, gap, tau_s, p["T_c"])
        kr = de * physics.recombination_kernel(e, gap, tau_r, p["T_c"])
        t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=self.device)
        self.rho = t(rho)
        self.ks_flip = t(ks[:, ::-1])  # ks[i, n − 1 − j']: the scattering pairs in flipped columns
        self.ks_emit = t(ks * (i > j))  # the constant part of emission: ks·1 for Eᵢ > Eⱼ
        self.kr, self.kr2 = t(kr), t(2.0 * kr)
        self.dmap_t = torch.as_tensor(self.dmap, device=self.device)
        self.smap_t = torch.as_tensor(self.smap, device=self.device)
        # diffusion: the exact inverse of each bin's implicit half, (NE, n, n) per direction
        alpha = 0.5 * float(p["dt"])
        scale = alpha * physics.diffusion_of_energy(p["diffusion_coefficient"], e, gap) / float(p["dx"]) ** 2
        self.a_s = t(scale)[:, None, None]
        self.inv_y = self._inverses(scale, self.ny)
        self.inv_x = self.inv_y if self.nx == self.ny else self._inverses(scale, self.nx)
        self.block = max(1, _PAIR_BLOCK // (ne * ne))
        # the FFT form: a_s·(i − j)² and a_r·σ²_{i+j} (the kernels' own arithmetic, see
        # physics), and a transform length that holds a linear convolution of 2·NE − 1 terms
        ktc = physics.K_B_UEV_PER_K * float(p["T_c"])
        if not np.min(np.outer(e, e)) > gap**2:
            raise ValueError("the FFT form takes bins above the gap only")
        self.a_s_coef = de**3 / (ktc**3 * tau_s)
        self.a_r_coef = de / (ktc**3 * tau_r)
        self.fft_len = 1 << int(np.ceil(np.log2(2 * ne)))
        self.u = t(1.0 / e)
        self.k2 = t(np.arange(ne, dtype=np.float64) ** 2)
        m = np.arange(2 * ne - 1)
        self.sigma2 = t((e[np.minimum(m, ne - 1)] + e[m - np.minimum(m, ne - 1)]) ** 2)
        self.widths = physics.bin_widths(omega)

    def _inverses(self, scale: np.ndarray, n: int) -> torch.Tensor:
        lap = np.diag(np.full(n, -2.0)) + np.diag(np.ones(n - 1), 1) + np.diag(np.ones(n - 1), -1)
        lap[0, 0] = lap[-1, -1] = -1.0  # reflective walls: no flux through the end faces
        eye = torch.eye(n, dtype=torch.float64, device=self.device)
        lap_t = torch.as_tensor(lap, device=self.device)
        s = torch.as_tensor(scale, device=self.device)[:, None, None]
        return torch.linalg.inv(eye - s * lap_t).to(self.dtype)

    # --- diffusion -------------------------------------------------------------
    @staticmethod
    def _lap(u: torch.Tensor, dim: int) -> torch.Tensor:
        """The reflective-wall Laplacian (unit spacing) of u along ``dim``."""
        out = -2.0 * u
        n = u.shape[dim]
        out.narrow(dim, 1, n - 1).add_(u.narrow(dim, 0, n - 1))
        out.narrow(dim, 0, n - 1).add_(u.narrow(dim, 1, n - 1))
        out.narrow(dim, 0, 1).add_(u.narrow(dim, 0, 1))
        out.narrow(dim, n - 1, 1).add_(u.narrow(dim, n - 1, 1))
        return out

    def diffuse(self, q: torch.Tensor) -> torch.Tensor:
        """One ADI step: x implicit, then y implicit."""
        rhs = q + self.a_s * self._lap(q, 1)
        half = torch.matmul(rhs, self.inv_x.transpose(1, 2))
        rhs = half + self.a_s * self._lap(half, 2)
        return torch.matmul(self.inv_y, rhs)

    # --- collisions ------------------------------------------------------------
    def collide(self, q: torch.Tensor, ph: torch.Tensor, dt: float, gen: float) -> tuple[torch.Tensor, torch.Tensor]:
        """One collision substep of ``dt`` on (NE, ny, nx) / (NW, ny, nx), after q += gen."""
        ne, nw = self.ne, self.nw
        shape_q, shape_p = q.shape, ph.shape
        qf = (q + gen if gen else q).reshape(ne, -1)
        pf = ph.reshape(nw, -1)
        q_out, p_out = torch.empty_like(qf), torch.empty_like(pf)
        for lo in range(0, qf.shape[1], self.block):
            hi = min(lo + self.block, qf.shape[1])
            a, b = self._pixels(qf[:, lo:hi].T, pf[:, lo:hi].T, dt)
            q_out[:, lo:hi], p_out[:, lo:hi] = a.T, b.T
        return q_out.reshape(shape_q), p_out.reshape(shape_p)

    def _pixels(self, q: torch.Tensor, n: torch.Tensor, dt: float):
        """The substep of a (C, NE) / (C, NW) block of pixels."""
        q = q.contiguous()
        n = n.contiguous()
        part = self.rho * torch.clamp(1.0 - q / torch.clamp(self.rho, min=_RHO_FLOOR), min=0.0)  # ρ(1 − f)
        rates = self._rates_fft if self.dtype == torch.float64 else self._rates_dense
        gain, loss, a_ph, b_ph = rates(q, n, part)
        # quasiparticles: dn/dt = gain − loss·n, exponential update
        mu = torch.clamp(loss, min=0.0)
        p_term = torch.clamp(gain + (mu - loss) * q, min=0.0)
        coeff = torch.where(mu < _MU_FLOOR, dt, -torch.expm1(-mu * dt) / torch.clamp(mu, min=_MU_FLOOR))
        q_new = torch.clamp(torch.exp(-mu * dt) * q + coeff * p_term, min=0.0)
        # phonons: y' = a + b·y with frozen coefficients, solved exactly
        x = torch.clamp(b_ph * dt, -_AFFINE_CLIP, _AFFINE_CLIP)
        tiny = torch.abs(b_ph) < _MU_FLOOR
        coeff = torch.where(tiny, dt, torch.expm1(x) / torch.where(tiny, 1.0, b_ph))
        n_new = torch.clamp(torch.exp(x) * n + coeff * a_ph, min=0.0)
        return q_new, n_new

    def _rates_dense(self, q, n, part):
        """(gain, loss, a, b) of a block from its (C, NE, NE) pair tensors."""
        ne = self.ne
        q_flip, part_flip = q.flip(1), part.flip(1)
        gain = torch.zeros_like(q)
        loss = torch.zeros_like(q)
        a_ph = torch.zeros_like(n)
        b_ph = torch.zeros_like(n)
        if self.scatter:
            nd = n[:, self.dmap_t]  # n_ph at ω = |i − j|·dE, (C, NE)
            sym = torch.cat([nd[:, 1:].flip(1), nd], dim=1)  # sym[:, n − 1 + k] = nd[:, |k|]
            # pair (i, j) in flipped columns j' = n − 1 − j sees sym[i + j'] = n_ph(|Eᵢ − Eⱼ|)
            w = self.ks_flip * _hankel(sym, ne)
            dyn = torch.bmm(w, torch.stack([part_flip, q_flip], dim=2))
            loss += part @ self.ks_emit.T + dyn[:, :, 0]
            gain += part * (q @ self.ks_emit + dyn[:, :, 1])
            # phonon rows: emission (i > j) and absorption (i < j) of q_i·ks·ρ(1 − f)_j
            rows = _antidiagonal_sums(q[:, :, None] * self.ks_flip * part_flip[:, None, :])
            emit, absorb = rows[:, ne:], rows[:, : ne - 1].flip(1)  # offsets 1 … n − 1
            a_ph.index_add_(1, self.dmap_t[1:], emit)
            b_ph.index_add_(1, self.dmap_t[1:], emit - absorb)
        if self.recombine:
            v = self.kr2 * _hankel(n[:, self.smap_t], ne)  # 2dE·K^r₀·n_ph(Eᵢ + Eⱼ)
            dyn = torch.bmm(v, torch.stack([q, part], dim=2))
            loss += q @ self.kr2.T + dyn[:, :, 0]
            gain += part * dyn[:, :, 1]
            rec = _antidiagonal_sums(q[:, :, None] * self.kr * q[:, None, :])
            brk = _antidiagonal_sums(part[:, :, None] * self.kr * part[:, None, :])
            a_ph.index_add_(1, self.smap_t, rec)
            b_ph.index_add_(1, self.smap_t, rec - brk)
        return gain, loss, a_ph, b_ph

    def _rates_fft(self, q, n, part):
        """(gain, loss, a, b) of a block, each pair sum as a convolution over the bins.

        On the uniform grid Eᵢ − Eⱼ = (i − j)·dE and Eᵢ + Eⱼ = σ_{i+j}, so
        dE·K^s₀ = a_s·(i − j)²·(1 − Δ²uᵢuⱼ) and dE·K^r₀ = a_r·σ²_{i+j}·(1 + Δ²uᵢuⱼ)
        with u = 1/E: every sum over j of a pair term with the pair's
        phonon occupation (a function of i − j or i + j) is a sum of
        convolutions or correlations of per-bin vectors, formed with real
        FFTs of a length that holds them without wrapping."""
        L, ne, d2 = self.fft_len, self.ne, self.gap**2
        u = self.u
        fq, fp, fuq, fup = (torch.fft.rfft(x, n=L) for x in (q, part, u * q, u * part))
        inv = lambda x: torch.fft.irfft(x, n=L)
        gain = torch.zeros_like(q)
        loss = torch.zeros_like(q)
        a_ph = torch.zeros_like(n)
        b_ph = torch.zeros_like(n)
        if self.scatter:
            g = torch.zeros((q.shape[0], L), dtype=q.dtype, device=q.device)
            g[:, :ne] = self.k2 * n[:, self.dmap_t]  # k²·n_ph(k·dE) at ±k
            g[:, L - ne + 1:] = g[:, 1:ne].flip(1)
            fg = torch.fft.rfft(g)
            conv = lambda fx: inv(fg * fx)[:, :ne]  # Σⱼ g_{i−j} xⱼ
            loss += part @ self.ks_emit.T + self.a_s_coef * (conv(fp) - d2 * u * conv(fup))
            gain += part * (q @ self.ks_emit + self.a_s_coef * (conv(fq) - d2 * u * conv(fuq)))
            rows = inv(fq * fp.conj()) - d2 * inv(fuq * fup.conj())  # Σᵢ qᵢ·ρ(1 − f)_{i−k} at lag k
            emit = self.a_s_coef * self.k2[1:] * rows[:, 1:ne]
            absorb = self.a_s_coef * self.k2[1:] * rows[:, L - ne + 1:].flip(1)
            a_ph.index_add_(1, self.dmap_t[1:], emit)
            b_ph.index_add_(1, self.dmap_t[1:], emit - absorb)
        if self.recombine:
            h = torch.zeros((q.shape[0], L), dtype=q.dtype, device=q.device)
            h[:, : 2 * ne - 1] = self.sigma2 * n[:, self.smap_t]  # σ²_m·n_ph(σ_m)
            fh = torch.fft.rfft(h)
            corr = lambda fx: inv(fh * fx.conj())[:, :ne]  # Σⱼ h_{i+j} xⱼ
            loss += q @ self.kr2.T + 2.0 * self.a_r_coef * (corr(fq) + d2 * u * corr(fuq))
            gain += part * 2.0 * self.a_r_coef * (corr(fp) + d2 * u * corr(fup))
            m = 2 * ne - 1
            rec = self.a_r_coef * self.sigma2 * (inv(fq * fq) + d2 * inv(fuq * fuq))[:, :m]
            brk = self.a_r_coef * self.sigma2 * (inv(fp * fp) + d2 * inv(fup * fup))[:, :m]
            a_ph.index_add_(1, self.smap_t, rec)
            b_ph.index_add_(1, self.smap_t, rec - brk)
        return gain, loss, a_ph, b_ph

    # --- a run -------------------------------------------------------------------
    def initial_state(self, field: np.ndarray, bath: float) -> tuple[torch.Tensor, torch.Tensor]:
        """Quasiparticles: the DOS weights (normalised to ∫ = 1) ⊗ the field; phonons at the bath."""
        r0, r1, c0, c1 = self.box
        rho = physics.bcs_dos(self.e, self.gap)
        weights = rho / (rho.sum() * self.de)
        t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=self.dtype, device=self.device)
        spatial = t(field[r0:r1, c0:c1])
        q = t(weights)[:, None, None] * spatial[None]
        occ = physics.bose_einstein(self.omega, bath)
        ph = t(occ)[:, None, None] * torch.ones((1, self.ny, self.nx), dtype=self.dtype, device=self.device)
        return q, ph

    def snapshot(self, q: torch.Tensor, ph: torch.Tensor) -> tuple[np.ndarray, float, np.ndarray]:
        """(integrated frame with NaN off the film, mass, phonon frame), reduced in float64."""
        r0, r1, c0, c1 = self.box
        q64, ph64 = q.double(), ph.double()
        integrated = q64.sum(dim=0) * self.de
        frame = np.full(self.mask.shape, np.nan)
        frame[r0:r1, c0:c1] = integrated.cpu().numpy()
        mass = float(integrated.sum()) * self.dx**2
        widths = torch.as_tensor(self.widths, dtype=torch.float64, device=self.device)[:, None, None]
        phonons = np.full(self.mask.shape, np.nan)
        phonons[r0:r1, c0:c1] = (ph64 * widths).sum(dim=0).cpu().numpy()
        return frame, mass, phonons


def simulate(config: dict, mask: np.ndarray, field: np.ndarray, steps: int, store_every: int,
             device, dtype: torch.dtype) -> dict:
    """The reference run of one call: times, frames, mass and phonon frames at each stored step."""
    p = config["physics"]
    film = Film(config, mask, device, dtype)
    gen = p.get("external_generation") or {"mode": "none"}
    dt = float(p["dt"])
    # a step's time is formed in the configuration's precision, as the simulation forms it
    tf = np.float64 if config["dtype"] == "float64" else np.float32
    start = tf(gen.get("pulse_start", 0.0))
    end = tf(float(gen.get("pulse_start", 0.0)) + float(gen.get("pulse_duration", 0.0)))

    def increment(t_step) -> float:
        """dt·g(t) of the step whose time, in the configuration's precision, is ``t_step``."""
        if gen["mode"] == "pulse":
            amp = tf(gen["pulse_rate"]) if (t_step >= start and t_step < end) else tf(0.0)
        elif gen["mode"] == "constant":
            amp = tf(gen["rate"])
        else:
            amp = tf(0.0)
        return float(tf(dt) * amp)

    if steps % store_every:
        raise ValueError("the reference takes calls of whole stored segments")
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    with torch.no_grad():
        q, ph = film.initial_state(field, float(p["bath_temperature"]))
        out = {"times": [0.0], "frames": [], "mass": [], "phonon_frames": []}

        def store(q, ph):
            frame, mass, phon = film.snapshot(q, ph)
            out["frames"].append(frame)
            out["mass"].append(mass)
            out["phonon_frames"].append(phon)

        store(q, ph)
        t = 0.0
        for _ in range(steps // store_every):
            times = [tf(t) + tf(k) * tf(dt) for k in range(store_every)]
            q, ph = film.collide(q, ph, 0.5 * dt, increment(times[0]))
            for k in range(store_every - 1):
                q = film.diffuse(q)
                q, ph = film.collide(q, ph, dt, increment(times[k + 1]))
            q = film.diffuse(q)
            q, ph = film.collide(q, ph, 0.5 * dt, 0.0)
            for _ in range(store_every):
                t += dt
            out["times"].append(t)
            store(q, ph)
    return out
