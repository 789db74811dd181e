"""Gap-asymmetric junction quasiparticle–qubit rate model (Marchegiani 2025).

Implements the coupled qubit–quasiparticle rate equations of Marchegiani &
Catelani, "Nonequilibrium regimes for quasiparticles in superconducting
qubits with gap-asymmetric junctions", Commun. Phys. 8, 120 (2025) — the
second entry in the reference repo's own "Not yet Implemented" queue; the reference has
no counterpart.

The model (main-text Eqs. 3–6): a transmon with a gap-asymmetric Josephson
junction (Δ_L > Δ_R) carries three quasiparticle populations —

* ``x_L``   — the high-gap electrode,
* ``x_Rgt`` — low-gap electrode, energies ABOVE Δ_L (can tunnel freely),
* ``x_Rlt`` — low-gap electrode, energies BELOW Δ_L (trapped; tunneling to
  L requires absorbing the qubit energy ω₁₀),

normalized per electrode as x_α = n_qp/(2ν₀Δ_α V) (the paper's choice, so
N_qp ∝ x_L + γ·(x_Rgt + x_Rlt) with γ = Δ_R/Δ_L), coupled to the qubit
level populations (p₀, p₁).  Processes:

* generation by pair-breaking photons (one QP in each electrode per
  absorbed photon; the experimentally anchored knob is the photon-assisted
  parity-switching rate γ^ph — the paper uses γ^ph₀₀ = 300 Hz) and by
  thermal phonons (main-text closed forms, valid for T ≪ Δ):
  g^pn_L = 2π r_L (T/Δ_L) e^{−2Δ_L/T},
  g^pn_R≷ = 2π r_R (T/Δ_R) e^{−2Δ_R/T} · erfc/erf(√(δΔ/T)),
* recombination r_α x_α² and the cross channel r_<> x_R< x_R>,
* intra-R relaxation/excitation x_Rgt/τ_R ↔ x_Rlt/τ_E across Δ_L,
* single-quasiparticle tunneling through the junction, each event flipping
  the charge parity and optionally the qubit state — rates Γ^α_{if} for a
  quasiparticle initially in α ∈ {L, R>, R<} with qubit transition i→f.
  Conservation fixes the cross-normalization: a transfer leaving L at rate
  Γ x_L arrives in R as Γ x_L/γ (and vice versa with γ) so pure tunneling
  conserves N_qp exactly.  Per the paper's ansatz Γ^{R<}_{00/11/01} = 0
  (trapped quasiparticles can only leave by absorbing ω₁₀).

The microscopic transmon expressions for Γ^α_{if} live in the paper's
Supplementary Note III (not shipped with the reference); here they are
explicit inputs, with :func:`detailed_balance_rates` constructing the
R-side rates from the L-side ones so that every tunneling channel
separately satisfies detailed balance at temperature T — with photons off
the model then relaxes to full equilibrium (μ = 0), which is the paper's
regime (iv) and this module's correctness gate.

Everything is torch, in float64: steady states come from a damped Newton
solve (its Jacobian by autograd), sweeps solve every
temperature in one batched iteration, and the effective chemical potentials
μ_α = T·ln(x_α/x_α^eq) reproduce the paper's regime classification —
(i) nonequilibrium (μ_R> ≠ μ_R<), (ii) local quasiequilibrium
(μ_R> = μ_R< ≠ μ_L), (iii) global quasiequilibrium (all equal, ≠ 0),
(iv) full equilibrium (all ≈ 0).

Units: µeV, ns, K (converted via K_B_UEV_PER_K).  1 Hz = 1e-9 /ns.

The port of ``qpsim_tpu.qubit``: the same functions and dataclasses
(``tests/test_torch_qubit.py`` holds them to the JAX package).  A
temperature given as a Python number lives on the CPU, a tensor on its
device; the entry points (:func:`evolve`, :func:`steady_state`,
:func:`temperature_sweep`) run on ``device`` ("cuda" unless the caller
asks for "cpu", and then never quietly on the CPU).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

import numpy as np
import torch

from .constants import K_B_UEV_PER_K

__all__ = [
    "JunctionParams",
    "TunnelingRates",
    "detailed_balance_rates",
    "thermal_densities",
    "thermal_generation",
    "junction_rhs",
    "evolve",
    "steady_state",
    "chemical_potentials",
    "classify_regime",
    "parity_switching_rate",
    "qp_relaxation_rate",
    "temperature_sweep",
    "REGIMES",
]

_F64 = torch.float64
_SQRT = torch.sqrt
_X_FLOOR = 1e-300


def _kelvin(T_K, device=None) -> torch.Tensor:
    """T as a float64 tensor: on ``device`` if given, else where T lies (a
    Python number on the CPU)."""
    if device is None:
        device = T_K.device if isinstance(T_K, torch.Tensor) else "cpu"
    return torch.as_tensor(T_K, dtype=_F64, device=device)


def _thermal_ueV(T_K) -> torch.Tensor:
    """k_B·T in µeV, floored at 1e-12."""
    return torch.clamp(_kelvin(T_K) * K_B_UEV_PER_K, min=1e-12)


@dataclass(frozen=True)
class TunnelingRates:
    """Single-quasiparticle tunneling EVENT rates Γ̃^α_{if} (1/ns per unit x).

    These are the paper's tilde rates — the ones entering the qubit
    equation directly as Γ̃·x (events per ns); the density equations
    divide by the Cooper-pair number of the LOW-gap electrode
    (N_cpR = γ·cooper_pairs_L), the paper's common normalizer for all α.
    ``l_if`` is the rate for a quasiparticle in the HIGH-gap electrode
    tunneling right with qubit transition i→f; ``rgt_if`` / ``rlt_10``
    for quasiparticles in the low-gap electrode above / below Δ_L
    tunneling left.  Γ^{R<}_{00/11/01} are identically zero (paper
    ansatz).  ``phi`` is the paper's Φ ∈ [0, 1]: the fraction of L→R
    qubit-excitation (0→1) tunnelers landing ABOVE Δ_L.
    """

    l_00: float = 0.0
    l_11: float = 0.0
    l_10: float = 0.0
    l_01: float = 0.0
    rgt_00: float = 0.0
    rgt_11: float = 0.0
    rgt_10: float = 0.0
    rgt_01: float = 0.0
    rlt_10: float = 0.0
    phi: float = 0.0


@dataclass(frozen=True)
class JunctionParams:
    """All parameters of the junction–qubit system (µeV / ns / K)."""

    gap_L: float = 190.0             # Δ_L (µeV)
    gap_R: float = 180.0             # Δ_R (µeV); δΔ = Δ_L − Δ_R > 0
    omega_10: float = 20.0           # qubit transition energy (µeV)
    r_L: float = 1.0 / 440.0         # recombination prefactors (1/ns per x²)
    r_Rgt: float = 1.0 / 440.0
    r_Rlt: float = 1.0 / 440.0
    # mixed R<×R> channel: with ẋ_tot = −r·x_tot² for the whole electrode,
    # random pairing gives ẋ_i = −r·x_i·(x_< + x_>), i.e. r_cross = r_R —
    # then the paper's erf/erfc generation split balances recombination
    # per sub-population exactly (not just in total)
    r_cross: float = 1.0 / 440.0
    tau_R: float = 1.0e3             # R> → R< relaxation time (ns)
    tau_E: float | None = None       # R< → R> excitation; None = detailed balance
    rates: TunnelingRates = field(default_factory=TunnelingRates)
    gamma_ph: float = 3.0e-7         # photon-assisted parity rate γ^ph (1/ns; 300 Hz)
    cooper_pairs_L: float = 1.0e6    # N_cp = 2ν₀Δ_L·V — photon-rate normalizer
    photon_split_gt: float = 1.0     # fraction of R-side photon QPs above Δ_L
    qubit_gamma_down: float = 1.0e-4 # non-QP (bath) qubit relaxation Γ^{ee}_{10} (1/ns)
    generation: str = "paper"        # "paper" (main-text g^pn) | "balanced" (exact closure)

    @property
    def gamma(self) -> float:
        """γ = Δ_R/Δ_L, the paper's normalization ratio."""
        return self.gap_R / self.gap_L

    @property
    def delta_gap(self) -> float:
        return self.gap_L - self.gap_R

    def validate(self) -> None:
        if not (self.gap_L >= self.gap_R > 0):
            raise ValueError("need gap_L >= gap_R > 0 (L is the high-gap electrode)")
        if self.omega_10 <= 0:
            raise ValueError("omega_10 must be positive")
        if not 0.0 <= self.photon_split_gt <= 1.0:
            raise ValueError("photon_split_gt must lie in [0, 1]")
        if not 0.0 <= self.rates.phi <= 1.0:
            raise ValueError("phi must lie in [0, 1]")
        if self.generation not in ("paper", "balanced"):
            raise ValueError("generation must be 'paper' or 'balanced'")


def thermal_densities(p: JunctionParams, T_K):
    """Equilibrium normalized densities (x_L, x_Rgt, x_Rlt) at bath T.

    Maxwell–Boltzmann tail of the BCS spectrum (T ≪ Δ, the domain of the
    paper's main-text g^pn forms): x^eq(Δ) = √(2πT/Δ)·e^{−Δ/T}; the
    R-electrode population splits at Δ_L with the incomplete-gamma
    fraction erf(√(δΔ/T)) below.
    """
    t = _thermal_ueV(T_K)
    x_l = _SQRT(2.0 * np.pi * t / p.gap_L) * torch.exp(-p.gap_L / t)
    x_r = _SQRT(2.0 * np.pi * t / p.gap_R) * torch.exp(-p.gap_R / t)
    frac_lt = torch.erf(_SQRT(p.delta_gap / t))
    return x_l, x_r * (1.0 - frac_lt), x_r * frac_lt


def thermal_generation(p: JunctionParams, T_K, *, balanced: bool = False):
    """Thermal-phonon generation rates (g_L, g_Rgt, g_Rlt) in x/ns.

    ``balanced=False`` — the paper's main-text closed forms (g = r·x_eq²
    split by erf/erfc).  ``balanced=True`` — exact-closure rates that zero
    every recombination channel at ``thermal_densities`` (so the
    photons-off steady state is exactly thermal; used by the equilibrium
    gate — the two coincide to O(erf·erfc) at T ≪ δΔ).
    """
    xl, xgt, xlt = thermal_densities(p, T_K)
    if balanced:
        g_l = p.r_L * xl * xl
        g_gt = p.r_Rgt * xgt * xgt + p.r_cross * xgt * xlt
        g_lt = p.r_Rlt * xlt * xlt + p.r_cross * xgt * xlt
        return g_l, g_gt, g_lt
    t = _thermal_ueV(T_K)
    g_l = 2.0 * np.pi * p.r_L * (t / p.gap_L) * torch.exp(-2.0 * p.gap_L / t)
    g_r = 2.0 * np.pi * p.r_Rlt * (t / p.gap_R) * torch.exp(-2.0 * p.gap_R / t)
    frac_lt = torch.erf(_SQRT(p.delta_gap / t))
    return g_l, g_r * (1.0 - frac_lt), g_r * frac_lt


def detailed_balance_rates(
    p: JunctionParams,
    T_K: float,
    *,
    l_00: float,
    l_11: float,
    l_10: float,
    l_01: float,
    phi: float | None = None,
) -> TunnelingRates:
    """R-side tunneling rates from the L-side ones via detailed balance.

    Each microscopic tunneling channel is balanced separately at
    temperature T (forward flux = reverse flux with thermal densities and
    thermal qubit populations), so with photons off the full system has
    the thermal state as a stationary point — the construction used by
    the equilibrium test and a physically consistent default when the
    supplementary transmon expressions are not evaluated.
    """
    t = float(T_K) * K_B_UEV_PER_K
    if phi is None:
        phi = float(np.exp(-min(p.delta_gap, p.omega_10) / max(t, 1e-12)))
        phi = min(phi, 1.0)
    xl, xgt, xlt = (float(v) for v in thermal_densities(p, T_K))
    boltz = float(np.exp(-p.omega_10 / max(t, 1e-12)))
    xgt = max(xgt, _X_FLOOR)
    xlt = max(xlt, _X_FLOOR)
    # event-rate balance per channel (the tilde rates share one
    # normalizer, so the densities' γ factors cancel out of the balance)
    return TunnelingRates(
        l_00=l_00,
        l_11=l_11,
        l_10=l_10,
        l_01=l_01,
        # parity-preserving channels: Γ̃^{R>}_{ii}·x_gt = Γ̃^L_{ii}·x_l
        rgt_00=l_00 * xl / xgt,
        rgt_11=l_11 * xl / xgt,
        # L(1→0) ↔ R>(0→1):  Γ̃^{R>}_{01} p0 x_gt = Γ̃^L_{10} p1 x_l
        rgt_01=l_10 * boltz * xl / xgt,
        # L(0→1, above) ↔ R>(1→0)
        rgt_10=phi * l_01 / boltz * xl / xgt,
        # L(0→1, below) ↔ R<(1→0)
        rlt_10=(1.0 - phi) * l_01 / boltz * xl / xlt,
        phi=phi,
    )


def _tau_e_inv(p: JunctionParams, T_K):
    """R< → R> excitation rate; detailed balance against 1/τ_R by default
    (exponentially small in δΔ/T, as the paper notes)."""
    if p.tau_E is not None:
        return 1.0 / p.tau_E
    _, xgt, xlt = thermal_densities(p, T_K)
    return (1.0 / p.tau_R) * xgt / torch.clamp(xlt, min=_X_FLOOR)


def junction_rhs(p: JunctionParams, T_K, state, *, photons_on: bool = True):
    """d/dt of ``state = (x_L, x_Rgt, x_Rlt, p1)`` — Eqs. (3)–(6).

    ``photons_on=False`` removes the photon-assisted generation and parity
    channels (the thermal-relaxation limit used by the equilibrium gate).
    """
    x_l, x_gt, x_lt, p1 = state
    p0 = 1.0 - p1
    r = p.rates
    g = p.gamma
    t = _kelvin(T_K) * K_B_UEV_PER_K

    g_l, g_gt, g_lt = thermal_generation(
        p, T_K, balanced=(p.generation == "balanced")
    )
    if photons_on:
        # one QP in each electrode per photon-assisted event (rate γ^ph,
        # weakly state-dependent in the paper; the anchored observable is
        # the ground-state parity rate, so we scale by the parity traffic)
        g_ph_l = p.gamma_ph / p.cooper_pairs_L
        g_ph_r = g_ph_l / g
        g_l = g_l + g_ph_l
        g_gt = g_gt + p.photon_split_gt * g_ph_r
        g_lt = g_lt + (1.0 - p.photon_split_gt) * g_ph_r

    # tunneling EVENT rates per unit N_cpR (tilde rates × x, shared
    # normalizer N_cpR = γ·N_cpL): one event moves one quasiparticle, so
    # the R densities change by ±event/N_cpR and x_L by ±γ·event/N_cpR —
    # Eq. (4)'s γ prefactor; pure tunneling conserves
    # N ∝ x_L + γ(x_Rgt + x_Rlt) exactly.
    n_cp_r = g * p.cooper_pairs_L
    out_l = ((r.l_00 + r.l_01) * p0 + (r.l_11 + r.l_10) * p1) * x_l / n_cp_r
    out_gt = ((r.rgt_00 + r.rgt_01) * p0 + (r.rgt_11 + r.rgt_10) * p1) * x_gt / n_cp_r
    out_lt = r.rlt_10 * p1 * x_lt / n_cp_r
    into_gt = (
        (r.l_00 * p0 + (r.l_11 + r.l_10) * p1 + r.phi * r.l_01 * p0) * x_l / n_cp_r
    )
    into_lt = (1.0 - r.phi) * r.l_01 * p0 * x_l / n_cp_r

    te_inv = _tau_e_inv(p, T_K)
    relax = x_gt / p.tau_R - te_inv * x_lt

    dx_l = g_l - p.r_L * x_l * x_l + g * (-out_l + out_gt + out_lt)
    dx_gt = (
        g_gt - p.r_Rgt * x_gt * x_gt - p.r_cross * x_gt * x_lt
        - out_gt + into_gt - relax
    )
    dx_lt = (
        g_lt - p.r_Rlt * x_lt * x_lt - p.r_cross * x_gt * x_lt
        - out_lt + into_lt + relax
    )

    # qubit: thermal bath (detailed balance) + quasiparticle tunneling
    up = r.l_01 * x_l + r.rgt_01 * x_gt
    down = r.l_10 * x_l + r.rgt_10 * x_gt + r.rlt_10 * x_lt
    bath_down = p.qubit_gamma_down
    bath_up = bath_down * torch.exp(-p.omega_10 / torch.clamp(t, min=1e-12))
    dp1 = (bath_up + up) * p0 - (bath_down + down) * p1
    return torch.stack([dx_l, dx_gt, dx_lt, dp1])


def _clamped(y: torch.Tensor, floor: float) -> torch.Tensor:
    """Densities at least ``floor``, p1 within [0, 1]."""
    return torch.cat([torch.clamp(y[:3], min=floor), torch.clamp(y[3:], 0.0, 1.0)])


def evolve(p: JunctionParams, T_K, state0, dt: float, n_steps: int, *,
           photons_on: bool = True, store_every: int = 1, device="cuda"):
    """RK4 time evolution of (x_L, x_Rgt, x_Rlt, p1); returns (times, states).

    Rates span ns⁻¹ (tunneling) to recombination times; the default
    populations are ≲ 1e-5 so the system is only mildly stiff at the
    paper's parameters — RK4 with dt ≲ τ_R/10 is stable.  ``lax.scan``
    there is a loop here, on ``device``.
    """
    from .solver.engine import _resolve_device

    dev = _resolve_device(device)
    T = _kelvin(T_K, dev)
    y = torch.as_tensor(np.asarray(state0, np.float64) if not isinstance(state0, torch.Tensor)
                        else state0, dtype=_F64, device=dev)

    def rhs(y):
        return junction_rhs(p, T, y, photons_on=photons_on)

    n_seg = n_steps // store_every
    ys = []
    for _ in range(n_seg):
        for _ in range(store_every):
            k1 = rhs(y)
            k2 = rhs(y + 0.5 * dt * k1)
            k3 = rhs(y + 0.5 * dt * k2)
            k4 = rhs(y + dt * (k3))
            y = _clamped(y + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4), 0.0)
        ys.append(y)
    times = (1 + torch.arange(n_seg, dtype=_F64, device=dev)) * (dt * store_every)
    return times, torch.stack(ys) if ys else torch.zeros((0, 4), dtype=_F64, device=dev)


def _newton(p: JunctionParams, T: torch.Tensor, photons_on: bool, n_newton: int,
            damping: float) -> torch.Tensor:
    """The damped Newton iteration for every temperature of ``T`` (B,) at
    once: (4, B) states.  ``p``'s tunneling rates may be (B,) tensors, one
    set per temperature; each member's iterates are its own, as a loop over
    temperatures would give, and each Jacobian row comes from one reverse
    pass for every member."""
    xl, xgt, xlt = thermal_densities(p, T)
    t = T * K_B_UEV_PER_K
    p1_eq = 1.0 / (1.0 + torch.exp(p.omega_10 / torch.clamp(t, min=1e-12)))
    # initial guess: the larger of the thermal density and the
    # generation/recombination balance scale √(g/r) — at low T the
    # photon-driven steady state is tens of orders above thermal, and
    # Newton from the e^{−Δ/T} floor overshoots catastrophically
    g_l, g_gt, g_lt = thermal_generation(p, T)
    if photons_on:
        g_ph_l = p.gamma_ph / p.cooper_pairs_L
        g_l = g_l + g_ph_l
        g_gt = g_gt + p.photon_split_gt * g_ph_l / p.gamma
        g_lt = g_lt + (1.0 - p.photon_split_gt) * g_ph_l / p.gamma
    scale = lambda gg, rr: _SQRT(torch.clamp(gg, min=0.0) / max(rr, 1e-30))
    y = torch.stack([
        torch.maximum(xl, scale(g_l, p.r_L)),
        torch.maximum(xgt, scale(g_gt, p.r_Rgt)),
        torch.maximum(xlt, scale(g_lt, p.r_Rlt)),
        p1_eq,
    ])

    def f(y):
        return junction_rhs(p, T, y, photons_on=photons_on)

    for _ in range(n_newton):
        # J[b, i, :] = ∂f_i/∂y of every member at once: one reverse pass per
        # row, members being independent (forward-mode there is slower here)
        yg = y.detach().requires_grad_(True)
        with torch.enable_grad():
            fy = f(yg)
            rows = [
                torch.autograd.grad(fy[i].sum(), yg, retain_graph=i < 3, allow_unused=True)[0]
                for i in range(4)
            ]
        jac = torch.stack([torch.zeros_like(y) if r is None else r for r in rows])  # (4, 4, B)
        step = torch.linalg.solve(jac.permute(2, 0, 1), fy.detach().T)  # (B, 4)
        y = _clamped(y - damping * step.T, _X_FLOOR)
    return y


def steady_state(p: JunctionParams, T_K, *, photons_on: bool = True,
                 n_newton: int = 60, damping: float = 1.0, device="cuda"):
    """Damped-Newton steady state of Eqs. (3)–(6) from the thermal guess.

    The Jacobian comes from autograd, one reverse pass per row
    (``jax.jacfwd`` in the JAX package: the same matrix to roundoff); the
    system is 4-dimensional so the dense solve is trivial.  Runs on
    ``device``; a tensor ``T_K`` is moved there.
    """
    from .solver.engine import _resolve_device

    T = _kelvin(T_K, _resolve_device(device)).reshape(1)
    return _newton(p, T, photons_on, n_newton, damping)[:, 0]


def chemical_potentials(p: JunctionParams, T_K, state):
    """Effective chemical potentials (μ_L, μ_Rgt, μ_Rlt) in µeV.

    μ_α = T·ln(x_α/x_α^eq) — zero at full equilibrium; the paper's regime
    classification compares them (Fig. 1).
    """
    x = torch.as_tensor(state, dtype=_F64)[..., :3]
    T = _kelvin(T_K, x.device)
    t = T * K_B_UEV_PER_K
    xl, xgt, xlt = thermal_densities(p, T)
    ref = torch.stack([xl, xgt, xlt], dim=-1)
    return t[..., None] * torch.log(
        torch.clamp(x, min=_X_FLOOR) / torch.clamp(ref, min=_X_FLOOR)
    )


REGIMES = (
    "nonequilibrium",          # μ_R> ≠ μ_R<
    "local_quasiequilibrium",  # μ_R> = μ_R< ≠ μ_L
    "global_quasiequilibrium", # μ_R> = μ_R< = μ_L ≠ 0
    "full_equilibrium",        # all ≈ 0
)


def classify_regime(mu, *, atol_ueV: float = 0.5) -> str:
    """Name the paper's regime (i)–(iv) from (μ_L, μ_Rgt, μ_Rlt)."""
    mu_l, mu_gt, mu_lt = (float(v) for v in np.asarray(mu).reshape(3))
    if max(abs(mu_l), abs(mu_gt), abs(mu_lt)) <= atol_ueV:
        return REGIMES[3]
    if abs(mu_gt - mu_lt) > atol_ueV:
        return REGIMES[0]
    if abs(mu_gt - mu_l) > atol_ueV:
        return REGIMES[1]
    return REGIMES[2]


def parity_switching_rate(p: JunctionParams, state):
    """Total charge-parity switching rate (1/ns): photon-assisted events
    plus single-quasiparticle tunneling (every such event flips parity)."""
    x_l, x_gt, x_lt, p1 = (torch.as_tensor(state, dtype=_F64)[..., i] for i in range(4))
    p0 = 1.0 - p1
    r = p.rates
    qp = (
        ((r.l_00 + r.l_01) * p0 + (r.l_11 + r.l_10) * p1) * x_l
        + ((r.rgt_00 + r.rgt_01) * p0 + (r.rgt_11 + r.rgt_10) * p1) * x_gt
        + r.rlt_10 * p1 * x_lt
    )
    return p.gamma_ph + qp


def qp_relaxation_rate(p: JunctionParams, state):
    """Quasiparticle-induced qubit relaxation rate Γ₁₀^qp (1/ns)."""
    x_l, x_gt, x_lt, _ = (torch.as_tensor(state, dtype=_F64)[..., i] for i in range(4))
    r = p.rates
    return r.l_10 * x_l + r.rgt_10 * x_gt + r.rlt_10 * x_lt


def temperature_sweep(p: JunctionParams, temperatures_K, *,
                      photons_on: bool = True, rebalance_rates: bool = True,
                      l_rates: dict | None = None, device="cuda"):
    """Steady state, chemical potentials and regime across a T sweep.

    With ``rebalance_rates`` (default) the R-side tunneling rates are
    rebuilt at every temperature via :func:`detailed_balance_rates` from
    the L-side entries of ``p.rates`` (or ``l_rates``) — the rates are
    genuinely T-dependent in the microscopic theory, and this keeps the
    photons-off limit exactly thermal at each point.  Returns a dict of
    numpy arrays (T, x, p1, mu, parity_rate, regime strings).
    """
    temps = np.atleast_1d(np.asarray(temperatures_K, dtype=np.float64))
    l_kw = l_rates or dict(
        l_00=p.rates.l_00, l_11=p.rates.l_11,
        l_10=p.rates.l_10, l_01=p.rates.l_01,
    )
    pts = [
        replace(p, rates=detailed_balance_rates(p, float(T), **l_kw)) if rebalance_rates else p
        for T in temps
    ]
    from .solver.engine import _resolve_device

    dev = _resolve_device(device)
    T = torch.as_tensor(temps, dtype=_F64, device=dev)
    # one Newton iteration for every temperature: the rates as (B,) tensors
    fields = ("l_00", "l_11", "l_10", "l_01", "rgt_00", "rgt_11", "rgt_10", "rgt_01", "rlt_10", "phi")
    rates = TunnelingRates(**{
        k: torch.as_tensor([getattr(pt.rates, k) for pt in pts], dtype=_F64, device=dev) for k in fields
    })
    pb = replace(p, rates=rates)
    y = _newton(pb, T, photons_on, 60, 1.0).T  # (B, 4)
    states = y.cpu().numpy()
    mus = chemical_potentials(pb, T, y).cpu().numpy()
    parity = parity_switching_rate(pb, y).cpu().numpy()
    return dict(
        temperatures_K=temps,
        states=states,
        p1=states[:, 3],
        mu_ueV=mus,
        parity_rate_per_ns=parity,
        regimes=[classify_regime(m) for m in mus],
    )
