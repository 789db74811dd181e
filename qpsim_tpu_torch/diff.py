"""Differentiable simulation: gradients through the solver.

The port of ``qpsim_tpu.diff``.  The whole time step is torch, so
observables are differentiable with respect to physical parameters —
gradient-based fitting of D₀, τₛ, τᵣ, the gap, pulse energies and the
photon drive against measured decay curves (the standard MKID analysis
task).

``make_differentiable_sim`` builds ``params -> observables`` over an
**arbitrary masked 2D geometry** with per-edge boundary conditions, where
``params = {"D0", "tau_s", "tau_r"[, "gap"]}`` are numbers or tensors: the
diffusion coefficients and collision kernels are rebuilt from them on
every call (K ∝ 1/τ, D(E) = D₀√(1−(Δ/E)²)), so ``backward()`` flows end
to end through the Strang-split integrator.  The optional ``gap`` makes
the superconducting gap Δ itself differentiable — the BCS DOS, both
collision kernels (affine in Δ²) and D(E) are rebuilt from Δ (the energy
grid and the initial state stay at the nominal construction-time gap:
fixed discretization, varying physics).  Observables:

* ``"total"``   — (n_steps+1,) energy-integrated QP number trace;
* ``"spatial"`` — (n_stored, Ny, Nx) energy-integrated density frames
  (zero outside the mask), every ``store_every`` steps;
* ``"mkid"``    — differentiable readout traces ``mkid_df``/``mkid_dq``
  (δf/f and δ(1/Q) via the differentiable Mattis–Bardeen integrals,
  ``mkid_readout_ghz=``/``mkid_alpha=``) — fit measured pulses directly;
* ``"phonon_spectrum"`` — (NW,) final phonon occupation per ω bin, summed
  over pixels;
* ``"phonon_total"`` — (n_steps+1,) total phonon occupation trace.

Parameters may also be (B,) tensors, one value per member of a batch: the
state then carries a leading member axis and every observable a leading
(B,) axis.  That is how :func:`fit_ensemble` fits B curves at once (the
JAX package's ``vmap``): one tridiagonal launch per half-step solves the
lines of every member.

The collision substep is the JAX package's XLA pair-tensor contraction in
plain torch (the collision kernels have no backward; float32 matmuls stay
in full precision, ``allow_tf32`` False).  The diffusion is ADI with
on-the-fly coefficients: both halves go through ``tridiag_solve``, which
on the card launches the tridiagonal kernel K10 and differentiates it by
K10's transposed solve (``ops.tridiag_cuda.ThomasSolve``).  The photon
substep is ``ops.photon_drive``'s with tensor coupling and occupancy.
``remat`` becomes a checkpoint that recomputes each step in the backward.
``make_differentiable_decay`` is the 1D-wire total-trace convenience wrapper; ``fit_parameters`` fits
one curve and ``fit_ensemble`` a batch of curves, by ``torch.optim.Adam``
over the log-parameters (optax's Adam in the JAX package: the same
formula, rounded differently).  The simulation runs on ``device``
("cuda" unless the caller asks for "cpu") in float64 by default.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from .constants import K_B_UEV_PER_K
from .geometry.mask import extract_edge_segments
from .models.params import BoundaryCondition
from .observables import PLANCK_UEV_PER_GHZ, mattis_bardeen_conductivity_traced
from .ops.diffusion import build_directional_stencils, fold_diffusion
from .ops.dos import dynes_density_of_states, thermal_phonon_occupation
from .ops.energy_grid import build_energy_grid
from .ops.phonon_map import build_phonon_frequency_map
from .ops.tridiag import tridiag_solve, tridiag_solve_along

__all__ = [
    "make_differentiable_sim",
    "make_differentiable_decay",
    "fit_parameters",
    "fit_ensemble",
]

_OBSERVABLES = ("total", "spatial", "phonon_spectrum", "phonon_total", "mkid")


class _Remat(torch.autograd.Function):
    """``fn(*tensors)`` run without a graph, recomputed in the backward.

    The checkpoint of ``remat``: the forward keeps only the inputs; the
    backward reruns ``fn`` on detached copies with grad on and hands
    ``torch.autograd.grad``'s input gradients back, so it serves
    ``.backward()``, ``.backward(inputs=...)`` and ``torch.autograd.grad``
    alike (``torch.utils.checkpoint``'s reentrant form only the first).
    Nested calls give the two-level schedule: an outer backward reruns its
    chunk, whose steps are again :class:`_Remat`.  Every tensor ``fn``
    reads that needs a gradient must be among ``tensors``.
    """

    @staticmethod
    def forward(ctx, fn, *tensors):
        ctx.fn = fn
        ctx.save_for_backward(*tensors)
        with torch.no_grad():
            return fn(*tensors)

    @staticmethod
    def backward(ctx, *grads):
        inputs = [t.detach().requires_grad_(need) for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad[1:])]
        with torch.enable_grad():
            outputs = ctx.fn(*inputs)
        pairs = [(o, g) for o, g in zip(outputs, grads) if o.requires_grad and g is not None]
        wanted = [t for t in inputs if t.requires_grad]
        got = iter(torch.autograd.grad([o for o, _ in pairs], wanted, [g for _, g in pairs], allow_unused=True))
        return (None, *(next(got) if t.requires_grad else None for t in inputs))


def _traced_kernels(E: torch.Tensor, gap, T_c: float):
    """Base collision kernels as functions of 1/τ (K ∝ 1/τ); ``gap`` a
    number or a (B, 1, 1) tensor, giving (NE, NE) or (B, NE, NE)."""
    kTc = K_B_UEV_PER_K * T_c
    zero = E.new_zeros(())
    e_sum = E[:, None] + E[None, :]
    e_diff = E[:, None] - E[None, :]
    e_prod = torch.maximum(E[:, None] * E[None, :], E.new_tensor(1e-30))
    kr_shape = (e_sum / kTc) ** 2 / kTc * (1.0 + gap**2 / e_prod)
    ks_shape = e_diff**2 / kTc**3 * torch.maximum(1.0 - gap**2 / e_prod, zero)
    ks_shape = ks_shape * (1.0 - torch.eye(E.shape[0], dtype=E.dtype, device=E.device))
    return kr_shape, ks_shape


def make_differentiable_sim(
    *,
    mask: np.ndarray | None = None,
    edges: list | None = None,
    edge_conditions: dict | None = None,
    nx: int = 64,
    gap: float = 180.0,
    num_energy_bins: int = 8,
    energy_max_factor: float = 4.0,
    T_c: float = 1.2,
    bath_temperature: float = 0.2,
    dt: float = 0.05,
    n_steps: int = 40,
    n0: float = 1e-4,
    initial_field: np.ndarray | None = None,
    dtype: torch.dtype = torch.float64,
    phonon_feedback: bool = True,
    observables: tuple[str, ...] = ("total",),
    store_every: int = 1,
    pulse_window: tuple[float, float] | None = None,
    photon_omega: float | None = None,
    photon_window: tuple[float, float] | None = None,
    remat: bool = True,
    remat_chunk: int | None = None,
    mkid_readout_ghz: float = 5.0,
    mkid_alpha: float = 1.0,
    device="cuda",
) -> Callable:
    """Build ``sim(params) -> {observable: tensor}`` on a masked 2D geometry.

    ``params``: dict of numbers or tensors ``D0``, ``tau_s``, ``tau_r``
    (optionally ``gap``, and — with ``pulse_window=(start, duration)`` —
    ``pulse_rate``: a window-gated uniform forward-Euler source at the
    reference's per-step contract, so photon pulse energy becomes a
    differentiable parameter to fit).  Each may be a scalar or a (B,)
    tensor (a batch of B members, see the module docstring).

    ``photon_omega`` (µeV) enables the Fischer-2024 photon drive
    (``ops/photon_drive.py``) with differentiable ``photon_coupling`` and
    ``photon_occupancy`` params — the paper's experimental inference
    problem (photon number in the mode from the measured QP response)
    becomes a gradient fit.  ``photon_window=(start, duration)`` gates it
    in time; the pair/offset index structure is grid-snapped at the
    nominal gap (static), the coefficients stay closed-form.
    Defaults to a reflective 1×nx wire when no geometry is given; pass
    ``mask``/``edges``/``edge_conditions`` for arbitrary 2D films with the
    full per-edge boundary-condition set.

    ``phonon_feedback=False`` freezes the bath at thermal occupation — the
    standard "phonons escape to the substrate instantly" modelling limit, in
    which recombination is a true loss channel and decay curves carry strong
    τᵣ sensitivity.  With feedback on (closed film) re-breaking largely
    cancels recombination and total QP number is nearly conserved.

    **Gradient memory** (``remat``, ``remat_chunk``): a backward pass over
    plain steps keeps every step's intermediates — dominated by the
    (P, NE, NE) pair tensors of the collision contraction, ~P·NE²·8 bytes
    PER STEP (≈130 MB/step on a 64² film at 16 bins).  ``remat=True``
    (default) checkpoints each step, so the
    backward keeps only the (q, ph) carries and recomputes one step's
    interior at a time — one extra forward evaluation per step inside
    ``backward()`` (a forward-only call runs no checkpoint).  Every tensor
    a step reads that depends on the parameters is handed to it as an
    input, so the checkpoint (:class:`_Remat`) records nothing in the
    forward — ``torch.utils.checkpoint``'s non-reentrant form runs a Python
    hook for each saved tensor (1.8x the host time of a two-level call) —
    and returns input gradients from its backward, so ``.backward()`` and
    ``torch.autograd.grad`` both work (the reentrant form refuses the
    latter).  ``torch.func`` transforms do not apply: the tridiagonal
    kernel's Function has no ``vmap``/``jvp`` rule.  ``remat_chunk=c`` nests two levels (checkpointed chunks
    of ``c`` checkpointed steps), keeping only the ~n/c chunk-boundary
    carries plus one chunk's carries during its recompute — the O(√n)
    schedule at ``c ≈ √n``.  All three give the same forward outputs and
    gradients that agree to roundoff.

    The simulation runs on ``device`` in ``dtype`` (float64 by default,
    as in the JAX package).
    """
    from .solver.engine import _resolve_device

    for obs in observables:
        if obs not in _OBSERVABLES:
            raise ValueError(f"Unknown observable {obs!r}; pick from {_OBSERVABLES}")
    dev = _resolve_device(device)
    mkid_hnu = PLANCK_UEV_PER_GHZ * float(mkid_readout_ghz)
    if "mkid" in observables and mkid_hnu >= 2 * gap:
        raise ValueError(
            f"'mkid' observable needs a non-pair-breaking readout: "
            f"hnu = {mkid_hnu:g} µeV >= 2·gap = {2 * gap:g} µeV."
        )
    if mask is None:
        mask = np.ones((1, nx), dtype=bool)
    mask = np.asarray(mask, dtype=bool)
    if edges is None:
        edges = extract_edge_segments(mask)
    if edge_conditions is None:
        edge_conditions = {e.edge_id: BoundaryCondition(kind="reflective") for e in edges}
    ny_g, nx_g = mask.shape
    E_np, dE = build_energy_grid(gap, 1.0, energy_max_factor, num_energy_bins)
    pmap = build_phonon_frequency_map(E_np)
    rho_np = dynes_density_of_states(E_np, gap, 0.0)
    as_dev = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=dtype, device=dev)

    # unit-D stencils; D(E) folds in per call so dD/dD0 flows
    x_st, y_st = build_directional_stencils(mask, edges, edge_conditions, 1.0)
    unit = fold_diffusion(x_st, y_st, mask, 1.0, 1.0)
    ax_lo, ax_hi, ax_diag = as_dev(unit.ax_lo), as_dev(unit.ax_hi), as_dev(unit.ax_diag)
    ay_lo, ay_hi, ay_diag = as_dev(unit.ay_lo), as_dev(unit.ay_hi), as_dev(unit.ay_diag)
    # boundary source terms (dirichlet g, neumann flux, robin injection);
    # like the couplings they scale linearly with the local D
    src_unit = as_dev(unit.source_total())  # (1, Ny, Nx)

    E = as_dev(E_np)
    rho = as_dev(rho_np)
    kr_shape, ks_shape = _traced_kernels(E, gap, T_c)
    ne = num_energy_bins
    nw = pmap.num_omega
    idx_diff = torch.as_tensor(pmap.idx_diff.reshape(-1), dtype=torch.int64, device=dev)
    idx_sum = torch.as_tensor(pmap.idx_sum.reshape(-1), dtype=torch.int64, device=dev)
    emit = as_dev(pmap.diff_sign > 0)
    absorb = as_dev(pmap.diff_sign < 0)
    scatter_diff = as_dev(pmap.scatter_diff)
    scatter_sum = as_dev(pmap.scatter_sum)
    zero = torch.zeros((), dtype=dtype, device=dev)
    floor = torch.full((), 1e-30, dtype=dtype, device=dev)
    mu_floor = torch.full((), 1e-14, dtype=dtype, device=dev)

    if photon_omega is not None:
        from .ops.photon_drive import (
            _relax as _ph_relax,
            build_photon_drive_plan,
            photon_loss_gain,
            photon_plan_device,
        )

        _ph_plan = build_photon_drive_plan(
            E_bins=E_np, dE=dE, gap=gap, rho=rho_np, omega=float(photon_omega),
            coupling=1.0, occupancy=0.0,
        )
        _ph_dev = photon_plan_device(_ph_plan, dtype, dev)

    ph0_np = np.zeros((nw, ny_g, nx_g))
    ph0_np[:, mask] = thermal_phonon_occupation(pmap.omega_bins, bath_temperature)[:, None]
    ph0 = as_dev(ph0_np)[None]  # (1, NW, Ny, Nx)
    if initial_field is None:
        field = np.where(mask, n0, 0.0)
    else:
        field = np.where(mask, np.asarray(initial_field, dtype=np.float64), 0.0)
    weights = rho_np / max(1e-30, float(np.sum(rho_np) * dE))
    q0 = as_dev(weights[:, None, None] * field[None])[None]  # (1, NE, Ny, Nx)
    mask_dev = as_dev(mask)
    n_mask = float(mask.sum())
    np_dtype = np.float64 if dtype == torch.float64 else np.float32

    def step_time(k: int) -> float:
        """k·dt in the state dtype (the JAX step's ``k.astype(dtype) * dt``)."""
        return float(np_dtype(k) * np_dtype(dt))

    def inside(t: float, start: float, duration: float) -> bool:
        return np_dtype(start) <= t < np_dtype(start + duration)

    # the emission/absorption split folded into the ω scatter: one product
    # gives both rows' rates (the masks are exact 0/1)
    flat = lambda m: m.reshape(-1, 1)
    scatter_ea = torch.cat([flat(emit) * scatter_diff, flat(absorb) * scatter_diff], dim=1)  # (NE², 2NW)
    offdiag = emit + absorb

    def collision_constants(K_r0, K_s0, rho_c):
        """What a collision substep needs of the parameters, formed once per
        call (not per step): dE·K^s₀ split by emission, 2dE·K^r₀, dE·K^r₀,
        ρ and its floor — as (B, 1, …) for the (B, P, …) pixel batch."""
        dKs = (dE * K_s0)[:, None]
        rho_b = rho_c[:, None, :]
        return dict(dKs=dKs, dKs_emit=dKs * emit, dKs_off=dKs * offdiag, dKr=(dE * K_r0)[:, None],
                    Kr2=(2.0 * dE * K_r0)[:, None], rho=rho_b, rho_fl=torch.maximum(rho_b, floor))

    def collide(q, ph, c, dt_c):
        # member- and pixel-batched: q (B, NE, Ny, Nx), ph (B, NW, Ny, Nx)
        b = q.shape[0]
        qT = q.reshape(b, ne, -1).transpose(1, 2)  # (B, P, NE)
        phT = ph.reshape(b, nw, -1).transpose(1, 2)  # (B, P, NW)
        partner = c["rho"] * torch.maximum(1.0 - qT / c["rho_fl"], zero)
        n_diff = phT[..., idx_diff].reshape(b, -1, ne, ne)
        n_sum = phT[..., idx_sum].reshape(b, -1, ne, ne)
        # dE·K^s₀ dressed: (1 + n) on emission, n on absorption
        dKs_eff = c["dKs_emit"] + c["dKs_off"] * n_diff
        KrN = c["Kr2"] * n_sum
        loss = torch.einsum("bcij,bcj->bci", dKs_eff, partner) + torch.einsum("bcij,bcj->bci", c["Kr2"] + KrN, qT)
        gain = partner * (torch.einsum("bcji,bcj->bci", dKs_eff, qT) + torch.einsum("bcij,bcj->bci", KrN, partner))
        mu = torch.maximum(loss, zero)
        neg = -mu * dt_c
        coeff = torch.where(mu < 1e-14, dt_c, -torch.expm1(neg) / torch.maximum(mu, mu_floor))
        q_new = torch.maximum(torch.exp(neg) * qT + coeff * torch.maximum(gain, zero), zero)
        if phonon_feedback:
            e_a = ((qT[..., :, None] * c["dKs"]) * partner[..., None, :]).flatten(-2) @ scatter_ea
            e_flat, a_flat = e_a[..., :nw], e_a[..., nw:]
            rec = ((qT[..., :, None] * c["dKr"]) * qT[..., None, :]).flatten(-2) @ scatter_sum
            pb = ((partner[..., :, None] * c["dKr"]) * partner[..., None, :]).flatten(-2) @ scatter_sum
            a_ph = e_flat + rec
            b_ph = a_ph - a_flat - pb
            x = torch.clamp(b_ph * dt_c, -80.0, 80.0)
            tiny = torch.abs(b_ph) < 1e-14
            cph = torch.where(tiny, dt_c, torch.expm1(x) / torch.where(tiny, 1.0, b_ph))
            ph_new = torch.maximum(torch.exp(x) * phT + cph * a_ph, zero)
        else:
            ph_new = phT
        # contiguous (bins outermost), so the diffusion's solves read their
        # lines in place (K10's rows and cols layouts, no copy)
        return (q_new.transpose(1, 2).contiguous().view(b, ne, ny_g, nx_g),
                ph_new.transpose(1, 2).contiguous().view(b, nw, ny_g, nx_g))

    def diffusion_constants(D0, dt_d, gap_d):
        """The ADI step's planes for D(E) = D0·√(1 − (Δ/E)²), formed once per
        call: α·D times each stencil plane, the two halves' tridiagonal
        coefficients and the α·D-scaled boundary sources."""
        # safe-gradient form: the unselected branch is constant, so a gap
        # tensor cannot produce NaN grads at the sqrt(0) edge
        inner = 1.0 - (gap_d[:, None] / E) ** 2  # (B, NE)
        D_bins = D0[:, None] * torch.where(inner > 0, torch.sqrt(torch.maximum(inner, floor)), zero)
        aD = 0.5 * dt_d * D_bins[:, :, None, None]  # α·D, (B, NE, 1, 1)
        shape = (aD.shape[0], ne, ny_g, nx_g)
        full = lambda t: t.expand(shape).contiguous()
        return dict(
            x_sub=full(-aD * ax_lo), x_diag=full(1.0 - aD * ax_diag), x_sup=full(-aD * ax_hi),
            y_sub=full(-aD * ay_lo), y_diag=full(1.0 - aD * ay_diag), y_sup=full(-aD * ay_hi),
            ax_lo=aD * ax_lo, ax_hi=aD * ax_hi, ax_diag=aD * ax_diag,
            ay_lo=aD * ay_lo, ay_hi=aD * ay_hi, ay_diag=aD * ay_diag,
            src=aD * src_unit,  # boundary sources scale with the local D
        )

    def diffuse(u, c):
        # u (B, NE, Ny, Nx): Peaceman–Rachford, x implicit then y implicit
        rhs = u + (c["ay_lo"] * torch.roll(u, 1, -2) + c["ay_hi"] * torch.roll(u, -1, -2)
                   + c["ay_diag"] * u) + c["src"]
        u_star = tridiag_solve(c["x_sub"], c["x_diag"], c["x_sup"], rhs)
        rhs2 = u_star + (c["ax_lo"] * torch.roll(u_star, 1, -1) + c["ax_hi"] * torch.roll(u_star, -1, -1)
                         + c["ax_diag"] * u_star) + c["src"]
        return tridiag_solve_along(-2, c["y_sub"], c["y_diag"], c["y_sup"], rhs2)

    want_spatial = "spatial" in observables
    want_mkid = "mkid" in observables

    def param(v) -> torch.Tensor:
        """A parameter as a (1,) or (B,) tensor on the device (autograd kept)."""
        if isinstance(v, torch.Tensor):
            return v.to(device=dev, dtype=dtype).reshape(-1)
        return torch.as_tensor(np.asarray(v, dtype=np.float64), dtype=dtype, device=dev).reshape(-1)

    def sim(params) -> dict[str, torch.Tensor]:
        p = {k: param(v) for k, v in params.items()}
        sizes = {int(v.numel()) for v in p.values()} - {1}
        if len(sizes) > 1:
            raise ValueError(f"batched parameters must share one member count, got {sorted(sizes)}")
        batched = any((v.ndim if isinstance(v, torch.Tensor) else np.ndim(v)) > 0 for v in params.values())
        nb = sizes.pop() if sizes else 1
        D0 = p["D0"]
        if "gap" in params:
            # gap parameter: kernels/DOS/D(E) rebuilt from Δ so backward()
            # flows through the superconducting gap itself (the energy grid
            # and initial state stay at the nominal gap — fixed
            # discretization, varying physics)
            gap_t = p["gap"]
            kr_t, ks_t = _traced_kernels(E, gap_t[:, None, None], T_c)
            g_col = gap_t[:, None]
            rho_t = torch.where(
                E > g_col,
                E / torch.sqrt(torch.maximum(E**2 - g_col**2, floor)),
                zero,
            )
        else:
            gap_t = torch.full((1,), float(gap), dtype=dtype, device=dev)
            kr_t, ks_t, rho_t = kr_shape[None], ks_shape[None], rho[None]
        K_r0 = (kr_t / p["tau_r"][:, None, None]).expand(nb, ne, ne)
        K_s0 = (ks_t / p["tau_s"][:, None, None]).expand(nb, ne, ne)
        rho_t = rho_t.expand(nb, ne)
        # every tensor the steps read that depends on the parameters, handed
        # to each step (and so to its checkpoint) as an explicit input
        consts = {**collision_constants(K_r0, K_s0, rho_t),
                  **diffusion_constants(D0.expand(nb), dt, gap_t.expand(nb))}
        if pulse_window is not None:
            start, duration = float(pulse_window[0]), float(pulse_window[1])
            consts["rate"] = p["pulse_rate"][:, None, None, None]
        if photon_omega is not None:
            ph_c = p["photon_coupling"]
            ph_nbar = p["photon_occupancy"]
            n_pix = ny_g * nx_g
            # per member, one row over its pixels: (1, B·P), or a scalar
            as_row = lambda v: v.repeat_interleave(n_pix).reshape(1, -1) if nb > 1 else v.reshape(())
            consts["ph_nbar"] = as_row(ph_nbar.expand(nb))
            consts["ph_c"] = as_row(ph_c.expand(nb))
            consts["ph_rho"] = torch.maximum(rho_t, floor).T.repeat_interleave(n_pix, dim=1)  # (NE, B·P)
        keys = tuple(consts)

        def photon_substep(q, t: float, c):
            # same positivity-preserving exponential relaxation as the
            # engine substep, with tensor coupling/occupancy
            b = q.shape[0]
            qf = q.transpose(0, 1).reshape(ne, -1)  # (NE, B·P)
            f = qf / c["ph_rho"]
            partner = c["ph_rho"] * torch.maximum(1.0 - f, zero)
            mu, gain = photon_loss_gain(qf, partner, c["ph_nbar"], _ph_dev)
            on = photon_window is None or inside(t, *photon_window)
            amp = c["ph_c"] if on else torch.zeros_like(c["ph_c"])
            mu = amp * mu
            out = _ph_relax(qf, mu, partner * (amp * gain), dt)
            # off-mask cells carry q = 0 but partner = ρ > 0 — the mask
            # multiply keeps pair-breaking gains on the film only
            return out.reshape(ne, b, ny_g, nx_g).transpose(0, 1) * mask_dev

        def step(q, ph, k: int, *values):
            c = dict(zip(keys, values))
            if pulse_window is not None and inside(step_time(k), start, duration):
                q = q + (dt * c["rate"]) * mask_dev
            if photon_omega is not None:
                q = photon_substep(q, step_time(k), c)
            q, ph = collide(q, ph, c, 0.5 * dt)
            q = diffuse(q, c)
            q, ph = collide(q, ph, c, 0.5 * dt)
            out = (q.sum((1, 2, 3)) * dE, ph.sum((1, 2, 3)))
            if want_spatial:
                out = out + (q.sum(1) * dE,)
            if want_mkid:
                out = out + ((q * mask_dev).sum((2, 3)) / n_mask,)
            return (q, ph) + out

        values = tuple(consts.values())
        # checkpoints only where a backward will follow (a forward-only call
        # runs the plain steps)
        remat_here = remat and torch.is_grad_enabled() and any(v.requires_grad for v in values)

        def body(q, ph, k: int, vals):
            if remat_here:
                return _Remat.apply(lambda q, ph, *v: step(q, ph, k, *v), q, ph, *vals)
            return step(q, ph, k, *vals)

        def run_steps(q, ph, k0: int, count: int, *vals):
            ys = []
            for k in range(k0, k0 + count):
                q, ph, *out = body(q, ph, k, vals)
                ys.append(out)
            return (q, ph) + tuple(torch.stack(col) for col in zip(*ys))

        q, ph = q0.expand(nb, -1, -1, -1), ph0.expand(nb, -1, -1, -1)
        parts = []
        if remat_here and remat_chunk is not None and 1 < remat_chunk < n_steps:
            # two-level O(√n) schedule: only chunk-boundary carries are kept;
            # each chunk recomputes under its own checkpoint, whose inner
            # steps are themselves checkpointed
            c = int(remat_chunk)
            n_outer, rem = divmod(n_steps, c)
            for j in range(n_outer):
                chunk = lambda q, ph, *v, k0=j * c, n=c: run_steps(q, ph, k0, n, *v)
                q, ph, *ys = _Remat.apply(chunk, q, ph, *values)
                parts.append(ys)
            if rem:
                q, ph, *ys = run_steps(q, ph, n_outer * c, rem, *values)
                parts.append(ys)
        else:
            q, ph, *ys = run_steps(q, ph, 0, n_steps, *values)
            parts.append(ys)
        ys = [torch.cat(col) for col in zip(*parts)]  # each (n_steps, B, ...)
        q0b = q0.expand(nb, -1, -1, -1)
        result: dict[str, torch.Tensor] = {}
        if "total" in observables:
            result["total"] = torch.cat([(q0b.sum((1, 2, 3)) * dE)[None], ys[0]]).T
        if "phonon_total" in observables:
            result["phonon_total"] = torch.cat([ph0.expand(nb, -1, -1, -1).sum((1, 2, 3))[None], ys[1]]).T
        if want_spatial:
            frames = ys[2][store_every - 1 :: store_every]
            first = (q0b.sum(1) * dE)[None]
            result["spatial"] = (torch.cat([first, frames]) * mask_dev).transpose(0, 1)
        if "phonon_spectrum" in observables:
            result["phonon_spectrum"] = ph.sum((-2, -1))
        if want_mkid:
            nbar = ys[-1]  # (n_steps, B, NE) masked-mean spectral density
            nbar0 = ((q0b * mask_dev).sum((2, 3)) / n_mask)[None]
            f_tr = torch.cat([nbar0, nbar]) / torch.maximum(rho_t, floor)  # (n_steps + 1, B, NE)
            # one batched call per member over its n_steps + 1 occupations
            # (the JAX package's vmap over the trace)
            gaps = gap_t.expand(nb)
            pairs = [mattis_bardeen_conductivity_traced(f_tr[:, m], E_np, gaps[m], mkid_hnu) for m in range(nb)]
            s1s = torch.stack([a for a, _ in pairs])  # (B, n_steps + 1)
            s2s = torch.stack([b for _, b in pairs])
            result["mkid_df"] = 0.5 * mkid_alpha * (s2s - s2s[:, :1]) / s2s[:, :1]
            result["mkid_dq"] = mkid_alpha * (s1s - s1s[:, :1]) / s2s[:, :1]
        if not batched:
            result = {k: v[0] for k, v in result.items()}
        return result

    return sim


def make_differentiable_decay(
    *,
    nx: int = 64,
    gap: float = 180.0,
    num_energy_bins: int = 8,
    energy_max_factor: float = 4.0,
    T_c: float = 1.2,
    bath_temperature: float = 0.2,
    dt: float = 0.05,
    n_steps: int = 40,
    n0: float = 1e-4,
    dtype: torch.dtype = torch.float64,
    phonon_feedback: bool = True,
    remat: bool = True,
    remat_chunk: int | None = None,
    device="cuda",
) -> Callable:
    """Build ``decay(params) -> (n_steps+1,) total-QP trace`` on a 1D wire.

    Convenience wrapper over :func:`make_differentiable_sim` with the
    ``"total"`` observable only; (B,) parameters give a (B, n_steps+1) trace.
    """
    sim = make_differentiable_sim(
        nx=nx,
        gap=gap,
        num_energy_bins=num_energy_bins,
        energy_max_factor=energy_max_factor,
        T_c=T_c,
        bath_temperature=bath_temperature,
        dt=dt,
        n_steps=n_steps,
        n0=n0,
        dtype=dtype,
        phonon_feedback=phonon_feedback,
        observables=("total",),
        remat=remat,
        remat_chunk=remat_chunk,
        device=device,
    )
    return lambda params: sim(params)["total"]


def _adam_fit(observed, initial_params: dict, decay_fn: Callable, learning_rate: float, n_iters: int,
              member_axis: bool) -> dict[str, torch.Tensor]:
    """Adam on the log-parameters (float64, on the CPU); the loss is the mean
    relative squared error over the trace, summed over members."""
    log_params = {
        k: torch.log(torch.as_tensor(np.asarray(v, dtype=np.float64))).requires_grad_()
        for k, v in initial_params.items()
    }
    opt = torch.optim.Adam(list(log_params.values()), lr=learning_rate)
    obs = None
    for _ in range(n_iters):
        opt.zero_grad()
        pred = decay_fn({k: torch.exp(v) for k, v in log_params.items()})
        if obs is None:
            obs = (observed if isinstance(observed, torch.Tensor) else torch.tensor(np.asarray(observed)))
            obs = obs.to(dtype=torch.float64, device=pred.device)
        rel = (pred - obs) ** 2 / torch.clamp(obs, min=1e-30) ** 2
        loss = rel.mean(-1).sum() if member_axis else rel.mean()
        loss.backward()
        opt.step()
    return {k: torch.exp(v.detach()) for k, v in log_params.items()}


def fit_parameters(
    observed,
    initial_params: dict,
    *,
    decay_fn: Callable,
    learning_rate: float = 0.05,
    n_iters: int = 100,
) -> dict:
    """Fit (log-space) physical parameters to an observed decay curve.

    Plain Adam (``torch.optim.Adam``) on ``log params`` (positivity-
    preserving); returns the fitted parameter dict of floats.
    """
    fitted = _adam_fit(observed, initial_params, decay_fn, learning_rate, n_iters, member_axis=False)
    return {k: float(v) for k, v in fitted.items()}


def fit_ensemble(
    observed,
    initial_params: dict,
    *,
    decay_fn: Callable,
    learning_rate: float = 0.05,
    n_iters: int = 100,
) -> dict:
    """Fit a batch of decay curves at once (one parameter set per member).

    ``observed`` is (B, n_steps+1); each value in ``initial_params`` is a
    (B,) array.  ``decay_fn`` takes (B,) parameter tensors and returns the
    (B, n_steps+1) traces, as :func:`make_differentiable_decay` does — the
    members ride a leading axis of one simulation (one tridiagonal launch
    per half-step for all of them).  The loss sums the per-member relative
    errors, so members' gradients are independent: B simultaneous fits in
    one optimizer.  Returns {name: (B,) fitted values}.
    """
    fitted = _adam_fit(observed, initial_params, decay_fn, learning_rate, n_iters, member_axis=True)
    return {k: v.numpy() for k, v in fitted.items()}
