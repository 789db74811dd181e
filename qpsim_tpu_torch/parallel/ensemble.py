"""Ensemble sweeps on one card: the members as a batch dimension.

The port of ``qpsim_tpu.parallel.ensemble``.  The reference runs one
simulation per process; here a parameter sweep (e.g. 32 diffusion
coefficients, or 32 pulse energies) is one batched program, as the JAX
package's ``vmap`` makes it: a leading member axis in the diffusion sweep,
and for film ensembles the members stacked into one masked super-grid, so
every kernel launch serves the whole sweep.  Entry points run on
``device`` ("cuda" unless the caller asks for "cpu") in float32 unless
asked, as in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from ..geometry.mask import extract_edge_segments
from ..models.params import BoundaryCondition
from ..ops.diffusion import build_directional_stencils, fold_diffusion
from ..ops.tridiag import tridiag_solve, tridiag_solve_along

__all__ = [
    "build_diffusion_sweep_step",
    "sweep_diffusion_decay",
    "FilmEnsemble",
    "build_film_ensemble",
]


def _device(device) -> torch.device:
    from ..solver.engine import _resolve_device

    return _resolve_device(device)


def build_diffusion_sweep_step(
    mask: np.ndarray,
    edges,
    edge_conditions: dict[str, BoundaryCondition],
    dx: float,
    dt: float,
    dtype: torch.dtype = torch.float32,
    device="cuda",
) -> Callable:
    """Return ``step(states, D_values)`` over a leading member axis.

    ``states``: (B, NB, Ny, Nx); ``D_values``: (B,) member diffusion
    coefficients.  One Peaceman–Rachford step per call; the D-scaling is
    applied per member so every member shares the same unscaled stencil
    planes, and each half is one tridiagonal solve over every member's
    lines (``tridiag_solve``: K10 on the card).
    """
    dev = _device(device)
    x_st, y_st = build_directional_stencils(mask, edges, edge_conditions, dx)
    unit = fold_diffusion(x_st, y_st, mask, dx, 1.0)
    as_dev = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=dtype, device=dev)
    ax_lo, ax_hi, ax_diag = as_dev(unit.ax_lo), as_dev(unit.ax_hi), as_dev(unit.ax_diag)
    ay_lo, ay_hi, ay_diag = as_dev(unit.ay_lo), as_dev(unit.ay_hi), as_dev(unit.ay_diag)
    src = as_dev(unit.source_total())
    alpha0 = 0.5 * float(dt)

    def apply_dir(u, a_lo, a_hi, diag, axis):
        return a_lo * torch.roll(u, 1, axis) + a_hi * torch.roll(u, -1, axis) + diag * u

    def step(states: torch.Tensor, D_values: torch.Tensor) -> torch.Tensor:
        u = states
        d_val = torch.as_tensor(D_values, dtype=dtype, device=dev).reshape(-1, 1, 1, 1)
        a = alpha0 * d_val
        rhs = u + a * apply_dir(u, ay_lo, ay_hi, ay_diag, -2) + alpha0 * d_val * src
        u_star = tridiag_solve(
            (-a * ax_lo).expand(rhs.shape),
            (1.0 - a * ax_diag).expand(rhs.shape),
            (-a * ax_hi).expand(rhs.shape),
            rhs,
        )
        rhs2 = u_star + a * apply_dir(u_star, ax_lo, ax_hi, ax_diag, -1) + alpha0 * d_val * src
        return tridiag_solve_along(
            -2,
            (-a * ay_lo).expand(rhs2.shape),
            (1.0 - a * ay_diag).expand(rhs2.shape),
            (-a * ay_hi).expand(rhs2.shape),
            rhs2,
        )

    return step


def sweep_diffusion_decay(
    width: int = 64,
    height: int = 32,
    D_values: np.ndarray | None = None,
    steps: int = 50,
    dt: float = 0.05,
    dtype: torch.dtype = torch.float32,
    device="cuda",
) -> np.ndarray:
    """Convenience sweep: peak decay curves for a batch of D values.

    Returns (B, steps+1) center-pixel traces — the batched analogue of
    running the reference B times.
    """
    if D_values is None:
        D_values = np.linspace(1.0, 8.0, 8)
    dev = _device(device)
    mask = np.ones((height, width), dtype=bool)
    edges = extract_edge_segments(mask)
    bcs = {e.edge_id: BoundaryCondition(kind="reflective") for e in edges}
    step = build_diffusion_sweep_step(mask, edges, bcs, 1.0, dt, dtype, dev)
    b = len(D_values)
    states = np.zeros((b, 1, height, width), dtype=np.float64)
    states[:, 0, height // 2, width // 2] = 1.0
    u = torch.as_tensor(states, dtype=dtype, device=dev)
    d = torch.as_tensor(np.asarray(D_values, dtype=np.float64), dtype=dtype, device=dev)
    traces = [u[:, 0, height // 2, width // 2]]
    for _ in range(steps):
        u = step(u, d)
        traces.append(u[:, 0, height // 2, width // 2])
    return torch.stack(traces, dim=1).cpu().numpy()


# ---------------------------------------------------------------------------
# film ensembles: B independent films as one masked super-grid
# ---------------------------------------------------------------------------
#
# An ensemble of B identical-geometry films stacked along y IS a single
# masked film whose members are disconnected components: the directional
# stencils already zero couplings across member boundaries (each member has
# its own boundary faces), so the ordinary single-card step — diffusion,
# collisions, kernels — batches the whole sweep with no new machinery.
# Per-member collision parameters (τ_s, τ_r) ride the per-gap table
# mechanism used for non-uniform gaps: member id → table index.

from ..ops.collisions import build_collision_plan_arrays, make_collision_step  # noqa: E402
from ..ops.collisions_cuda import build_collision_step, build_collision_step_analytic  # noqa: E402
from ..ops.dos import (  # noqa: E402
    diffusion_coefficient_of_energy,
    dynes_density_of_states,
    thermal_phonon_occupation,
)
from ..ops.energy_grid import build_energy_grid  # noqa: E402
from ..ops.kernels import recombination_kernel_base, scattering_kernel_base  # noqa: E402
from ..ops.phonon_map import build_phonon_frequency_map  # noqa: E402
from ..solver.diffusion_backends import ADIDiffusion  # noqa: E402


@dataclass
class FilmEnsemble:
    """A B-member sweep materialised as one super-grid simulation step.

    The super-grid stacks members along y with one masked-off separator row
    between them (member m occupies rows [m·(ny+1), m·(ny+1)+ny)).  States
    live on ``device`` in ``dtype``; ``step`` is (q, ph) -> (q, ph).
    """

    step: Callable  # (q, ph) -> (q, ph)
    n_members: int
    member_shape: tuple[int, int]
    super_shape: tuple[int, int]
    num_energy_bins: int
    num_omega: int
    E_bins: np.ndarray
    omega_bins: np.ndarray
    dE: float
    dt: float = 0.0
    gaps: np.ndarray | None = None  # (B,) per-member Δ (photon-drive chunks)
    dynes_gamma: float = 0.0
    device: torch.device = torch.device("cpu")
    dtype: torch.dtype = torch.float32
    #: the collision half-step the Strang step runs twice (its ``plan``,
    #: ``tables`` and ``plain`` ride on it)
    collision_half: Callable | None = None

    @property
    def _stride(self) -> int:
        return self.member_shape[0] + 1

    def _member_rows(self, m: int) -> slice:
        return slice(m * self._stride, m * self._stride + self.member_shape[0])

    def pack(self, q_members: np.ndarray, ph_members: np.ndarray):
        """(B, NE, ny, nx), (B, NW, ny, nx) → super-grid (NE, Y, nx), (NW, Y, nx) (numpy)."""
        ne = q_members.shape[1]
        nw = ph_members.shape[1]
        q = np.zeros((ne, *self.super_shape), dtype=np.float64)
        ph = np.zeros((nw, *self.super_shape), dtype=np.float64)
        for m in range(self.n_members):
            q[:, self._member_rows(m), :] = q_members[m]
            ph[:, self._member_rows(m), :] = ph_members[m]
        return q, ph

    def to_device(self, *arrays: np.ndarray) -> tuple[torch.Tensor, ...]:
        """Host arrays (e.g. :meth:`pack`'s) as tensors in the ensemble's device and dtype."""
        return tuple(torch.as_tensor(a, dtype=self.dtype, device=self.device) for a in arrays)

    def unpack(self, q, ph):
        """Super-grid states (tensors or arrays) → (B, NE, ny, nx), (B, NW, ny, nx) numpy."""
        host = lambda a: a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        q, ph = host(q), host(ph)
        qm = np.stack([q[:, self._member_rows(m), :] for m in range(self.n_members)])
        pm_ = np.stack([ph[:, self._member_rows(m), :] for m in range(self.n_members)])
        return qm, pm_

    def thermal_phonons(self, bath_temperatures: np.ndarray) -> np.ndarray:
        """(B,) bath temperatures → (B, NW, ny, nx) thermal member states."""
        ny, nx = self.member_shape
        out = np.empty((self.n_members, self.num_omega, ny, nx))
        for m, t in enumerate(np.asarray(bath_temperatures)):
            out[m] = thermal_phonon_occupation(self.omega_bins, float(t))[:, None, None]
        return out

    def generation_plane(self, rates: np.ndarray) -> np.ndarray:
        """(B,) per-member injection rates → a (Y, nx) super-grid plane
        (zeros on the separator rows) for :meth:`make_chunk`."""
        out = np.zeros(self.super_shape, dtype=np.float64)
        for m, r in enumerate(np.broadcast_to(np.asarray(rates), (self.n_members,))):
            out[self._member_rows(m), :] = float(r)
        return out

    def make_chunk(
        self,
        n_steps: int,
        *,
        unroll: int = 8,
        gen_plane: np.ndarray | None = None,
        pulse_window: tuple[float, float] | None = None,
        photon=None,
        photon_occupancy: np.ndarray | None = None,
        photon_coupling: np.ndarray | None = None,
    ):
        """A chunk advancing ``n_steps`` steps: a loop that launches the
        step's kernels and never waits for the card.  ``unroll`` is taken
        and ignored (a scan-unroll lever of the TPU).

        With ``gen_plane`` (a (Y, nx) per-pixel rate plane, see
        :meth:`generation_plane`) each step injects dt·g forward-Euler
        before the Strang step (the reference's external-generation
        contract) — e.g. a per-member pulse-energy sweep.
        ``pulse_window=(start, duration)`` gates the source in time;
        ``start``/``duration`` may be scalars or (B,) arrays for per-member
        photon arrival times.  The returned chunk then takes
        ``(q, ph, t0_ns)``; with a ``pulse_window`` the start time is
        REQUIRED — chaining chunks with an implicit t0=0 would silently
        re-fire the pulse at the start of every chunk.  Without
        ``gen_plane`` the chunk is ``(q, ph)``.  Step times are t0 + k·dt in
        the state dtype, as the JAX chunk forms them.

        ``photon=PhotonDriveSpec(...)`` adds the Fischer-2024 photon-drive
        substep after the generation add (the engine's operator order);
        ``photon_occupancy`` / ``photon_coupling`` are optional (B,)
        per-member overrides riding as n̄/weight planes — a Q-vs-n̄
        calibration curve becomes ONE ensemble step.  Per-member gaps use
        the Δ²-affine per-pixel substep automatically.  A windowed drive
        requires the absolute chunk start time like ``pulse_window``.
        """
        del unroll
        step = self.step
        n_steps = int(n_steps)

        if photon is None and (
            photon_occupancy is not None or photon_coupling is not None
        ):
            raise ValueError(
                "photon_occupancy/photon_coupling need photon=PhotonDriveSpec"
            )

        if gen_plane is None and photon is None:
            if pulse_window is not None:
                raise ValueError("pulse_window requires gen_plane (the rate plane)")

            def chunk(q, ph):
                for _ in range(n_steps):
                    q, ph = step(q, ph)
                return q, ph

            return chunk

        if not self.dt:
            raise ValueError("generation chunks need the ensemble dt (build_film_ensemble sets it)")
        dt = float(self.dt)
        b = self.n_members

        gp_host = None if gen_plane is None else np.asarray(gen_plane, dtype=np.float64)
        if pulse_window is not None:
            if gp_host is None:
                raise ValueError("pulse_window requires gen_plane (the rate plane)")
            # scalars or (B,) per-member windows, broadcast to planes so the
            # gate is a per-pixel compare (members fire at their own times)
            starts = np.broadcast_to(
                np.asarray(pulse_window[0], np.float64), (self.n_members,)
            )
            durations = np.broadcast_to(
                np.asarray(pulse_window[1], np.float64), (self.n_members,)
            )
            start_host = self.generation_plane(starts)
            end_host = self.generation_plane(starts + durations)
        else:
            start_host = end_host = None

        # --- photon drive (Fischer 2024): build the plan host-side once ---
        ph_window = None
        ph_plan = None
        ph_weight_host = ph_nbar_host = ph_delta2_host = ph_rho_host = None
        ph_per_pixel = False
        if photon is not None:
            if isinstance(photon, (list, tuple)):
                raise ValueError(
                    "multi-tone photon drives are not supported on the "
                    "ensemble path; pass one PhotonDriveSpec (chain chunks "
                    "for sequential tones)"
                )
            photon.validate()
            if not photon.enabled:
                raise ValueError("photon spec has mode='none' — pass None instead")
            if self.gaps is None:
                raise ValueError("this FilmEnsemble predates photon support")
            coup = np.broadcast_to(
                np.asarray(
                    photon.coupling if photon_coupling is None else photon_coupling,
                    np.float64,
                ),
                (b,),
            )
            # the weight plane carries the (per-member) coupling c; the
            # plans below are built with coupling=1 so rate = amp·weight
            ph_weight_host = self.generation_plane(coup)
            if photon_occupancy is not None:
                ph_nbar_host = self.generation_plane(
                    np.broadcast_to(np.asarray(photon_occupancy, np.float64), (b,))
                )
            gaps = self.gaps
            ph_per_pixel = not bool(np.all(gaps == gaps[0]))
            if ph_per_pixel:
                from ..ops.photon_drive import build_photon_drive_plan_analytic

                ph_plan = build_photon_drive_plan_analytic(
                    E_bins=self.E_bins,
                    dE=self.dE,
                    omega=photon.photon_energy,
                    coupling=1.0,
                    occupancy=float(photon.occupancy),
                    include_scattering=photon.include_scattering,
                    include_pair_breaking=photon.include_pair_breaking,
                )
                ph_delta2_host = self.generation_plane(gaps**2)
                ph_rho_host = np.zeros(
                    (self.num_energy_bins, *self.super_shape), dtype=np.float64
                )
                for m, g in enumerate(gaps):
                    ph_rho_host[:, self._member_rows(m), :] = dynes_density_of_states(
                        self.E_bins, float(g), self.dynes_gamma
                    )[:, None, None]
            else:
                from ..ops.photon_drive import build_photon_drive_plan

                ph_plan = build_photon_drive_plan(
                    E_bins=self.E_bins,
                    dE=self.dE,
                    gap=float(gaps[0]),
                    rho=dynes_density_of_states(
                        self.E_bins, float(gaps[0]), self.dynes_gamma
                    ),
                    omega=photon.photon_energy,
                    coupling=1.0,
                    occupancy=float(photon.occupancy),
                    include_scattering=photon.include_scattering,
                    include_pair_breaking=photon.include_pair_breaking,
                )
            if photon.window_start is not None:
                ph_window = (
                    float(photon.window_start),
                    float(photon.window_start) + float(photon.window_duration),
                )

        needs_t0 = start_host is not None or ph_window is not None
        by_dtype: dict = {}  # (photon substep, device planes) once per dtype

        def prepared(dtype: torch.dtype, device: torch.device):
            """The photon substep and the planes on the card, built once per dtype."""
            if dtype not in by_dtype:
                up = lambda a: None if a is None else torch.as_tensor(a, dtype=dtype, device=device)
                psub = None
                if ph_plan is not None:
                    from ..ops.photon_drive import make_photon_substep, make_photon_substep_per_pixel

                    make = make_photon_substep_per_pixel if ph_per_pixel else make_photon_substep
                    psub = make(ph_plan, dt, dtype, device)
                extra = (up(ph_delta2_host), up(ph_rho_host)) if ph_per_pixel else ()
                by_dtype[dtype] = (psub, up(gp_host), up(start_host), up(end_host),
                                   up(ph_weight_host), up(ph_nbar_host), extra)
            return by_dtype[dtype]

        def run(q, ph, t0=None):
            if t0 is None:
                if needs_t0:
                    raise TypeError(
                        "this chunk gates a time window: pass its absolute start "
                        "time, chunk(q, ph, t0_ns) — an implicit t0=0 would "
                        "re-fire the window at the start of every chained chunk"
                    )
                t0 = 0.0
            psub, gpa, sp, ep, weight, nbar, extra = prepared(q.dtype, q.device)
            np_dtype = np.float64 if q.dtype == torch.float64 else np.float32
            t0_d, dt_d = np_dtype(t0), np_dtype(dt)
            for k in range(n_steps):
                t = float(t0_d + np_dtype(k) * dt_d)  # t0 + k·dt in the state dtype
                if gpa is not None:
                    if sp is not None:
                        q = q + torch.where((sp <= t) & (ep > t), dt * gpa, 0.0)
                    else:
                        q = q + dt * gpa
                if psub is not None:
                    on = ph_window is None or (np_dtype(ph_window[0]) <= t < np_dtype(ph_window[1]))
                    q = psub(q, 1.0 if on else 0.0, weight, *extra, nbar=nbar)
                q, ph = step(q, ph)
            return q, ph

        return run


def build_film_ensemble(
    *,
    n_members: int,
    member_shape: tuple[int, int] = (64, 64),
    gap: np.ndarray | float = 180.0,
    num_energy_bins: int = 8,
    energy_max_factor: float = 4.0,
    D0: float = 6.0,
    tau_s: np.ndarray | float = 440.0,
    tau_r: np.ndarray | float = 440.0,
    T_c: float = 1.2,
    dt: float = 0.05,
    dtype: torch.dtype = torch.float32,
    dynes_gamma: float = 0.0,
    device="cuda",
) -> FilmEnsemble:
    """Build a Strang step over a B-member film ensemble (reflective walls).

    ``tau_s``/``tau_r``/``gap`` may be scalars or (B,) arrays — per-member
    values become per-member physics.  The collision half takes, on the
    card: per-member gaps with uniform τ → the analytic-gap kernel K4 on the
    Δ plane; uniform τ and gap → K3; per-member τ → per-member tables
    selected by a member-id plane (``make_collision_step``: K3 with gap ids
    for up to 8 members, K5's column walk with int32 member ids beyond).
    Per-member gaps also give per-member variable-D diffusion.  The
    diffusion is ``ADIDiffusion``, whose solves reach K10 through
    ``tridiag_solve``.  The energy grid is built once from the largest
    member gap so every bin sits above every member's gap.  K3 and K4 run
    float64 too (the JAX package keeps float64 off its TPU kernels, a
    Mosaic limit the card does not have).
    """
    dev = _device(device)
    ny, nx = member_shape
    b = int(n_members)
    tau_s = np.broadcast_to(np.asarray(tau_s, dtype=np.float64), (b,))
    tau_r = np.broadcast_to(np.asarray(tau_r, dtype=np.float64), (b,))
    gaps = np.broadcast_to(np.asarray(gap, dtype=np.float64), (b,))
    gaps_vary = not bool(np.all(gaps == gaps[0]))
    gap_nom = float(gaps.max())

    # members stacked along y with one masked-off separator row between them
    gapped = np.zeros(((ny + 1) * b - 1, nx), dtype=bool)
    for m in range(b):
        gapped[m * (ny + 1) : m * (ny + 1) + ny, :] = True
    edges = extract_edge_segments(gapped)
    bcs = {e.edge_id: BoundaryCondition(kind="reflective") for e in edges}

    E_bins, dE = build_energy_grid(gap_nom, 1.0, energy_max_factor, num_energy_bins)
    pmap = build_phonon_frequency_map(E_bins)
    rho = dynes_density_of_states(E_bins, gap_nom, dynes_gamma)

    x_st, y_st = build_directional_stencils(gapped, edges, bcs, 1.0)
    if gaps_vary:
        # per-member D(E, Δ_m): per-bin planes, harmonic-mean interfaces
        gap_plane = np.full(gapped.shape, gap_nom)
        for m in range(b):
            gap_plane[m * (ny + 1) : m * (ny + 1) + ny, :] = gaps[m]
        D_dense = np.stack(
            [
                D0 * np.sqrt(np.maximum(0.0, 1.0 - (gap_plane / e) ** 2))
                for e in E_bins
            ]
        )
        op = fold_diffusion(x_st, y_st, gapped, 1.0, D_dense)
    else:
        op = fold_diffusion(
            x_st, y_st, gapped, 1.0, diffusion_coefficient_of_energy(D0, E_bins, gap_nom)
        )
    diff = ADIDiffusion(op, dev, dtype).make_step(dt)

    uniform_taus = bool(np.all(tau_s == tau_s[0]) and np.all(tau_r == tau_r[0]))
    if gaps_vary and uniform_taus:
        # per-member gaps: exact per-pixel kernels from the Δ² plane (K4)
        col_half = build_collision_step_analytic(
            E_bins=E_bins, dE=dE, gap_plane=gap_plane, pmap=pmap, dt=0.5 * dt,
            tau_s=float(tau_s[0]), tau_r=float(tau_r[0]), T_c=T_c, dynes_gamma=dynes_gamma,
            update_phonons=True, device=dev, dtype=dtype,
        )
    elif uniform_taus:
        # identical member kernels: K3 on a uniform gap
        col_half = build_collision_step(
            E_bins=E_bins, dE=dE, rho=rho,
            K_s0=scattering_kernel_base(E_bins, gap_nom, float(tau_s[0]), T_c),
            K_r0=recombination_kernel_base(E_bins, gap_nom, float(tau_r[0]), T_c),
            pmap=pmap, dt=0.5 * dt, update_phonons=True, device=dev, dtype=dtype,
        )
    else:
        # per-member (gap, τ) kernel stacks selected by the member-id plane
        member_id = np.zeros(gapped.shape, dtype=np.int32)
        for m in range(b):
            member_id[m * (ny + 1) : m * (ny + 1) + ny, :] = m
        plan = build_collision_plan_arrays(
            dE=dE,
            rho=np.stack(
                [dynes_density_of_states(E_bins, float(g), dynes_gamma) for g in gaps]
            ),
            K_r0=np.stack(
                [
                    recombination_kernel_base(E_bins, float(g), float(t), T_c)
                    for g, t in zip(gaps, tau_r)
                ]
            ),
            K_s0=np.stack(
                [
                    scattering_kernel_base(E_bins, float(g), float(t), T_c)
                    for g, t in zip(gaps, tau_s)
                ]
            ),
            gap_id=member_id,
            pmap=pmap,
            enable_recombination=True,
            enable_scattering=True,
            update_phonons=True,
            device=dev,
            dtype=dtype,
            pixel_chunk=gapped.size,
        )
        col_half = make_collision_step(plan, 0.5 * dt)

    def step(q, ph):
        q, ph = col_half(q, ph)
        q = diff(q)
        q, ph = col_half(q, ph)
        return q, ph

    return FilmEnsemble(
        step=step,
        n_members=b,
        member_shape=(ny, nx),
        super_shape=gapped.shape,
        num_energy_bins=num_energy_bins,
        num_omega=pmap.num_omega,
        E_bins=E_bins,
        omega_bins=pmap.omega_bins,
        dE=dE,
        dt=float(dt),
        gaps=gaps,
        dynes_gamma=float(dynes_gamma),
        device=dev,
        dtype=dtype,
        collision_half=col_half,
    )
