"""The spatially sharded Strang step: the grid split by rows over a mesh's 'space' axis.

The counterpart of ``qpsim_tpu.parallel.sharded``.  The dense state
(NE, Ny, Nx) is split by rows; each of a process's cells (shards) holds
(NE, Ny/K, Nx).  A step is a sequence of stages over the process's shards,
each the work between two collectives of the mesh's exchange
(:mod:`.mesh`):

* collisions are pixel-local: no communication;
* the explicit L_y of the x half needs a one-row halo from each neighbour;
* the x half's implicit solve is local (rows are whole in x);
* the implicit y solve needs whole columns: a pencil transpose
  (``all_to_all``: rows → columns, solve, back) or the distributed Wang
  partition (one ``all_gather`` of a few interface rows, a redundant
  interface sweep on every shard, a local back-substitution);
* the mass sums over the shards (``psum``).

Every shard's launches go on the current stream, one shard after another.
The local work runs on the card's kernels: the collision substep on K3/K5
(uniform gap) or on K4/K6 with each shard's slice of the gap plane passed
at call time (``ops.collisions_cuda.build_collision_step_analytic(gap_plane=None)``);
the line solves on K7 (``ops.adi_cuda.solve_lines``): the x half on the
shard's rows swapped to (NB, Nx, Ny/K), the pencil y half on its columns,
and the Wang partition's local solve D (and, without prefactored planes,
its A and C) on the shard's block with the couplings to its neighbours
cut.  On the CPU every wrapper runs its plain version; the tridiagonal
backend 'xla' (and 'auto' on the CPU) runs the JAX package's recurrences
in plain torch instead of K7.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from ..ops.adi_cuda import _apply_dir, solve_lines
from ..ops.collisions import build_collision_plan_arrays, make_collision_step
from ..ops.collisions_blocked_cuda import kernel_forms
from ..ops.diffusion import SplitOperator
from ..ops.dos import dynes_density_of_states
from ..ops.kernels import recombination_kernel_base, scattering_kernel_base
from ..ops.tridiag import (
    _wang_unlayout,
    tridiag_solve,
    tridiag_solve_along,
    wang_apply_interface,
    wang_apply_rhs,
    wang_eliminate,
    wang_externals,
    wang_factor,
    wang_interface_sweep,
)
from .mesh import SPACE_AXIS, Mesh, StateSharding

__all__ = ["CALL_TIME_PLANE_DEVICES", "ShardedStep", "build_sharded_step"]

#: device types whose gap maps run the collision kernel with each shard's
#: gap plane passed at call time (K4/K6); elsewhere the per-gap tables
#: take each shard's gap ids, as the JAX package's CPU branch does
CALL_TIME_PLANE_DEVICES = ("cuda",)


def _halo_apply_y(ex, u: list, a_lo: list, a_hi: list, diag: list) -> list:
    """L_y u on rows-split blocks, with one halo row from each neighbour."""
    above, below = ex.halo([t[:, -1:, :] for t in u], [t[:, :1, :] for t in u])
    return [lo * torch.cat([ab, t[:, :-1, :]], dim=1) + hi * torch.cat([t[:, 1:, :], be], dim=1) + d * t
            for t, ab, be, lo, hi, d in zip(u, above, below, a_lo, a_hi, diag)]


def _wang_finish(ex, D: list, A: list, C: list, sweeps: list) -> list:
    """x = D − A·X_L − C·X_R on every shard (layout (NB, m, Nx)), the
    externals from each shard's boundary unknowns ``sweeps[i] = (Ls, Rs)``."""
    out = []
    for i, (Ls_Rs, (_, p)) in enumerate(zip(sweeps, ex.cells)):
        XLs, XRs = wang_externals(*Ls_Rs)
        out.append(D[i] - A[i] * XLs[p][:, None, :] - C[i] * XRs[p][:, None, :])
    return out


def _wang_solve_y(ex, rhs: list, ay_lo: list, ay_hi: list, ay_diag: list, alpha: float,
                  scale: list, k7: bool) -> list:
    """Distributed Wang solve of (I − α·L_y) x = rhs along the global y axis.

    Each shard is one Wang partition (``ops.tridiag.tridiag_solve_wang``
    with chunk = the shard's rows, K = the space axis): every unknown is
    x_i = D_i − A_i·X_L − C_i·X_R in terms of the neighbour shards'
    boundary values; one ``all_gather`` of six (NB, Nx) interface rows
    feeds the 2K-unknown interface sweep, computed on every shard, and a
    local back-substitution finishes.  The coupling to the shard above
    is zeroed only at the global top, that to the shard below only at the
    global bottom.  With ``k7`` one K7 launch of 3·NB lines on the shard's
    block (couplings cut: K7 never reads them) solves for D, A and C
    together: A = T⁻¹(a₀e₀), C = T⁻¹(c_{m−1}e_{m−1}); otherwise the
    elimination recurrences of ``wang_eliminate`` run.  ``scale`` is the
    per-bin factor (ones when the planes carry D).
    """
    k = ex.n_space
    cols = []
    D, A, C = [], [], []
    for i, (_, p) in enumerate(ex.cells):
        r = rhs[i]
        s = scale[i].reshape(-1, 1, 1)
        a = torch.broadcast_to(-alpha * s * ay_lo[i], r.shape)
        b = torch.broadcast_to(1.0 - alpha * s * ay_diag[i], r.shape)
        c = torch.broadcast_to(-alpha * s * ay_hi[i], r.shape)
        top = a[:, 0, :] if p > 0 else torch.zeros_like(a[:, 0, :])  # kill the global-boundary fill-ins
        bottom = c[:, -1, :] if p < k - 1 else torch.zeros_like(c[:, -1, :])
        if k7:
            nb = r.shape[0]
            e0 = torch.zeros_like(r)
            e0[:, 0, :] = top
            em = torch.zeros_like(r)
            em[:, -1, :] = bottom
            x = solve_lines(torch.cat([r, e0, em]).contiguous(), ay_lo[i], ay_diag[i], ay_hi[i],
                            scale[i].repeat(3).contiguous(), alpha=alpha)
            D.append(x[:nb])
            A.append(x[nb:2 * nb])
            C.append(x[2 * nb:])
        else:
            a = a.clone()
            a[:, 0, :] = top
            c = c.clone()
            c[:, -1, :] = bottom
            Ci, Ai, Di = wang_eliminate(*(t.movedim(1, 0) for t in (a, b, c, r)))
            D.append(Di.movedim(0, 1))
            A.append(Ai.movedim(0, 1))
            C.append(Ci.movedim(0, 1))
        cols.append(torch.stack([A[i][:, 0], C[i][:, 0], D[i][:, 0], A[i][:, -1], C[i][:, -1], D[i][:, -1]]))
    sweeps = [wang_interface_sweep(g[:, 0], g[:, 1], g[:, 2], g[:, 3], g[:, 4], g[:, 5], k)
              for g in ex.all_gather(cols)]
    return _wang_finish(ex, D, A, C, sweeps)


def _wang_apply_y_prefactored(ex, rhs: list, raw: dict, alpha: float, k7: bool) -> list:
    """Prefactored distributed Wang y-solve: the rhs recurrences only.

    The CN coefficients are time-invariant, so each shard's elimination
    factors (``wfp_cp/m/inv/C/A``) and the interface sweep's coefficient
    parts (``wfp_if``) are built once; per step only D is solved for —
    by K7 on the shard's block (couplings cut) with ``k7``, by the
    recurrences of :func:`~qpsim_tpu_torch.ops.tridiag.wang_apply_rhs`
    otherwise — and two interface rows are gathered.
    """
    k = ex.n_space
    D = []
    for i, r in enumerate(rhs):
        if k7:
            D.append(solve_lines(r.contiguous(), raw["ayl"][i], raw["ayd"][i], raw["ayh"][i], raw["scale"][i],
                                 alpha=alpha))
        else:
            to_scan = lambda t: t.movedim(1, 0)  # (NB, m, Nx) -> (m, NB, Nx)
            D.append(wang_apply_rhs(to_scan(r), to_scan(raw["wfp_m"][i]), to_scan(raw["wfp_inv"][i]),
                                    to_scan(raw["wfp_cp"][i])).movedim(0, 1))
    gathered = ex.all_gather([torch.stack([d[:, 0], d[:, -1]]) for d in D])  # (K, 2, NB, Nx)
    sweeps = []
    for g, wif in zip(gathered, raw["wfp_if"]):  # wif (6, K, NB, Nx): aL, aR, inv, q, w_pre, w_post
        sweeps.append(wang_apply_interface(g[:, 0], g[:, 1], *wif.unbind(0), k))
    return _wang_finish(ex, D, raw["wfp_A"], raw["wfp_C"], sweeps)


@dataclass
class ShardedStep:
    """A rows-sharded step: ``step(q, ph) -> (q, ph, mass)`` on per-shard lists.

    ``q``/``ph`` are lists of this process's shards in ``mesh.cells``
    order (:meth:`shard` makes them from a whole state, :meth:`gather`
    puts them back); ``mass`` is Σq·dx² over the whole grid, a 0-d tensor
    on the first shard's device — or, built with ``ensemble=True``, one
    per member of this process's ensemble groups.

    ``apply``/``aux`` are the step with its operator arrays as explicit
    arguments, ``apply(q, ph[, grow], raw, src)`` with ``aux = (raw,
    src)``: ``raw`` maps each plane's name to its per-shard list.  With
    ``pieces=True`` the merged-Strang callables are set as well.
    """

    mesh: Mesh
    step: Callable
    grid_shape: tuple[int, int]
    sharding: StateSharding
    apply: Callable = None  # (q, ph[, grow], raw, src) -> (q, ph, mass)
    aux: tuple = ()  # (raw, src)
    takes_gen: bool = False  # apply/step take a grow plane before aux
    # merged-Strang pieces (pieces=True, non-ensemble only): the engine's
    # mesh runner composes C(dt/2) [D C(dt)]^(L-1) D C(dt/2) from these
    apply_col_half: Callable | None = None  # (q, ph, raw) -> (q, ph)
    apply_col_half_gen: Callable | None = None  # (q, ph, grow, raw) -> (q, ph)
    apply_col_full: Callable | None = None  # (q, ph, raw) -> (q, ph)
    apply_col_full_gen: Callable | None = None  # (q, ph, grow, raw) -> (q, ph)
    apply_diffuse: Callable | None = None  # (q, raw, src) -> q

    def shard(self, x, dtype: torch.dtype | None = None) -> list[torch.Tensor]:
        """This process's shards of a whole state (or of a (Ny, Nx) plane)."""
        return self.sharding.shard(x, dtype)

    def gather(self, parts: list) -> torch.Tensor:
        """The whole state from its shards."""
        return self.sharding.gather(parts)

    def make_chunk(self, n_steps: int, *, unroll: int = 8) -> Callable:
        """``chunk(q, ph[, grow]) -> (q, ph, mass)``: ``n_steps`` steps, the mass
        of the last.  With ``gen_input`` the same grow plane (dt·g, per shard)
        is injected every step (a constant-rate source).  ``unroll`` is
        accepted for the JAX signature and unused: the steps run eagerly."""
        del unroll
        step = self.step

        def chunk(q, ph, *grow):
            mass = None
            for _ in range(n_steps):
                q, ph, mass = step(q, ph, *grow)
            return q, ph, mass

        return chunk


def build_sharded_step(
    mesh: Mesh,
    op: SplitOperator,
    dt: float,
    *,
    dx: float = 1.0,
    collisions: dict[str, Any] | None = None,
    dtype: torch.dtype = torch.float32,
    ensemble: bool = False,
    tridiag_backend: str = "auto",
    gen_input: bool = False,
    pieces: bool = False,
    y_solve: str = "pencil",
) -> ShardedStep:
    """Build a rows-sharded Strang step C(dt/2) D(dt) C(dt/2) over ``mesh``'s 'space' axis.

    ``op`` is the split diffusion operator (uniform per bin with
    ``bin_scale``, or per-bin planes); ``collisions`` an optional dict with
    ``dE, rho, K_r0, K_s0, pmap`` (uniform gap) and the toggles
    ``enable_recombination/enable_scattering/update_phonons`` (and
    ``pixel_chunk``), run on K3 to 64 bins and K5 beyond (their plain
    versions on the CPU).  A non-uniform gap map adds ``gap_plane`` (dense
    (Ny, Nx) Δ in µeV), ``E_bins``, ``T_c``, ``tau_s``/``tau_r`` and
    optionally ``dynes_gamma``: on CUDA each shard's slice of the plane
    feeds K4/K6 at call time; on the CPU the per-gap tables take each
    shard's gap ids, as in the JAX package's CPU branch (``rho/K_r0/K_s0``
    then only decide which channels exist).

    ``tridiag_backend``: 'auto' — K7 on CUDA (float32 and float64; the
    TPU's float32-only rule was Mosaic's), the plain recurrences on the
    CPU; 'pallas' — ``solve_lines`` everywhere (its plain version on the
    CPU); 'xla' — ``ops.tridiag.tridiag_solve`` and the plain Wang
    recurrences.  ``y_solve`` 'pencil' or 'wang' (prefactored when no
    lazy bin scale is in force: at most
    ``ADIDiffusion.MATERIALIZE_MAX_ELEMENTS`` coefficients fold the scale
    into the planes).  ``gen_input`` makes the step take a dense (Ny, Nx)
    dt·g plane, split like the state and fused into the collision kernel;
    ``pieces`` exposes the merged-Strang callables.  ``ensemble=True``:
    states carry a leading member axis split over 'ensemble'.
    """
    if gen_input and ensemble:
        raise ValueError("gen_input is not supported with ensemble=True")
    ny, nx = op.mask.shape
    n_space = mesh.shape[SPACE_AXIS]
    if ny % n_space or nx % n_space:
        raise ValueError(
            f"Grid {ny}x{nx} must divide by the {n_space}-way 'space' axis in "
            "both dimensions (rows for the x-sweep, columns for the pencil transpose)."
        )
    if tridiag_backend not in ("auto", "pallas", "xla"):
        raise ValueError(f"Unknown tridiag backend: {tridiag_backend!r}")
    if y_solve not in ("pencil", "wang"):
        raise ValueError(f"Unknown y_solve: {y_solve!r} (use 'pencil' or 'wang')")
    ex = mesh.exchange
    on_cuda = mesh.device_type == "cuda"
    k7 = tridiag_backend == "pallas" or (tridiag_backend == "auto" and on_cuda)
    alpha = 0.5 * float(dt)
    rows = StateSharding(mesh)
    cols = StateSharding(mesh, axis=-1)

    # fold bin_scale on the host below the single-device ADI backend's
    # budget; above it keep the unit-D geometry and multiply lazily
    from ..solver.diffusion_backends import ADIDiffusion

    eager = op.bin_scale is None or op.num_bins * ny * nx <= ADIDiffusion.MATERIALIZE_MAX_ELEMENTS

    def host(a):
        if eager:
            a = op.materialized(a)
        nb = max(a.shape[0], op.num_bins if eager else 1)
        return np.broadcast_to(np.asarray(a, dtype=np.float64), (nb, ny, nx))

    per_cell = lambda t: [t.to(d) for d in mesh.local_devices]
    if op.bin_scale is not None and not eager:
        scale_host = np.asarray(op.bin_scale, dtype=np.float64).reshape(-1)
        lazy = True
    else:  # the planes carry D (eager fold or per-bin planes): unit scale
        scale_host = np.ones(op.num_bins)
        lazy = False
    # the per-bin factor of every solve (ones when the planes carry D)
    raw: dict[str, list] = {"scale": per_cell(torch.as_tensor(scale_host, dtype=dtype))}
    for key, plane in (("axl", op.ax_lo), ("axh", op.ax_hi), ("axd", op.ax_diag),
                       ("ayl", op.ay_lo), ("ayh", op.ay_hi), ("ayd", op.ay_diag)):
        raw[key] = rows.shard(host(plane), dtype)
    if k7:  # x planes swapped for K7's lines along the middle axis, once
        for key in ("axl", "axh", "axd"):
            raw[key + "T"] = [t.transpose(-1, -2).contiguous() for t in raw[key]]
    if y_solve == "pencil":  # y planes split by columns for the transposed solve
        for key, plane in (("aylC", op.ay_lo), ("ayhC", op.ay_hi), ("aydC", op.ay_diag)):
            raw[key] = cols.shard(host(plane), dtype)
    src = rows.shard(host(op.source_total()), dtype)

    # --- collisions -------------------------------------------------------------
    # a substep is col(q, ph, aux, grow): aux the shard's gap plane or gap
    # ids (None on a uniform gap); grow the fused dt·g plane or None
    col_factory: Callable[[float], Callable] | None = None
    devices = {str(d): d for d in mesh.local_devices}
    gap_plane = None if collisions is None else collisions.get("gap_plane")
    if collisions is not None and gap_plane is not None:
        gap_plane = np.asarray(gap_plane, dtype=np.float64)
        if gap_plane.shape != (ny, nx):
            raise ValueError(f"gap_plane must have the dense grid shape ({ny}, {nx}); got {gap_plane.shape}")
        missing = [
            k for k in ("E_bins", "T_c")
            + (("tau_s",) if collisions.get("enable_scattering") else ())
            + (("tau_r",) if collisions.get("enable_recombination") else ())
            if collisions.get(k) is None
        ]
        if missing:
            raise ValueError(
                f"collisions with gap_plane requires {missing} in the dict "
                "(per-pixel kernels are built from the energy grid and taus)"
            )
        e_bins = np.asarray(collisions["E_bins"], dtype=np.float64)
        scat, rec = bool(collisions.get("enable_scattering")), bool(collisions.get("enable_recombination"))
        if mesh.device_type in CALL_TIME_PLANE_DEVICES:
            from ..ops.collisions_cuda import build_collision_step_analytic

            kw_an = dict(
                E_bins=e_bins, dE=collisions["dE"], gap_plane=None, pmap=collisions["pmap"],
                tau_s=collisions["tau_s"] if scat else None, tau_r=collisions["tau_r"] if rec else None,
                T_c=collisions["T_c"], dynes_gamma=collisions.get("dynes_gamma", 0.0),
                update_phonons=collisions.get("update_phonons", True), dtype=dtype,
            )

            def col_factory(sub_dt: float):
                steps = {k: build_collision_step_analytic(dt=float(sub_dt), device=d, **kw_an)
                         for k, d in devices.items()}
                return lambda q, ph, aux, grow: steps[str(q.device)](q, ph, aux, grow)

            raw["gap_aux"] = rows.shard(gap_plane, dtype)
        else:
            gamma = collisions.get("dynes_gamma", 0.0)
            unique_gaps = np.unique(gap_plane)
            gid_global = np.searchsorted(unique_gaps, gap_plane).astype(np.int32)
            per_gap = lambda fn, tau: np.stack([fn(e_bins, float(g), tau, collisions["T_c"]) for g in unique_gaps])
            plans = {k: build_collision_plan_arrays(
                dE=collisions["dE"],
                rho=np.stack([dynes_density_of_states(e_bins, float(g), gamma) for g in unique_gaps]),
                K_r0=per_gap(recombination_kernel_base, collisions["tau_r"]) if rec else None,
                K_s0=per_gap(scattering_kernel_base, collisions["tau_s"]) if scat else None,
                gap_id=np.zeros((ny // n_space, nx), np.int32),  # the local shape
                pmap=collisions["pmap"], enable_recombination=rec, enable_scattering=scat,
                update_phonons=collisions.get("update_phonons", True), device=d, dtype=dtype,
                pixel_chunk=collisions.get("pixel_chunk", 4096),
            ) for k, d in devices.items()}

            def col_factory(sub_dt: float):
                steps = {k: make_collision_step(p, float(sub_dt), gap_id_arg=True) for k, p in plans.items()}

                def col(q, ph, aux, grow):
                    if grow is not None:  # no fused input: the pre-add
                        q = q + grow[None].to(q.dtype)
                    return steps[str(q.device)](q, ph, aux)

                return col

            raw["gap_aux"] = rows.shard(gid_global)
    elif collisions is not None:  # K3 to 64 bins, K5 beyond, the generation fused
        plans = {k: build_collision_plan_arrays(
            dE=collisions["dE"], rho=np.asarray(collisions["rho"]),
            K_r0=None if collisions.get("K_r0") is None else np.asarray(collisions["K_r0"]),
            K_s0=None if collisions.get("K_s0") is None else np.asarray(collisions["K_s0"]),
            pmap=collisions["pmap"],
            enable_recombination=collisions.get("enable_recombination", False),
            enable_scattering=collisions.get("enable_scattering", False),
            update_phonons=collisions.get("update_phonons", True), device=d, dtype=dtype,
            pixel_chunk=collisions.get("pixel_chunk", 4096),
        ) for k, d in devices.items()}
        kernels = {}
        for k, p in plans.items():
            wrapper, tables_of = kernel_forms(p.num_energy_bins, 1, analytic=False)
            kernels[k] = (wrapper, p, tables_of(p) if p.active else None)

        def col_factory(sub_dt: float):
            sub_dt = float(sub_dt)

            def col(q, ph, aux, grow):
                wrapper, p, tables = kernels[str(q.device)]
                if not p.active:
                    return (q if grow is None else q + grow[None].to(q.dtype)), ph
                return wrapper(p, tables, q, ph, sub_dt, grow)

            return col

    col_half = col_factory(0.5 * float(dt)) if col_factory is not None else None

    # --- the prefactored Wang planes (eager coefficients only) ---------------------
    if y_solve == "wang" and not lazy:
        # the global operator's factors, once, on the first shard's device
        dev0 = mesh.local_devices[0]
        a_t = lambda a: torch.as_tensor(np.array(host(a)), dtype=dtype, device=dev0)
        ayl, ayd, ayh = a_t(op.ay_lo), a_t(op.ay_diag), a_t(op.ay_hi)
        fac = wang_factor(
            (-alpha * ayl).transpose(-1, -2), (1.0 - alpha * ayd).transpose(-1, -2),
            (-alpha * ayh).transpose(-1, -2), chunk=ny // n_space,
        )
        plane = lambda t: _wang_unlayout(t).transpose(-1, -2)  # (M, K, nb, nx) -> (nb, ny, nx)
        for key in ("cp", "m", "inv", "C", "A"):
            raw["wfp_" + key] = rows.shard(plane(fac[key]))
        wif = torch.stack([fac["if_aL"], fac["if_aR"], fac["if_inv"], fac["if_q"],
                           fac["if_w_pre"], fac["if_w_post"]])
        raw["wfp_if"] = per_cell(wif)

    def on_cells(parts: list) -> None:
        """Each shard on its cell's device: no step moves a shard quietly."""
        if len(parts) != len(mesh.cells) or any(t.device != d for t, d in zip(parts, mesh.local_devices)):
            raise ValueError(f"the step takes {len(mesh.cells)} shards on {[str(d) for d in mesh.local_devices]}, "
                             f"got {len(parts)} on {[str(t.device) for t in parts]}")

    def local_diffusion(u: list, raw: dict, s: list) -> list:
        on_cells(u)
        scale = raw["scale"]
        axl, axh, axd = raw["axl"], raw["axh"], raw["axd"]
        ayl, ayh, ayd = raw["ayl"], raw["ayh"], raw["ayd"]
        if lazy:
            sc = [t.reshape(-1, 1, 1) for t in scale]
            lz = lambda planes: [f * t for f, t in zip(sc, planes)]
            axl, axh, axd, ayl, ayh, ayd, s = map(lz, (axl, axh, axd, ayl, ayh, ayd, s))
        # x-implicit half: (I − αLx) u* = u + α·Ly u + α·s   (halo for Ly)
        ly = _halo_apply_y(ex, u, ayl, ayh, ayd)
        rhs = [t + alpha * l + alpha * si for t, l, si in zip(u, ly, s)]
        if k7:
            u_star = [solve_lines(r.transpose(-1, -2).contiguous(), raw["axlT"][i], raw["axdT"][i],
                                  raw["axhT"][i], scale[i], alpha=alpha).transpose(-1, -2)
                      for i, r in enumerate(rhs)]
        else:
            u_star = [tridiag_solve(-alpha * axl[i], 1.0 - alpha * axd[i], -alpha * axh[i], r)
                      for i, r in enumerate(rhs)]
        # y-implicit half: rhs local in x, then the cross-shard solve
        rhs2 = [t + alpha * _apply_dir(t, axl[i], axh[i], axd[i], -1) + alpha * s[i]
                for i, t in enumerate(u_star)]
        if y_solve == "wang":
            if "wfp_cp" in raw:
                return _wang_apply_y_prefactored(ex, rhs2, raw, alpha, k7)
            return _wang_solve_y(ex, rhs2, raw["ayl"], raw["ayh"], raw["ayd"], alpha, scale, k7)
        # pencil: rows → columns, a whole-column solve, columns → rows
        recv = ex.all_to_all([list(r.chunk(n_space, dim=-1)) for r in rhs2])
        rhs2_T = [torch.cat(parts, dim=-2) for parts in recv]
        if k7:
            u_T = [solve_lines(r.contiguous(), raw["aylC"][i], raw["aydC"][i], raw["ayhC"][i], scale[i],
                               alpha=alpha) for i, r in enumerate(rhs2_T)]
        else:
            u_T = []
            for i, r in enumerate(rhs2_T):
                f = scale[i].reshape(-1, 1, 1) if lazy else 1.0
                lo, di, hi = (f * raw[k][i] for k in ("aylC", "aydC", "ayhC"))
                u_T.append(tridiag_solve_along(-2, -alpha * lo, 1.0 - alpha * di, -alpha * hi, r))
        back = ex.all_to_all([list(t.chunk(n_space, dim=-2)) for t in u_T])
        return [torch.cat(parts, dim=-1) for parts in back]

    def collide(col, q: list, ph: list, raw: dict, grow: list | None) -> tuple[list, list]:
        on_cells(q)
        on_cells(ph)
        aux = raw.get("gap_aux")
        out = [col(q[i], ph[i], None if aux is None else aux[i], None if grow is None else grow[i])
               for i in range(len(q))]
        return [o[0] for o in out], [o[1] for o in out]

    def local_step(q: list, ph: list, raw: dict, s: list, grow: list | None = None):
        if col_half is not None:
            q, ph = collide(col_half, q, ph, raw, grow)
        elif grow is not None:
            q = [t + g[None].to(t.dtype) for t, g in zip(q, grow)]
        q = local_diffusion(q, raw, s)
        if col_half is not None:
            q, ph = collide(col_half, q, ph, raw, None)
        masses = [m * (dx * dx) for m in ex.psum([t.sum() for t in q])]
        return q, ph, masses

    piece_fns: dict[str, Callable] = {}
    if pieces and not ensemble and col_half is not None:
        col_full = col_factory(float(dt))
        piece_fns["apply_col_half"] = lambda q, ph, raw: collide(col_half, q, ph, raw, None)
        piece_fns["apply_col_full"] = lambda q, ph, raw: collide(col_full, q, ph, raw, None)
        piece_fns["apply_diffuse"] = local_diffusion
        if gen_input:
            piece_fns["apply_col_half_gen"] = lambda q, ph, grow, raw: collide(col_half, q, ph, raw, grow)
            piece_fns["apply_col_full_gen"] = lambda q, ph, grow, raw: collide(col_full, q, ph, raw, grow)

    if ensemble:
        # each shard holds a batch of independent members on a leading axis;
        # the same local step runs member by member
        def apply(q, ph, raw, s):
            outs = [local_step([t[b] for t in q], [t[b] for t in ph], raw, s)
                    for b in range(q[0].shape[0])]
            q_new = [torch.stack([o[0][i] for o in outs]) for i in range(len(q))]
            ph_new = [torch.stack([o[1][i] for o in outs]) for i in range(len(q))]
            # one mass per member of this process's ensemble groups, in member order
            dev0 = mesh.local_devices[0]
            first_of_row = {}
            for i, (e, _) in enumerate(ex.cells):
                first_of_row.setdefault(e, i)
            mass = torch.cat([torch.stack([o[2][i] for o in outs]).to(dev0)
                              for i in first_of_row.values()])
            return q_new, ph_new, mass
    elif gen_input:
        def apply(q, ph, grow, raw, s):
            q, ph, masses = local_step(q, ph, raw, s, grow=grow)
            return q, ph, masses[0]
    else:
        def apply(q, ph, raw, s):
            q, ph, masses = local_step(q, ph, raw, s)
            return q, ph, masses[0]

    aux = (raw, src)
    takes_gen = gen_input and not ensemble
    if takes_gen:
        step = lambda q, ph, grow: apply(q, ph, grow, *aux)
    else:
        step = lambda q, ph: apply(q, ph, *aux)
    return ShardedStep(
        mesh=mesh, step=step, grid_shape=(ny, nx), sharding=StateSharding(mesh, ensemble=ensemble),
        apply=apply, aux=aux, takes_gen=takes_gen, **piece_fns,
    )
