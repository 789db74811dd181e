"""Entry points: the flagship step on one device, and a dry run on a mesh.

Port of the JAX package's root ``__graft_entry__.py``.

``entry()`` returns ``(fn, (q0, ph0))``: ``fn(q, ph) -> (q, ph)`` is one
forward step of the flagship model — the energy-resolved coupled
quasiparticle–phonon step, Strang split C(dt/2) D(dt) C(dt/2) — on a 256²
film with 16 energy bins.  On the card it runs the collision substep on
K3 (its pair walk) and the diffusion on K2 (``CudaADI`` composed with
collisions); ``fn.plain`` is the same step on the kernels' plain versions.

``dryrun_multichip(n)`` builds an (ensemble × space) mesh of n cells and
runs the sharded step (``parallel.sharded``) on tiny shapes in three legs:
members over 'ensemble' and rows over 'space' (when n is even and ≥ 4),
a fused generation plane, and the merged-Strang pieces, each checked for
finite values and positive mass.  Its cells are this process's devices of
the asked type (``parallel.mesh.local_devices``), repeated up to n when
there are fewer: four cells of one card run as four shards of it.

``python -m qpsim_tpu_torch.graft_entry [--device cuda|cpu]`` runs both,
the dry run over every local device.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

__all__ = ["entry", "dryrun_multichip"]


def _coupled_ingredients(ny, nx, ne):
    """The flagship physics on an ny × nx rectangle (host arrays): mask,
    operator, the collisions dict of ``build_sharded_step``, the phonon
    map, dE, ρ and the float64 state (q from ``default_rng(0)``)."""
    from .geometry.mask import extract_edge_segments
    from .models.params import BoundaryCondition
    from .ops.diffusion import build_directional_stencils, fold_diffusion
    from .ops.dos import diffusion_coefficient_of_energy, dynes_density_of_states, thermal_phonon_occupation
    from .ops.energy_grid import build_energy_grid
    from .ops.kernels import recombination_kernel_base, scattering_kernel_base
    from .ops.phonon_map import build_phonon_frequency_map

    gap, tau, tc, tbath, d0 = 180.0, 440.0, 1.2, 0.2, 6.0
    mask = np.ones((ny, nx), dtype=bool)
    edges = extract_edge_segments(mask)
    bcs = {e.edge_id: BoundaryCondition(kind="reflective") for e in edges}
    E, dE = build_energy_grid(gap, 1.0, 4.0, ne)
    pm = build_phonon_frequency_map(E)
    rho = dynes_density_of_states(E, gap, 0.0)
    x_st, y_st = build_directional_stencils(mask, edges, bcs, 1.0)
    op = fold_diffusion(x_st, y_st, mask, 1.0, diffusion_coefficient_of_energy(d0, E, gap))
    collisions = dict(
        E_bins=E, dE=dE, rho=rho,
        K_r0=recombination_kernel_base(E, gap, tau, tc), K_s0=scattering_kernel_base(E, gap, tau, tc),
        pmap=pm, enable_recombination=True, enable_scattering=True, update_phonons=True,
    )
    rng = np.random.default_rng(0)
    q0 = rng.uniform(0, 1e-4, (ne, ny, nx))
    ph0 = np.broadcast_to(thermal_phonon_occupation(pm.omega_bins, tbath)[:, None, None],
                          (pm.num_omega, ny, nx)).copy()
    return mask, op, collisions, pm, dE, rho, q0, ph0


def entry(device="cuda", dtype: torch.dtype = torch.float32):
    """``(fn, (q0, ph0))``: the 256² × 16 coupled forward step and its state on ``device``."""
    from .ops.adi_cuda import adi_step_plain
    from .ops.collisions_cuda import build_collision_step
    from .solver.diffusion_backends import CudaADI

    ny = nx = 256
    ne, dt = 16, 0.05
    _, op, c, pm, dE, rho, q0, ph0 = _coupled_ingredients(ny, nx, ne)
    col_half = build_collision_step(E_bins=c["E_bins"], dE=dE, rho=rho, K_s0=c["K_s0"], K_r0=c["K_r0"], pmap=pm,
                                    dt=0.5 * dt, update_phonons=True, device=device, dtype=dtype)
    adi = CudaADI(op, device, dtype, coupled=True)
    diff_step = adi.make_step(dt)

    def forward_step(q, ph):
        q, ph = col_half(q, ph)
        q = diff_step(q)
        return col_half(q, ph)

    def plain(q, ph):
        q, ph = col_half.plain(q, ph)
        q = adi_step_plain(q, adi.planes, 0.5 * dt)
        return col_half.plain(q, ph)

    forward_step.plain = plain
    as_t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    return forward_step, (as_t(q0), as_t(ph0))


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """An (ensemble × space) mesh of ``n_devices`` cells; a two-step chunk of
    the sharded step, the fused-generation step and the merged-Strang
    pieces on tiny shapes, each checked for finite values and positive mass."""
    from .parallel.mesh import local_devices, make_mesh
    from .parallel.sharded import build_sharded_step

    devices = local_devices(device)
    cells = [devices[i % len(devices)] for i in range(n_devices)]
    n_ensemble = 2 if (n_devices % 2 == 0 and n_devices >= 4) else 1
    n_space = n_devices // n_ensemble
    mesh = make_mesh(n_space=n_space, n_ensemble=n_ensemble, devices=cells)

    dtype = torch.float32
    ny = nx = 8 * n_space
    ne, dt = 4, 0.05
    _, op, collisions, _, _, _, q0, ph0 = _coupled_ingredients(ny, nx, ne)
    sharded = build_sharded_step(mesh, op, dt, collisions=collisions, dtype=dtype, ensemble=n_ensemble > 1)
    if n_ensemble > 1:
        batch = 2 * n_ensemble
        q = sharded.shard(np.broadcast_to(q0, (batch, *q0.shape)), dtype)
        ph = sharded.shard(np.broadcast_to(ph0, (batch, *ph0.shape)), dtype)
    else:
        q, ph = sharded.shard(q0, dtype), sharded.shard(ph0, dtype)
    q, ph, mass = sharded.make_chunk(2, unroll=1)(q, ph)
    assert all(bool(torch.isfinite(t).all()) for t in q), "multichip dry run produced non-finite state"
    assert bool((torch.as_tensor(mass) > 0).all()), "multichip dry run lost all mass"

    # second leg: the fused-generation sharded step (space-only sharding),
    # the pulse-injection path
    gen_sharded = build_sharded_step(mesh, op, dt, collisions=collisions, dtype=dtype, gen_input=True)
    qg, phg = gen_sharded.shard(q0, dtype), gen_sharded.shard(ph0, dtype)
    grow = gen_sharded.shard(np.full((ny, nx), 1e-6 * dt), dtype)
    qg, phg, mass_g = gen_sharded.make_chunk(2, unroll=1)(qg, phg, grow)
    assert all(bool(torch.isfinite(t).all()) for t in qg), "gen-input dry run produced non-finite state"
    assert float(mass_g) > 0.0, "gen-input dry run lost all mass"

    # third leg: the merged-Strang pieces (the engine's mesh default),
    # C(dt/2) [D C(dt)]^(L−1) D C(dt/2) over two steps
    pieces = build_sharded_step(mesh, op, dt, collisions=collisions, dtype=dtype, pieces=True)
    assert pieces.apply_col_half is not None and pieces.apply_diffuse is not None
    raw, src = pieces.aux
    qm, phm = pieces.shard(q0, dtype), pieces.shard(ph0, dtype)
    qm, phm = pieces.apply_col_half(qm, phm, raw)
    qm = pieces.apply_diffuse(qm, raw, src)
    qm, phm = pieces.apply_col_full(qm, phm, raw)
    qm = pieces.apply_diffuse(qm, raw, src)
    qm, phm = pieces.apply_col_half(qm, phm, raw)
    assert all(bool(torch.isfinite(t).all()) for t in qm), "merged-pieces dry run produced non-finite state"


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="python -m qpsim_tpu_torch.graft_entry", description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    device = parser.parse_args(argv).device
    from .parallel.mesh import local_devices

    fn, args = entry(device)
    out = fn(*args)
    if device == "cuda":
        torch.cuda.synchronize()
    print("entry() ok:", [tuple(o.shape) for o in out])
    n = len(local_devices(device))
    dryrun_multichip(n, device)
    print(f"dryrun_multichip({n}) ok")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
