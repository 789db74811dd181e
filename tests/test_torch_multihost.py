"""Two processes on gloo: the port's distributed mesh and a coupled step across them.

The counterpart of ``tests/test_multihost.py``.  Two OS processes (this
file run as a script: the child below, which imports neither JAX nor
``qpsim_tpu``) join one ``torch.distributed`` group on a free localhost
port through ``qpsim_tpu_torch.parallel.mesh.initialize_distributed``,
build ``make_multihost_mesh()`` (one ensemble group per process), split
and gather a batch across the processes and sum it across them over a
mesh whose space axis spans both; then each takes 5 coupled
``ShardedStep`` steps with the space axis across both processes, with
the pencil and the Wang y solve — halos by ``batch_isend_irecv``, pencils
by ``all_to_all_single``, interface rows by ``all_gather``, the mass by
``all_reduce`` — and saves its shard.  The parent holds each process's
shard to the JAX single-chip step on the same inputs (1e-10).
"""

from __future__ import annotations

import socket
import subprocess
import sys
from pathlib import Path

import numpy as np

_REPO = Path(__file__).resolve().parent.parent
GAP, TAU, TC, TBATH, DT = 180.0, 440.0, 1.2, 0.2, 0.05
NY, NX, NE, STEPS = 8, 8, 4, 5


def _inputs(pmap_omega_bins):
    """The seeded state both sides start from (numpy only)."""
    from qpsim_tpu_torch.ops.dos import thermal_phonon_occupation

    rng = np.random.default_rng(42)
    q0 = rng.uniform(0, 1e-4, (NE, NY, NX))
    occ = thermal_phonon_occupation(pmap_omega_bins, TBATH)
    ph0 = np.broadcast_to(occ[:, None, None], (occ.size, NY, NX)).copy()
    return q0, ph0


def _child(coordinator: str, n: int, rank: int, out: str) -> int:
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(_REPO))
    from qpsim_tpu_torch.geometry.mask import extract_edge_segments
    from qpsim_tpu_torch.models.params import BoundaryCondition
    from qpsim_tpu_torch.ops.diffusion import build_directional_stencils, fold_diffusion
    from qpsim_tpu_torch.ops.dos import dynes_density_of_states
    from qpsim_tpu_torch.ops.energy_grid import build_energy_grid
    from qpsim_tpu_torch.ops.kernels import recombination_kernel_base, scattering_kernel_base
    from qpsim_tpu_torch.ops.phonon_map import build_phonon_frequency_map
    from qpsim_tpu_torch.parallel.mesh import (
        ENSEMBLE_AXIS,
        SPACE_AXIS,
        initialize_distributed,
        make_multihost_mesh,
        state_sharding,
    )
    from qpsim_tpu_torch.parallel.sharded import build_sharded_step

    torch.set_num_threads(1)
    initialize_distributed(coordinator_address=coordinator, num_processes=n, process_id=rank, backend="gloo")
    initialize_distributed(coordinator_address=coordinator, num_processes=n, process_id=rank)  # a no-op
    assert dist.get_world_size() == n and dist.get_rank() == rank

    # the default layout: one ensemble group per process
    mesh = make_multihost_mesh()
    assert mesh.shape == {ENSEMBLE_AXIS: n, SPACE_AXIS: 1}, mesh.shape
    split = state_sharding(mesh, ensemble=True)
    batch = np.stack([np.full((3, 2, 4), float(i + 1)) for i in range(n)])
    mine = split.shard(batch, torch.float64)
    assert float(mine[0].max()) == rank + 1
    assert torch.equal(split.gather(mine), torch.as_tensor(batch))  # across the processes

    # the space axis across the processes: a cross-process sum, then a coupled step
    mesh_sp = make_multihost_mesh(n_space=n, n_ensemble=1)
    assert mesh_sp.cells == [(0, rank)]
    total = mesh_sp.exchange.psum([mine[0].sum()])[0]
    assert float(total) == 3 * 2 * 4 * sum(range(1, n + 1)), float(total)
    mask = np.ones((NY, NX), dtype=bool)
    edges = extract_edge_segments(mask)
    bcs = {e.edge_id: BoundaryCondition(kind="reflective") for e in edges}
    E, dE = build_energy_grid(GAP, 1.0, 3.0, NE)
    pm = build_phonon_frequency_map(E)
    xs, ys = build_directional_stencils(mask, edges, bcs, 1.0)
    op = fold_diffusion(xs, ys, mask, 1.0, 6.0 * np.sqrt(np.maximum(0.0, 1.0 - (GAP / E) ** 2)))
    collisions = dict(
        dE=dE, rho=dynes_density_of_states(E, GAP, 0.0), K_r0=recombination_kernel_base(E, GAP, TAU, TC),
        K_s0=scattering_kernel_base(E, GAP, TAU, TC), pmap=pm, enable_recombination=True,
        enable_scattering=True, update_phonons=True,
    )
    q0, ph0 = _inputs(pm.omega_bins)
    saved = {}
    for y_solve in ("pencil", "wang"):
        sh = build_sharded_step(mesh_sp, op, DT, collisions=collisions, dtype=torch.float64, y_solve=y_solve)
        q, ph = sh.shard(q0), sh.shard(ph0)
        for _ in range(STEPS):
            q, ph, mass = sh.step(q, ph)
        saved[f"q_{y_solve}"], saved[f"ph_{y_solve}"] = q[0].numpy(), ph[0].numpy()
        saved[f"mass_{y_solve}"] = float(mass)
        assert torch.equal(sh.gather(q)[:, rank * NY // n:(rank + 1) * NY // n], q[0])
    np.savez(out, **saved)
    dist.destroy_process_group()
    print(f"TORCH_MULTIHOST_OK process={rank}", flush=True)
    return 0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_gloo_mesh_psum_and_coupled_step(tmp_path):
    import jax
    import jax.numpy as jnp
    from qpsim_tpu.geometry.mask import extract_edge_segments
    from qpsim_tpu.models.params import BoundaryCondition
    from qpsim_tpu.ops.collisions import build_collision_plan_arrays, make_collision_step
    from qpsim_tpu.ops.diffusion import build_directional_stencils, fold_diffusion
    from qpsim_tpu.ops.dos import dynes_density_of_states
    from qpsim_tpu.ops.energy_grid import build_energy_grid
    from qpsim_tpu.ops.kernels import recombination_kernel_base, scattering_kernel_base
    from qpsim_tpu.ops.phonon_map import build_phonon_frequency_map
    from qpsim_tpu.solver.diffusion_backends import ADIDiffusion

    n = 2
    coordinator = f"127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen([sys.executable, __file__, coordinator, str(n), str(i), str(tmp_path / f"{i}.npz")],
                              cwd=_REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for i in range(n)]
    outputs = []
    try:
        for p in procs:
            outputs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for i, (p, out) in enumerate(zip(procs, outputs)):
        assert p.returncode == 0, f"process {i} failed:\n{out}"
        assert f"TORCH_MULTIHOST_OK process={i}" in out, out

    # the JAX single-chip oracle: C(dt/2) D(dt) C(dt/2)
    mask = np.ones((NY, NX), dtype=bool)
    edges = extract_edge_segments(mask)
    bcs = {e.edge_id: BoundaryCondition(kind="reflective") for e in edges}
    E, dE = build_energy_grid(GAP, 1.0, 3.0, NE)
    pm = build_phonon_frequency_map(E)
    rho = dynes_density_of_states(E, GAP, 0.0)
    Kr, Ks = recombination_kernel_base(E, GAP, TAU, TC), scattering_kernel_base(E, GAP, TAU, TC)
    xs, ys = build_directional_stencils(mask, edges, bcs, 1.0)
    op = fold_diffusion(xs, ys, mask, 1.0, 6.0 * np.sqrt(np.maximum(0.0, 1.0 - (GAP / E) ** 2)))
    plan = build_collision_plan_arrays(
        dE=dE, rho_by_gap=rho[None], K_r0_by_gap=Kr[None], K_s0_by_gap=Ks[None],
        gap_id=np.zeros((NY, NX), np.int32), pmap=pm,
        enable_recombination=True, enable_scattering=True, update_phonons=True,
    )
    col_half = make_collision_step(plan, 0.5 * DT)
    diff = ADIDiffusion(op, dtype=jnp.float64).make_step(DT)

    @jax.jit
    def single(q, ph):
        q, ph = col_half(q, ph)
        q = diff(q)
        return col_half(q, ph)

    q0, ph0 = _inputs(pm.omega_bins)
    q, ph = jnp.asarray(q0), jnp.asarray(ph0)
    for _ in range(STEPS):
        q, ph = single(q, ph)
    q, ph = np.asarray(q), np.asarray(ph)
    m = NY // n
    for i in range(n):
        got = np.load(tmp_path / f"{i}.npz")
        for y_solve in ("pencil", "wang"):
            np.testing.assert_allclose(got[f"q_{y_solve}"], q[:, i * m:(i + 1) * m], rtol=0, atol=1e-10)
            np.testing.assert_allclose(got[f"ph_{y_solve}"], ph[:, i * m:(i + 1) * m], rtol=0, atol=1e-10)
            assert abs(float(got[f"mass_{y_solve}"]) - float(q.sum())) < 1e-10


if __name__ == "__main__":
    raise SystemExit(_child(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]))
