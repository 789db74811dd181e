"""K10's gradient and the two repairs, against ``qpsim_tpu`` in float64 on the CPU.

``ThomasSolve`` (``ops/tridiag_cuda.py``: K10 forward, K10 on the
transposed system backward; on CPU tensors the plain Thomas sweep both
ways) is held to ``jax.grad`` of the JAX package's ``tridiag_solve`` at
≤ 1e-10: rows and ``tridiag_solve_along(-2, …)``, broadcast planes, NaN in
the entries a solve ignores, lines of 1 and 2 cells.  JAX cannot
differentiate ``tridiag_solve_pallas`` (its ``pallas_call`` has no
transpose rule), so there only the forward is held.  ``"auto"``'s route is
pinned by ``solver_route``, and every kernel wrapper without a backward
refuses an input that requires grad.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from qpsim_tpu.ops import tridiag as jt  # noqa: E402
from qpsim_tpu.ops.pallas_tridiag import tridiag_solve_pallas  # noqa: E402

from qpsim_tpu_torch.ops import tridiag as tt  # noqa: E402
from qpsim_tpu_torch.ops import tridiag_cuda  # noqa: E402

F64 = torch.float64


@pytest.fixture
def restore_solvers():
    yield
    jt.set_default_solver("auto")
    tt.set_default_solver("auto")


def _lines(shape, seed=0, nan_ends=True, axis=-1):
    rng = np.random.default_rng(seed)
    sub = rng.uniform(-0.3, -0.1, shape)
    sup = rng.uniform(-0.3, -0.1, shape)
    diag = rng.uniform(2.0, 3.0, shape)
    rhs = rng.uniform(-1.0, 1.0, shape)
    if nan_ends:  # entries the solves along ``axis`` never read
        np.moveaxis(sub, axis, -1)[..., 0] = np.nan
        np.moveaxis(sup, axis, -1)[..., -1] = np.nan
    return sub, diag, sup, rhs


def _grads_both(arrays, weights, along=None):
    """jax.grad and ThomasSolve's gradients of Σ w·x for the four inputs."""
    def j_loss(*t):
        x = jt.tridiag_solve(*t) if along is None else jt.tridiag_solve_along(along, *t)
        return jnp.sum(x * weights)

    jg = jax.grad(j_loss, argnums=(0, 1, 2, 3))(*(jnp.asarray(a) for a in arrays))
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    x = tt.tridiag_solve(*ts) if along is None else tt.tridiag_solve_along(along, *ts)
    (x * torch.as_tensor(weights)).sum().backward()
    return [np.asarray(g) for g in jg], [t.grad.numpy() for t in ts]


def _close(got, want, tol):
    scale = max(float(np.max(np.abs(want))), 1e-300)
    assert float(np.max(np.abs(got - want))) / scale <= tol


@pytest.mark.parametrize(
    "shape,along",
    [((3, 5, 7), None), ((3, 7, 5), -2), ((4, 1), None), ((4, 2), None), ((2, 3, 2), -2)],
    ids=["rows", "along_minus2", "n1", "n2", "n2_along"],
)
def test_thomas_solve_gradients_match_jax_grad(shape, along):
    axis = -1 if along is None else along
    arrays = _lines(shape, seed=len(shape) + shape[-1], axis=axis)
    w = np.random.default_rng(9).uniform(-1.0, 1.0, shape)
    jg, tg = _grads_both(arrays, w, along)
    for a, b in zip(jg, tg):
        assert np.all(np.isfinite(b))
        _close(b, a, 1e-10)
    if shape[axis] > 1:  # the unread ends get exactly zero
        assert np.all(np.moveaxis(tg[0], axis, -1)[..., 0] == 0.0)
        assert np.all(np.moveaxis(tg[2], axis, -1)[..., -1] == 0.0)


def test_thomas_solve_gradients_reduce_to_broadcast_planes():
    sub, diag, sup, rhs = _lines((3, 4, 6), seed=3, nan_ends=False)
    planes = (sub[:1], diag[0, :1], sup[:1, :1])  # (1, 4, 6), (1, 6), (1, 1, 6)
    w = np.random.default_rng(4).uniform(-1.0, 1.0, rhs.shape)
    full = [np.broadcast_to(p, rhs.shape) for p in planes]
    jg = jax.grad(lambda a, b, c, r: jnp.sum(jt.tridiag_solve(jnp.broadcast_to(a, r.shape),
                                                              jnp.broadcast_to(b, r.shape),
                                                              jnp.broadcast_to(c, r.shape), r) * w),
                  argnums=(0, 1, 2, 3))(*(jnp.asarray(a) for a in (*planes, rhs)))
    ts = [torch.tensor(a, requires_grad=True) for a in (*planes, rhs)]
    # as the differentiable simulation hands them: expanded views
    x = tt.tridiag_solve(*(t.expand(rhs.shape) for t in ts[:3]), ts[3])
    (x * torch.as_tensor(w)).sum().backward()
    for a, t in zip(jg, ts):
        assert t.grad.shape == t.shape
        _close(t.grad.numpy(), np.asarray(a), 1e-10)
    # and given as they are, unexpanded: the Function sums them back itself
    ts2 = [torch.tensor(a, requires_grad=True) for a in (*planes, rhs)]
    (tridiag_cuda.ThomasSolve.apply(*ts2) * torch.as_tensor(w)).sum().backward()
    for t, t2 in zip(ts, ts2):
        _close(t2.grad.numpy(), t.grad.numpy(), 1e-14)
    assert np.array_equal(tt.tridiag_solve(*(torch.tensor(a) for a in full), torch.tensor(rhs)).numpy(),
                          x.detach().numpy())


def test_thomas_solve_forward_matches_pallas_interpret_and_launches_nothing():
    arrays = _lines((2, 6, 40), seed=5)
    ref = np.asarray(tridiag_solve_pallas(*(jnp.asarray(a) for a in arrays), interpret=True))
    before = dict(tridiag_cuda.LAUNCHES)
    got = tridiag_cuda.ThomasSolve.apply(*(torch.tensor(a, requires_grad=True) for a in arrays))
    got.sum().backward()
    _close(got.detach().numpy(), ref, 1e-10)
    assert tridiag_cuda.LAUNCHES == before


def test_auto_routes_to_the_kernel_on_the_card_and_plain_thomas_on_the_cpu(restore_solvers):
    route = tt.solver_route
    assert route("auto", "cuda") == "kernel" and route("pallas", "cuda") == "kernel"
    assert route("auto", "cpu") == "kernel"  # ThomasSolve: its plain Thomas sweep
    for name in ("thomas", "pcr", "wang"):
        assert route(name, "cuda") == name and route(name, "cpu") == name
    with pytest.raises(ValueError, match="Unknown"):
        route("cusparse", "cuda")
    with pytest.raises(ValueError, match="'cpu' or 'cuda'"):
        route("auto", "meta")
    arrays = [torch.as_tensor(a) for a in _lines((8, 9000, 12), seed=1)]  # beyond the old 8192-line rule
    before = dict(tridiag_cuda.LAUNCHES)
    np.testing.assert_array_equal(tt.tridiag_solve(*arrays).numpy(), tt.tridiag_solve_thomas(*arrays).numpy())
    assert tridiag_cuda.LAUNCHES == before


def _refusal_cases():
    """(name, call) of every kernel wrapper without a backward, on CPU inputs of which one requires grad."""
    from qpsim_tpu_torch.ops import adi_cuda, adi_sep_cuda, collisions_blocked_cuda, collisions_cuda
    from qpsim_tpu_torch.ops.adi_sep import SepFactors
    from qpsim_tpu_torch.ops.collisions import build_analytic_plan, build_collision_plan_arrays
    from qpsim_tpu_torch.ops.collisions_loop_cuda import build_collision_step_loop
    from qpsim_tpu_torch.ops.collisions_rows_cuda import build_collision_step_rows
    from qpsim_tpu_torch.ops.column_walk import launch_column_walk
    from qpsim_tpu_torch.ops.diffusion import build_directional_stencils, fold_diffusion
    from qpsim_tpu_torch.ops.dos import dynes_density_of_states
    from qpsim_tpu_torch.ops.energy_grid import build_energy_grid
    from qpsim_tpu_torch.ops.kernels import recombination_kernel_base, scattering_kernel_base
    from qpsim_tpu_torch.ops.phonon_map import build_phonon_frequency_map
    from qpsim_tpu_torch.geometry.mask import extract_edge_segments
    from qpsim_tpu_torch.models.params import BoundaryCondition

    E, dE = build_energy_grid(180.0, 1.0, 4.0, 6)
    pm = build_phonon_frequency_map(E)
    rho = dynes_density_of_states(E, 180.0, 0.0)
    ks, kr = scattering_kernel_base(E, 180.0, 440.0, 1.2), recombination_kernel_base(E, 180.0, 440.0, 1.2)
    plan = build_collision_plan_arrays(dE=dE, rho=rho, K_r0=kr, K_s0=ks, pmap=pm, enable_recombination=True,
                                       enable_scattering=True, update_phonons=True, device="cpu", dtype=F64)
    aplan, atab = build_analytic_plan(E_bins=E, dE=dE, gap_plane=np.full((4, 5), 175.0), pmap=pm, tau_s=440.0,
                                      tau_r=440.0, T_c=1.2, dynes_gamma=0.0, update_phonons=True,
                                      device="cpu", dtype=F64)
    q = torch.full((6, 4, 5), 1e-5, dtype=F64, requires_grad=True)
    ph = torch.zeros((pm.num_omega, 4, 5), dtype=F64)
    mask = np.ones((16, 16), dtype=bool)  # K1's packs need Wang chunks on both axes
    edges = extract_edge_segments(mask)
    bcs = {e.edge_id: BoundaryCondition(kind="reflective") for e in edges}
    op = fold_diffusion(*build_directional_stencils(mask, edges, bcs, 1.0), mask, 1.0, np.full(6, 3.0))
    planes = adi_cuda.AdiPlanes.from_operator(op, "cpu", F64)
    sep = SepFactors.build(op, 0.1, "cpu", F64)
    u = torch.ones((6, 16, 16), dtype=F64, requires_grad=True)
    lines = torch.ones((6, 4, 5), dtype=F64, requires_grad=True)
    one = torch.ones((1, 4, 5), dtype=F64)
    loop = build_collision_step_loop(E_bins=E, dE=dE, rho=rho, K_s0=ks, K_r0=kr, pmap=pm, dt=0.05, device="cpu")
    rows = build_collision_step_rows(E_bins=E, dE=dE, rho=rho, K_s0=ks, K_r0=kr, pmap=pm, dt=0.05, device="cpu")
    return {
        "K3": lambda: collisions_cuda.collision_step(plan, None, q, ph, 0.05),
        "K4": lambda: collisions_cuda.collision_step_analytic(aplan, atab, None, q, ph, 0.05),
        "K5": lambda: collisions_blocked_cuda.collision_step_blocked(plan, None, q, ph, 0.05),
        "K6": lambda: collisions_blocked_cuda.collision_step_blocked_analytic(aplan, atab, None, q, ph, 0.05),
        "K8": lambda: loop(q, ph),
        "K9": lambda: rows(q, ph),
        "column_walk": lambda: launch_column_walk(None, q, ph, 0.05, None, True),
        "K2_x": lambda: adi_cuda.adi_x_half(u, planes, 0.05),
        "K2_y": lambda: adi_cuda.adi_y_half(u, planes, 0.05),
        "K7": lambda: adi_cuda.solve_lines(lines, one, one, one, torch.ones(6, dtype=F64), alpha=0.05),
        "K1_x": lambda: adi_sep_cuda.adi_sep_x(u, sep),
        "K1_y": lambda: adi_sep_cuda.adi_sep_y(u, sep),
    }


def test_kernel_wrappers_without_a_backward_refuse_inputs_that_require_grad():
    cases = _refusal_cases()
    for name, call in cases.items():
        with pytest.raises(RuntimeError, match="has no backward") as info:
            call()
        assert "plain version" in str(info.value), name
    with torch.no_grad():  # grad mode off: the plain versions run as before
        for name in ("K3", "K4", "K5", "K6", "K8", "K9", "K2_x", "K2_y", "K7", "K1_x", "K1_y"):
            cases[name]()
