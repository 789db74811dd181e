"""The port's benchmark (``qpsim_tpu_torch.bench``) against the root ``bench.py``.

* its stages, their order, their sizes and the smoke sizes are the JAX
  bench's (read from ``bench.py`` with ``ast``);
* its pieces from the same seeds equal the JAX bench's after three steps
  in float64 on the CPU (≤ 1e-10 scaled): the coupled film and the wire
  (``_coupled_pieces``), the masked donut's diffusion, the analytic-gap
  substep at 6 and 72 bins and the 72-bin table substep, the JAX side
  through ``bench.py``'s own calls (its Pallas kernels in interpret mode);
* its contract: ``QPSIM_BENCH_SMOKE=1 python -m qpsim_tpu_torch bench
  --device cpu`` prints one JSON line of every stage and exits 0; no card
  and no ``--device cpu`` → ``"error": "cuda_unavailable"``, exit 2; a
  stage that raises → ``stage_errors``, exit 1; the watchdog → ``"error":
  "deadline"``, exit 1.
"""

import ast
import io
import json
import os
import subprocess
import sys
from contextlib import redirect_stdout
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import bench as j_bench  # noqa: E402

from qpsim_tpu_torch import bench, cli  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
F64 = torch.float64


def _main_node() -> ast.FunctionDef:
    tree = ast.parse((REPO / "bench.py").read_text())
    return next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")


def _assigned(name: str) -> ast.AST:
    return next(n.value for n in ast.walk(_main_node()) if isinstance(n, (ast.Assign, ast.AnnAssign))
                and getattr(n.targets[0] if isinstance(n, ast.Assign) else n.target, "id", None) == name)


def _jax_stages() -> list[tuple[str, str]]:
    """(stage name, function name) of ``bench.py``'s ``stages`` list."""
    return [(e.elts[0].value, e.elts[1].id) for e in _assigned("stages").elts]


def _jax_smoke_kw() -> dict:
    node = _assigned("smoke_kw")
    return {k.value: {kw.arg: ast.literal_eval(kw.value) for kw in v.keywords}
            for k, v in zip(node.keys, node.values)}


def _signature(fn_name: str) -> dict:
    """{parameter: default} of a function of ``bench.py``, read with ``ast``."""
    tree = ast.parse((REPO / "bench.py").read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == fn_name)
    args = fn.args.args
    return {a.arg: ast.literal_eval(d) for a, d in zip(args[len(args) - len(fn.args.defaults):], fn.args.defaults)}


def _scaled(got, ref) -> float:
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref, dtype=np.float64)
    return float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))


# ---------------------------------------------------------------- the stages


def test_stage_names_and_order_are_the_jax_benchs():
    assert [name for name, _ in bench.STAGES] == [name for name, _ in _jax_stages()]
    assert len(bench.STAGES) == 15


def test_smoke_sizes_are_the_jax_benchs():
    assert bench.SMOKE_KW == _jax_smoke_kw()


@pytest.mark.parametrize("name", [name for name, _ in _jax_stages()])
def test_stage_takes_the_jax_stage_parameters_and_defaults(name):
    """Each stage function takes the JAX one's parameters with its defaults
    (the full sizes and lengths), plus a keyword-only ``device``."""
    import inspect

    j_fn = dict(_jax_stages())[name]
    t_fn = dict(bench.STAGES)[name]
    if name == "scalar_cn_1024":  # both wrap the headline stage
        assert t_fn is bench._headline
        t_fn = bench.bench_scalar_cn_1024
        j_fn = "bench_scalar_cn_1024"
    assert t_fn.__name__ == j_fn
    params = inspect.signature(t_fn).parameters
    ours = {k: p.default for k, p in params.items() if p.kind is not p.KEYWORD_ONLY}
    assert ours == _signature(j_fn)
    assert params["device"].kind is params["device"].KEYWORD_ONLY and params["device"].default == "cuda"


# ---------------------------------------------------------------- parity of the pieces


def _strang3(diff, col, q, ph, steps=3):
    for _ in range(steps):
        q, ph = col(q, ph)
        q = diff(q)
        q, ph = col(q, ph)
    return q, ph


@pytest.mark.parametrize("shape", [(8, 8, 6), (1, 32, 6)], ids=["film", "wire"])
def test_coupled_pieces_match_the_jax_bench(shape):
    ny, nx, ne = shape
    j_diff, j_aux, j_col, j_q, j_ph = j_bench._coupled_pieces(ny, nx, ne, 0.05, jnp.float64)
    diff, col, q0, ph0 = bench._coupled_pieces(ny, nx, ne, 0.05, F64, "cpu")
    np.testing.assert_array_equal(q0.numpy(), np.asarray(j_q))
    np.testing.assert_array_equal(ph0.numpy(), np.asarray(j_ph))
    j_step = jax.jit(lambda q, ph: _strang3(lambda u: j_diff(u, j_aux), j_col, q, ph, steps=1))
    want = (j_q, j_ph)
    for _ in range(3):
        want = j_step(*want)
    got = _strang3(diff, col, q0, ph0)
    assert _scaled(got[0], want[0]) <= 1e-10
    assert _scaled(got[1], want[1]) <= 1e-10


def test_donut_diffusion_matches_the_jax_bench():
    """The masked donut of ``masked_512`` at 64², built call for call as
    ``bench.bench_masked_512`` builds it, three steps of dt 0.1."""
    from qpsim_tpu.geometry.mask import extract_edge_segments
    from qpsim_tpu.geometry.raster import rasterize_polygons
    from qpsim_tpu.models.params import BoundaryCondition
    from qpsim_tpu.ops.diffusion import build_directional_stencils, fold_diffusion

    n = 64
    ang = np.linspace(0, 2 * np.pi, 24, endpoint=False)
    outer = np.column_stack([n / 2 + 0.46 * n * np.cos(ang), n / 2 + 0.46 * n * np.sin(ang)])
    inner = np.column_stack(
        [n / 2 + 0.18 * n * np.cos(ang[::-1]), n / 2 + 0.18 * n * np.sin(ang[::-1])]
    )
    mask = rasterize_polygons([outer, inner], np.arange(n) + 0.5, np.arange(n) + 0.5)
    edges = extract_edge_segments(mask)
    bcs = {}
    for e in edges:
        r = np.hypot(0.5 * (e.x0 + e.x1) - n / 2, 0.5 * (e.y0 + e.y1) - n / 2)
        bcs[e.edge_id] = BoundaryCondition(kind="absorbing" if r > 0.32 * n else "reflective")
    x_st, y_st = build_directional_stencils(mask, edges, bcs, 1.0)
    op = fold_diffusion(x_st, y_st, mask, 1.0, 6.0)
    one, daux = j_bench._best_diffusion(op, jnp.float64).make_step_aux(0.1)

    t_op, t_mask = bench._donut_operator(n)
    np.testing.assert_array_equal(t_mask, mask)
    assert 0.0 < mask.mean() < 1.0
    step = bench._best_diffusion(t_op, F64, "cpu").make_step(0.1)
    u0 = np.zeros((1, n, n))
    u0[0][mask] = 1.0
    u, want = torch.as_tensor(u0), jnp.asarray(u0)
    one = jax.jit(one)
    for _ in range(3):
        u, want = step(u), one(want, daux)
    assert _scaled(u, want) <= 1e-10


def _jax_analytic(ny, nx, ne, low, high, rho_gap, blocked):
    """``bench_analytic_gap[_100bin]``'s JAX substep and state, call for call."""
    from qpsim_tpu.ops.dos import dynes_density_of_states, thermal_phonon_occupation
    from qpsim_tpu.ops.energy_grid import build_energy_grid
    from qpsim_tpu.ops.pallas_collisions import build_pallas_collision_step_analytic
    from qpsim_tpu.ops.pallas_collisions_blocked import build_pallas_collision_step_blocked_analytic
    from qpsim_tpu.ops.phonon_map import build_phonon_frequency_map

    gap, tau, tc = 180.0, 440.0, 1.2
    E, dE = build_energy_grid(gap, 1.0, 4.0, ne)
    pm = build_phonon_frequency_map(E)
    rng = np.random.default_rng(5)
    gp = gap + rng.uniform(low, high, (ny, nx))
    build = build_pallas_collision_step_blocked_analytic if blocked else build_pallas_collision_step_analytic
    col = build(E_bins=E, dE=dE, gap_plane=gp, pmap=pm, dt=0.025, tau_s=tau, tau_r=tau, T_c=tc, dynes_gamma=0.0,
                interpret=jax.default_backend() != "tpu")
    rho = dynes_density_of_states(E, rho_gap, 0.0)
    q0 = jnp.asarray(rng.uniform(0, 1e-5, (ne, ny, nx)) * rho[:, None, None], jnp.float64)
    ph0 = jnp.asarray(np.broadcast_to(thermal_phonon_occupation(pm.omega_bins, 0.2)[:, None, None],
                                      (pm.num_omega, ny, nx)).copy(), jnp.float64)
    return col, q0, ph0


def _jax_table(ny, nx, ne):
    """``bench_collisions_100bin``'s JAX substep and state, call for call."""
    from qpsim_tpu.ops.dos import dynes_density_of_states, thermal_phonon_occupation
    from qpsim_tpu.ops.energy_grid import build_energy_grid
    from qpsim_tpu.ops.kernels import recombination_kernel_base, scattering_kernel_base
    from qpsim_tpu.ops.pallas_collisions import build_pallas_collision_step
    from qpsim_tpu.ops.phonon_map import build_phonon_frequency_map

    gap, tau, tc = 180.0, 440.0, 1.2
    E, dE = build_energy_grid(gap, 1.0, 4.0, ne)
    pm = build_phonon_frequency_map(E)
    rho = dynes_density_of_states(E, gap, 0.0)
    col = build_pallas_collision_step(
        E_bins=E, dE=dE, rho=rho, K_s0=scattering_kernel_base(E, gap, tau, tc),
        K_r0=recombination_kernel_base(E, gap, tau, tc), pmap=pm, dt=0.025, tile=512,
        interpret=jax.default_backend() != "tpu",
    )
    rng = np.random.default_rng(2)
    q0 = jnp.asarray(rng.uniform(0, 1e-5, (ne, ny, nx)) * rho[:, None, None], jnp.float64)
    ph0 = jnp.asarray(np.broadcast_to(thermal_phonon_occupation(pm.omega_bins, 0.2)[:, None, None],
                                      (pm.num_omega, ny, nx)).copy(), jnp.float64)
    return col, q0, ph0


@pytest.mark.parametrize("stage", ["analytic_gap", "analytic_gap_100bin", "collisions_100bin"])
def test_collision_pieces_match_the_jax_bench(stage):
    """Three substeps at ``SMOKE_KW``'s 8 × 8 × 6 (K4's form) and 8 × 8 × 72 (K6's, K5's)."""
    kw = bench.SMOKE_KW[stage]
    ny, nx, ne = kw["ny"], kw["nx"], kw["ne"]
    if stage == "collisions_100bin":
        j_col, j_q, j_ph = _jax_table(ny, nx, ne)
        col, q, ph = bench._table_pieces(ny, nx, ne, F64, "cpu")
    else:
        low, high, rho_gap = (-50.0, 0.0, 155.0) if stage.endswith("100bin") else (-50.0, 20.0, 180.0)
        j_col, j_q, j_ph = _jax_analytic(ny, nx, ne, low, high, rho_gap, blocked=ne > 64)
        col, q, ph = bench._analytic_pieces(ny, nx, ne, low, high, rho_gap, F64, "cpu")
    np.testing.assert_array_equal(q.numpy(), np.asarray(j_q))
    np.testing.assert_array_equal(ph.numpy(), np.asarray(j_ph))
    j_col = jax.jit(j_col)
    for _ in range(3):
        q, ph = col(q, ph)
        j_q, j_ph = j_col(j_q, j_ph)
    assert _scaled(q, j_q) <= 1e-10
    assert _scaled(ph, j_ph) <= 1e-10


# ---------------------------------------------------------------- the contract

#: what ``tests/test_bench.py`` requires of the JAX bench's smoke line
JAX_SMOKE_KEYS = ("coupled_1024_ms_per_step", "coupled_1024_ms_per_step_exact_strang", "sharded_overhead_1dev",
                  "collisions_100bin_ms_per_substep", "snapshot_overlap_dense_over_sparse",
                  "mkid_pulse_10k_steps_wallclock_s")

#: every stage's keys, as the JAX bench names them (its two v5e peak
#: fractions replaced by the H100 bound shares)
STAGE_KEYS = {
    "scalar_cn_1024": ("value", "vs_baseline"),
    "mkid_pulse": ("mkid_pulse_10k_steps_wallclock_s",),
    "coupled_full_scale": ("coupled_1024_ms_per_step", "coupled_1024_ms_per_step_exact_strang"),
    "rooflines": ("collision_substep_1024_ms", "collision_model_ops_per_s", "collision_bound_share",
                  "collision_bound_by", "adi_1024_ms_per_step", "adi_model_bytes_per_s", "adi_bound_share",
                  "adi_bound_by"),
    "sharded_overhead": ("sharded_1dev_ms_per_step", "sharded_overhead_1dev", "sharded_wang_1dev_ms_per_step",
                         "sharded_merged_1dev_ms_per_step"),
    "snapshot_overlap": ("engine_mkid_10k_store_sparse_s", "engine_mkid_10k_store_dense_s",
                         "engine_mkid_10k_store_dense_light_s", "snapshot_overlap_dense_over_sparse",
                         "snapshot_light_dense_over_sparse"),
    "collisions_100bin": ("collisions_100bin_ms_per_substep",),
    "collisions_50bin": ("collisions_50bin_ms_per_substep", "collisions_50bin_pixels_per_s"),
    "coupled_2d": ("coupled_2d_ms_per_step", "collision_pixels_per_s", "collision_vs_reference"),
    "masked_512": ("masked_512_cell_steps_per_s",),
    "analytic_gap": ("analytic_gap_ms_per_substep",),
    "analytic_gap_100bin": ("analytic_gap_100bin_ms_per_substep",),
    "coupled_1d_64bin": ("coupled_1d_64bin_ms_per_step", "coupled_1d_64bin_cell_steps_per_s"),
    "ensemble_sweep": ("ensemble_members", "ensemble_ms_per_step", "ensemble_member_steps_per_s"),
    "diff_grad": ("diffgrad_ms_per_step", "diffgrad_over_forward"),
}


def _run_cli(env_extra: dict, *args) -> subprocess.CompletedProcess:
    env = dict(os.environ, OMP_NUM_THREADS="1", **env_extra)
    return subprocess.run([sys.executable, "-m", "qpsim_tpu_torch", "bench", *args], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=600)


def _one_line(stdout: str) -> dict:
    lines = [ln for ln in stdout.splitlines() if ln.strip()]
    assert len(lines) == 1, stdout
    return json.loads(lines[0])


def test_smoke_runs_every_stage_on_the_cpu():
    r = _run_cli({"QPSIM_BENCH_SMOKE": "1"}, "--device", "cpu")
    assert r.returncode == 0, r.stderr[-3000:]
    payload = _one_line(r.stdout)
    assert payload.get("smoke") is True
    assert "stage_errors" not in payload, payload["stage_errors"]
    assert "error" not in payload
    assert payload["metric"] == "cell-steps/sec (2D CN, 1024^2 grid)" and payload["unit"] == "cell-steps/s"
    assert payload["value"] > 0 and payload["vs_baseline"] > 0
    for key in JAX_SMOKE_KEYS:
        assert key in payload, key
    for stage, keys in STAGE_KEYS.items():
        for key in keys:
            assert key in payload, (stage, key)
    assert payload["collision_bound_by"] in ("bytes", "operations")
    assert payload["adi_bound_by"] in ("bytes", "operations")
    assert payload["backend"] == "cpu" and payload["card"] is None
    # every stage's launch counters, all zero on the CPU (the plain versions)
    assert payload["kernels"] == {name: {} for name, _ in bench.STAGES}
    for stage, _ in bench.STAGES:  # each stage logs its wall time
        assert f"stage {stage}: " in r.stderr


def test_no_card_without_device_cpu_exits_2(monkeypatch):
    """Whether a card is present is decided here, not at import: the check
    is made to see none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for run in (lambda: bench.main([]), lambda: cli.main(["bench"]), lambda: cli.main(["bench", "--device", "cuda"])):
        out = io.StringIO()
        with redirect_stdout(out):
            rc = run()
        assert rc == 2
        payload = _one_line(out.getvalue())
        assert payload["error"] == "cuda_unavailable" and payload["value"] == 0.0


def test_a_failing_stage_is_named_and_exits_1(monkeypatch):
    def broken(**kw):
        raise RuntimeError("stage broken on purpose")

    stages = [(name, broken if name == "masked_512" else fn) for name, fn in bench.STAGES]
    monkeypatch.setattr(bench, "STAGES", stages)
    monkeypatch.setenv("QPSIM_BENCH_SMOKE", "1")
    out = io.StringIO()
    with redirect_stdout(out):
        rc = bench.main(["--device", "cpu"])
    assert rc == 1
    payload = _one_line(out.getvalue())
    assert payload["stage_errors"] == {"masked_512": "RuntimeError: stage broken on purpose"}
    assert "masked_512_cell_steps_per_s" not in payload
    for stage, keys in STAGE_KEYS.items():
        if stage != "masked_512":
            assert all(k in payload for k in keys), stage
    assert set(payload["kernels"]) == {name for name, _ in bench.STAGES}


def test_the_deadline_prints_what_was_measured_and_exits_1():
    r = _run_cli({"QPSIM_BENCH_SMOKE": "1", "QPSIM_BENCH_DEADLINE_S": "1.5"}, "--device", "cpu")
    assert r.returncode == 1, r.stderr[-2000:]
    payload = _one_line(r.stdout)
    assert payload["error"] == "deadline"
    assert "diffgrad_ms_per_step" not in payload  # the last stage did not run
