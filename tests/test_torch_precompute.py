"""The port's gap-map host layer equals the JAX package's, bit for bit.

``qpsim_tpu_torch.expr.safe_eval``, ``qpsim_tpu_torch.fields`` (gap maps)
and ``qpsim_tpu_torch.io.precompute`` are copies the port owns; these
tests pin them to ``qpsim_tpu``'s: the same values, the same error
messages, and precompute payloads that validate in either package.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import qpsim_tpu.expr.safe_eval as j_expr  # noqa: E402
import qpsim_tpu.fields as j_fields  # noqa: E402
import qpsim_tpu.io.precompute as j_pre  # noqa: E402
from qpsim_tpu.geometry.mask import create_intrinsic_geometry, mask_from_lists  # noqa: E402
from qpsim_tpu.models.params import BoundaryCondition, SimulationParameters  # noqa: E402

import qpsim_tpu_torch.expr.safe_eval as t_expr  # noqa: E402
import qpsim_tpu_torch.fields as t_fields  # noqa: E402
import qpsim_tpu_torch.io.precompute as t_pre  # noqa: E402
from qpsim_tpu_torch.models import params as t_params  # noqa: E402


def _eq(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f")


def _outcome(fn, *args, **kw):
    """(value, None) or (None, (exception type name, message))."""
    try:
        return fn(*args, **kw), None
    except Exception as exc:  # noqa: BLE001 — the point is to compare them
        return None, (type(exc).__name__, str(exc))


_EXPRESSIONS = [
    "return 180.0 + 10.0 * x - 4.0 * y",
    "np.where(x < 0.5, 150.0, 190.0)",
    "170.0 + 5.0 * np.sin(2 * np.pi * x) * np.exp(-y)",
    "math.sqrt(2.0) * 100.0 + abs(x - 0.5) * 20.0",
    "max(120.0, min(200.0, 160.0)) + 0.0 * x",
    "np.clip(x * 400.0, 100.0, 300.0) + params.get('shift', 1.0)",
]


@pytest.mark.parametrize("source", _EXPRESSIONS)
def test_safe_eval_values_match(source):
    x = np.linspace(0.01, 0.99, 7)
    y = np.linspace(0.99, 0.01, 7)
    kw = dict(x=x, y=y, params={"shift": 2.5})
    names = ("x", "y", "params")
    _eq(
        t_expr.compile_safe_expression(source, variable_names=names)(**kw),
        j_expr.compile_safe_expression(source, variable_names=names)(**kw),
    )


_REJECTED = [
    "__import__('os').system('true')",
    "x.__class__",
    "np.__dict__",
    "np.linalg.norm(x)",
    "open('f')",
    "[v for v in x]",
    "lambda v: v",
    "x.real",
    "np.random",
    "os.getcwd()",
    "np['sqrt']",
    "x = 1",
    "math.gamma(x)",
    "sum(**{'a': 1})",
]


@pytest.mark.parametrize("source", _REJECTED)
def test_safe_eval_rejections_match(source):
    names = ("x", "y", "params")
    a = _outcome(j_expr.compile_safe_expression, source, variable_names=names)
    b = _outcome(t_expr.compile_safe_expression, source, variable_names=names)
    assert a[1] is not None and a[1][0] == "ExpressionError"
    assert b[1] == a[1]


def test_safe_eval_missing_variables_and_backends():
    fn_j = j_expr.compile_safe_expression("x + y", variable_names=("x", "y"))
    fn_t = t_expr.compile_safe_expression("x + y", variable_names=("x", "y"))
    assert _outcome(fn_t, x=1.0)[1] == _outcome(fn_j, x=1.0)[1]
    assert _outcome(t_expr.compile_safe_expression, "x", variable_names=("x",), backend="gpu")[1] == \
        _outcome(j_expr.compile_safe_expression, "x", variable_names=("x",), backend="gpu")[1]
    # "jax" names the torch backend here: the numpy backend's value, on a tensor
    fx_t = t_expr.compile_safe_expression("np.exp(x) * 2.0", variable_names=("x",), backend="jax")
    fx_n = t_expr.compile_safe_expression("np.exp(x) * 2.0", variable_names=("x",))
    assert float(fx_t(x=torch.tensor(1.5, dtype=torch.float64))) == float(fx_n(x=1.5))
    assert t_expr._NP_FUNCS == j_expr._NP_FUNCS and t_expr._NP_CONSTS == j_expr._NP_CONSTS
    assert t_expr._MATH_FUNCS == j_expr._MATH_FUNCS and t_expr._MATH_CONSTS == j_expr._MATH_CONSTS


def _masks():
    geo = create_intrinsic_geometry(width=24, height=14)
    film = np.ones((9, 13), dtype=bool)
    film[3:6, 4:9] = False  # a masked film: a hole in the middle
    film[0, :2] = False
    return {"rectangle": mask_from_lists(geo.mask), "full": np.ones((5, 8), bool), "masked_film": film}


_GAP_EXPRESSIONS = [
    "",
    "return 170.0",
    "return 130.0 + 60.0 * x + 5.0 * y",
    "return 180.0 - 20.0 * (((x - 0.5)**2 + (y - 0.5)**2) < 0.04)",
    "return 150.0 if x < 0.5 else 190.0",  # not vectorisable: the per-pixel fallback
]


@pytest.mark.parametrize("mask_name", ["rectangle", "full", "masked_film"])
@pytest.mark.parametrize("expression", _GAP_EXPRESSIONS, ids=["empty", "constant", "gradient", "trap", "fallback"])
def test_evaluate_gap_expression_bit_equal(mask_name, expression):
    mask = _masks()[mask_name]
    _eq(t_fields.evaluate_gap_expression(expression, mask, 180.0),
        j_fields.evaluate_gap_expression(expression, mask, 180.0))
    for a, b in zip(t_fields.normalized_pixel_coords(mask), j_fields.normalized_pixel_coords(mask)):
        _eq(a, b)


@pytest.mark.parametrize(
    "expression",
    ["return np.inf + x", "return 0.0 * x", "return 100.0 - 400.0 * x", "return np.arange(3)",
     "return np.nan", "return y.size * -1.0"],
    ids=["infinite", "zero", "negative", "wrong_size", "nan", "scalar_negative"],
)
def test_evaluate_gap_expression_errors_match(expression):
    mask = _masks()["masked_film"]
    a = _outcome(j_fields.evaluate_gap_expression, expression, mask, 180.0)
    b = _outcome(t_fields.evaluate_gap_expression, expression, mask, 180.0)
    assert a[1] is not None
    assert b[1] == a[1]


def _geometry():
    mask = _masks()["masked_film"]
    from qpsim_tpu.geometry.mask import extract_edge_segments

    edges = extract_edge_segments(mask)
    return mask, edges


def _params(pkg, **over):
    kw = dict(diffusion_coefficient=6.0, dt=0.05, total_time=1.0, mesh_size=1.0, energy_gap=180.0,
              energy_max_factor=4.0, num_energy_bins=8, dynes_gamma=0.05,
              gap_expression="return 130.0 + 60.0 * x + 5.0 * y", tau_s=400.0, tau_r=520.0,
              T_c=1.2, bath_temperature=0.15)
    kw.update(over)
    return (SimulationParameters if pkg == "jax" else t_params.SimulationParameters)(**kw)


def _payloads(expression, kernels):
    mask, edges = _geometry()
    bj = {e.edge_id: BoundaryCondition(kind="reflective") for e in edges}
    bt = {e.edge_id: t_params.BoundaryCondition(kind="reflective") for e in edges}
    pj, pt = _params("jax", gap_expression=expression), _params("torch", gap_expression=expression)
    msgs_j, msgs_t = [], []
    a = j_pre.precompute_arrays(mask, edges, bj, pj, msgs_j.append, include_collision_kernels=kernels)
    b = t_pre.precompute_arrays(mask, edges, bt, pt, msgs_t.append, include_collision_kernels=kernels)
    assert msgs_t == msgs_j
    return mask, pj, pt, a, b


@pytest.mark.parametrize("kernels", [False, True], ids=["diffusion_only", "with_kernels"])
@pytest.mark.parametrize(
    "expression", ["", "return 180.0 - 20.0 * (x < 0.5)", "return 130.0 + 60.0 * x + 5.0 * y"],
    ids=["uniform", "piecewise", "continuous"],
)
def test_precompute_arrays_bit_equal(expression, kernels):
    mask, pj, pt, a, b = _payloads(expression, kernels)
    assert sorted(b) == sorted(a)
    for key in a:
        _eq(b[key], a[key])
    assert t_pre.validate_precomputed(b, pt, mask) is None
    assert j_pre.validate_precomputed(b, pj, mask) is None


@pytest.mark.parametrize("kernels", [False, True], ids=["diffusion_only", "with_kernels"])
def test_npz_payload_validates_in_both_packages(tmp_path, kernels):
    mask, pj, pt, a, b = _payloads("return 180.0 - 20.0 * (x < 0.5)", kernels)
    for name, payload in (("jax", a), ("torch", b)):
        path = tmp_path / f"{name}.npz"
        np.savez(path, **payload)
        with np.load(path) as z:
            loaded = {k: z[k] for k in z.files}
        assert t_pre.validate_precomputed(loaded, pt, mask) is None
        assert j_pre.validate_precomputed(loaded, pj, mask) is None


def _mismatches(mask, payload):
    n_e = payload["E_bins"].size
    yield "param", dict(payload), dict(diffusion_coefficient=7.0, T_c=1.3)
    for key in ("fingerprint", "E_bins", "gap_values", "is_uniform", "D_array"):
        p = dict(payload)
        del p[key]
        yield f"missing_{key}", p, {}
    yield "E_bins_length", dict(payload, E_bins=np.arange(n_e + 1.0)), {}
    yield "gap_values_length", dict(payload, gap_values=np.ones(3)), {}
    yield "D_array_shape", dict(payload, D_array=np.ones((n_e, 3))), {}
    yield "fingerprint_size", dict(payload, fingerprint=np.ones(4)), {}
    yield "not_numeric", dict(payload, E_bins=object()), {}
    yield "other_mask", dict(payload), {}


@pytest.mark.parametrize("kernels", [False, True], ids=["diffusion_only", "with_kernels"])
def test_validate_precomputed_mismatch_messages_match(kernels):
    mask, _, _, a, b = _payloads("return 180.0 - 20.0 * (x < 0.5)", kernels)
    for label, payload, over in _mismatches(mask, a):
        m = mask.copy()
        if label == "other_mask":
            m[-1, -1] = not m[-1, -1]
            payload["gap_values"] = np.ones(int(m.sum()))
            payload["D_array"] = np.ones((payload["E_bins"].size, int(m.sum())))
        msg_j = j_pre.validate_precomputed(payload, _params("jax", **over), m)
        msg_t = t_pre.validate_precomputed(payload, _params("torch", **over), m)
        assert msg_j is not None, label
        assert msg_t == msg_j, label
    assert len(b) == len(a)


def test_hashes_and_memory_estimate_match():
    for mask in _masks().values():
        assert t_pre.mask_hash(mask) == j_pre.mask_hash(mask)
    for expression in _GAP_EXPRESSIONS + ["return 1.0 + 2.0 * x  # é"]:
        assert t_pre.gap_expression_hash(expression) == j_pre.gap_expression_hash(expression)
    for args in ((100, 8, True, False), (100, 8, False, True), (4096, 50, True, True)):
        assert t_pre.estimate_precompute_memory(*args) == j_pre.estimate_precompute_memory(*args)
    mask, edges = _geometry()
    bt = {e.edge_id: t_params.BoundaryCondition(kind="reflective") for e in edges}
    with pytest.raises(ValueError, match="energy_gap > 0"):
        t_pre.precompute_arrays(mask, edges, bt, _params("torch", energy_gap=0.0))
