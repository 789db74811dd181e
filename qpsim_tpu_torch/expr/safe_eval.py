"""Sandboxed single-expression DSL for user-supplied formulas.

Carried over from ``qpsim_tpu.expr.safe_eval`` (the same whitelist, the
same ``ExpressionError`` messages).  Two backends: ``"numpy"`` evaluates
on the host (gap maps, initial conditions, host-mode generation), and
``"torch"`` maps the ``np`` namespace onto torch, so an expression bound
to tensors is evaluated on their device in their dtype — the traced custom
generation of the engine.  ``"jax"``, the JAX package's name for its traced
backend, is an alias of ``"torch"``.

Security model
--------------
Only a single Python expression is accepted (an optional leading ``return``
is stripped).  The AST is walked and every node must belong to a small
whitelist: arithmetic, comparisons, ternaries, subscripts, list/tuple/dict
literals, calls to a fixed set of builtins, and attribute access restricted
to vetted ``np.*`` / ``math.*`` members, ``params.get`` and ``.size/.shape``
on bound variables.  Dunder names are rejected outright and the compiled
code runs with empty ``__builtins__``.
"""

from __future__ import annotations

import ast
import math
from typing import Any, Callable, Iterable

import numpy as np
import torch

__all__ = ["compile_safe_expression", "ExpressionError", "JNP_BACKEND_FUNCTIONS"]


class ExpressionError(ValueError):
    """Raised when an expression fails validation or compilation."""


_BUILTIN_WHITELIST: dict[str, Callable[..., Any]] = {
    "abs": abs,
    "min": min,
    "max": max,
    "pow": pow,
    "len": len,
    "float": float,
    "int": int,
    "bool": bool,
}

# numpy members that user expressions may reference.  Kept in sync with the
# reference DSL so existing setups evaluate identically.
_NP_FUNCS = frozenset(
    """abs sqrt exp log log10 sin cos tan arcsin arccos arctan sinh cosh tanh
    where maximum minimum clip power heaviside arange zeros_like ones_like
    full_like""".split()
)
_NP_CONSTS = frozenset("pi e inf nan float64 float32 int64 int32 bool_".split())
_MATH_FUNCS = frozenset(
    "sqrt exp log log10 sin cos tan asin acos atan sinh cosh tanh floor ceil".split()
)
_MATH_CONSTS = frozenset("pi e tau inf nan".split())
_VALUE_ATTRS = frozenset({"size", "shape"})

_NODE_WHITELIST = (
    ast.Expression,
    ast.BoolOp,
    ast.BinOp,
    ast.UnaryOp,
    ast.IfExp,
    ast.Compare,
    ast.Call,
    ast.Name,
    ast.Load,
    ast.Constant,
    ast.Attribute,
    ast.Subscript,
    ast.Slice,
    ast.Tuple,
    ast.List,
    ast.Dict,
)
_OPERATOR_NODES = (ast.operator, ast.unaryop, ast.boolop, ast.cmpop, ast.expr_context)


def _validate_tree(tree: ast.AST, variables: frozenset[str]) -> None:
    """Walk the AST and reject anything outside the whitelist."""
    known_names = variables | set(_BUILTIN_WHITELIST) | {"np", "math"}

    for node in ast.walk(tree):
        if isinstance(node, _OPERATOR_NODES):
            continue
        if not isinstance(node, _NODE_WHITELIST):
            raise ExpressionError(
                f"Unsupported syntax in custom expression: {type(node).__name__}."
            )
        if isinstance(node, ast.Name):
            if node.id.startswith("__"):
                raise ExpressionError("Dunder names are not allowed in custom expressions.")
            if node.id not in known_names:
                raise ExpressionError(f"Unsupported name in custom expression: {node.id!r}.")
        elif isinstance(node, ast.Attribute):
            _check_attribute(node, variables)
        elif isinstance(node, ast.Call):
            _check_call(node)
        elif isinstance(node, ast.Subscript):
            if isinstance(node.value, ast.Name) and node.value.id in {"np", "math"}:
                raise ExpressionError("Subscript access on modules is not allowed.")


def _check_attribute(node: ast.Attribute, variables: frozenset[str]) -> None:
    if node.attr.startswith("__"):
        raise ExpressionError("Dunder attribute access is not allowed in custom expressions.")
    if not isinstance(node.value, ast.Name):
        raise ExpressionError("Nested attribute access is not allowed in custom expressions.")
    base = node.value.id
    if base == "np":
        if node.attr not in (_NP_FUNCS | _NP_CONSTS):
            raise ExpressionError(f"Unsupported numpy attribute: np.{node.attr}.")
    elif base == "math":
        if node.attr not in (_MATH_FUNCS | _MATH_CONSTS):
            raise ExpressionError(f"Unsupported math attribute: math.{node.attr}.")
    elif base == "params":
        if node.attr != "get":
            raise ExpressionError(f"Unsupported params attribute: params.{node.attr}.")
    elif base in variables:
        if node.attr not in _VALUE_ATTRS:
            raise ExpressionError(f"Unsupported attribute: {base}.{node.attr}.")
    else:
        raise ExpressionError(f"Unsupported attribute base in custom expression: {base!r}.")


def _check_call(node: ast.Call) -> None:
    for kw in node.keywords:
        if kw.arg is None:
            raise ExpressionError("Starred keyword arguments are not allowed.")
    fn = node.func
    if isinstance(fn, ast.Name):
        if fn.id not in _BUILTIN_WHITELIST:
            raise ExpressionError(f"Unsupported function in custom expression: {fn.id!r}.")
    elif isinstance(fn, ast.Attribute):
        if not isinstance(fn.value, ast.Name):
            raise ExpressionError("Nested attribute calls are not allowed.")
        base = fn.value.id
        if base == "np":
            if fn.attr not in _NP_FUNCS:
                raise ExpressionError(f"Unsupported numpy function: np.{fn.attr}.")
        elif base == "math":
            if fn.attr not in _MATH_FUNCS:
                raise ExpressionError(f"Unsupported math function: math.{fn.attr}.")
        elif base == "params":
            if fn.attr != "get":
                raise ExpressionError(f"Unsupported params method: params.{fn.attr}.")
        else:
            raise ExpressionError("Method calls are not allowed in custom expressions.")
    else:
        raise ExpressionError("Unsupported call target in custom expressions.")


def _strip_return(source: str) -> str:
    text = str(source or "").strip()
    if not text:
        return "0.0"
    if "\n" not in text and text.startswith("return "):
        text = text[len("return "):].strip()
    return text


_TORCH_DTYPES = {
    "float64": torch.float64,
    "float32": torch.float32,
    "int64": torch.int64,
    "int32": torch.int32,
    "bool_": torch.bool,
}


class _TorchShim:
    """A restricted ``np``-lookalike backed by torch, bound to one dtype and device.

    Python numbers (and numpy values) handed to a function become tensors of
    the shim's dtype on its device first — the dtype and device of the
    floating tensors the expression is evaluated on — so a scalar branch of
    ``np.where`` or ``np.maximum(x, 0.0)`` computes in the state dtype, as
    ``jax.numpy``'s weakly typed scalars do.
    """

    def __init__(self, dtype: torch.dtype, device: torch.device) -> None:
        self._dtype = dtype
        self._device = device

    def _lift(self, v: Any) -> Any:
        if isinstance(v, torch.Tensor):
            return v
        if isinstance(v, (bool, np.bool_)):
            return torch.tensor(bool(v), device=self._device)
        if isinstance(v, (int, float, np.number, np.ndarray)):
            return torch.as_tensor(np.asarray(v, dtype=np.float64), dtype=self._dtype, device=self._device)
        return v

    def __getattr__(self, name: str) -> Any:
        if name in _NP_CONSTS:
            return _TORCH_DTYPES[name] if name in _TORCH_DTYPES else float(getattr(np, name))
        if name not in _NP_FUNCS:
            raise AttributeError(name)
        if name == "arange":
            return lambda *a, **kw: torch.arange(*a, device=self._device, **kw)
        if name == "clip":
            return lambda x, lo=None, hi=None: torch.clamp(
                self._lift(x),
                None if lo is None else self._lift(lo),
                None if hi is None else self._lift(hi),
            )
        if name == "full_like":
            return lambda x, v, **kw: torch.ones_like(self._lift(x), **kw) * self._lift(v)
        fn = getattr(torch, "pow" if name == "power" else name)
        return lambda *a, **kw: fn(*(self._lift(v) for v in a), **kw)


def _torch_context(bound: dict) -> tuple[torch.dtype, torch.device]:
    """The dtype and device of the first floating tensor bound (float64 on the CPU if none)."""
    for v in bound.values():
        if isinstance(v, torch.Tensor) and v.is_floating_point():
            return v.dtype, v.device
    return torch.float64, torch.device("cpu")


class _TensorSize(ast.NodeTransformer):
    """``v.size`` → ``_size(v)``: numpy's element count, not torch's method."""

    def visit_Attribute(self, node: ast.Attribute) -> ast.AST:
        self.generic_visit(node)
        if node.attr == "size" and isinstance(node.value, ast.Name):
            call = ast.Call(func=ast.Name(id="_size", ctx=ast.Load()), args=[node.value], keywords=[])
            return ast.copy_location(call, node)
        return node


def _size(v: Any) -> Any:
    return v.numel() if isinstance(v, torch.Tensor) else v.size


#: names of the np.* functions guaranteed to exist on the torch backend.
JNP_BACKEND_FUNCTIONS = _NP_FUNCS


def compile_safe_expression(
    source: str,
    *,
    variable_names: Iterable[str],
    backend: str = "numpy",
) -> Callable[..., Any]:
    """Compile a sandboxed expression into a keyword-argument callable.

    ``source`` is a single expression, optionally prefixed by ``return``;
    ``variable_names`` the names the caller binds at evaluation time (e.g.
    ``("x", "y", "params")``).  ``backend`` is ``"numpy"`` (host evaluation)
    or ``"torch"`` (``"jax"`` is an alias): there ``np.*`` maps onto torch in
    the dtype and on the device of the floating tensors bound at call time,
    and ``v.size`` is the element count as in numpy.
    """
    text = _strip_return(source)
    try:
        tree = ast.parse(text, mode="eval")
    except SyntaxError as exc:
        raise ExpressionError(
            "Custom expressions must be a single expression (optionally prefixed by 'return ')."
        ) from exc

    names = frozenset(variable_names)
    _validate_tree(tree, names)
    if backend not in ("numpy", "torch", "jax"):
        raise ExpressionError(f"Unknown expression backend: {backend!r}.")
    on_torch = backend != "numpy"
    if on_torch:
        tree = ast.fix_missing_locations(_TensorSize().visit(tree))
    code = compile(tree, "<qpsim-expression>", "eval")

    required = tuple(names)

    def evaluate(**bound: Any) -> Any:
        missing = [v for v in required if v not in bound]
        if missing:
            raise ExpressionError(
                "Missing variables for custom expression evaluation: " + ", ".join(sorted(missing)) + "."
            )
        np_namespace: Any = _TorchShim(*_torch_context(bound)) if on_torch else np
        # torch's C++ operators import some of their Python helpers lazily
        # through the calling frame's builtins; the expression itself cannot
        # name ``__import__`` (dunder names fail validation)
        builtins = {"__import__": __import__} if on_torch else {}
        scope = {"__builtins__": builtins, "np": np_namespace, "math": math, "_size": _size}
        scope.update(_BUILTIN_WHITELIST)
        scope.update(bound)
        return eval(code, scope, {})  # noqa: S307 — sandboxed by _validate_tree

    return evaluate
