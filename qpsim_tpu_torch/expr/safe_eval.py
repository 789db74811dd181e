"""Sandboxed single-expression DSL for user-supplied formulas.

Carried over from ``qpsim_tpu.expr.safe_eval`` (the same whitelist, the
same ``ExpressionError`` messages), with the numpy backend only: gap maps
are evaluated on the host.  The JAX package's ``backend="jax"`` (traced
generation expressions) has no counterpart here yet; a torch backend comes
with the custom generation mode (ROADMAP.md, queue 1, item 4).

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

__all__ = ["compile_safe_expression", "ExpressionError"]


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

# numpy members that user expressions may reference
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


def compile_safe_expression(
    source: str,
    *,
    variable_names: Iterable[str],
    backend: str = "numpy",
) -> Callable[..., Any]:
    """Compile a sandboxed expression into a keyword-argument callable.

    ``source`` is a single expression, optionally prefixed by ``return``;
    ``variable_names`` the names the caller binds at evaluation time (e.g.
    ``("x", "y", "params")``).  Only ``backend="numpy"`` exists here.
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
    code = compile(tree, "<qpsim-expression>", "eval")

    if backend == "jax":
        raise NotImplementedError(
            "The traced expression backend is not ported yet "
            "(ROADMAP.md, queue 1, item 4: a torch backend for custom expressions)."
        )
    if backend != "numpy":
        raise ExpressionError(f"Unknown expression backend: {backend!r}.")

    required = tuple(names)

    def evaluate(**bound: Any) -> Any:
        missing = [v for v in required if v not in bound]
        if missing:
            raise ExpressionError(
                "Missing variables for custom expression evaluation: " + ", ".join(sorted(missing)) + "."
            )
        scope = {"__builtins__": {}, "np": np, "math": math}
        scope.update(_BUILTIN_WHITELIST)
        scope.update(bound)
        return eval(code, scope, {})  # noqa: S307 — sandboxed by _validate_tree

    return evaluate
