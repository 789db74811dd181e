"""Sandboxed user expressions (host side)."""

from .safe_eval import ExpressionError, compile_safe_expression

__all__ = ["ExpressionError", "compile_safe_expression"]
