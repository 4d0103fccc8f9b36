"""Safe evaluation of deck expression strings f(x, y, z, t).

Replaces the reference's runtime-compiled Trilinos RTC expressions used
for Dirichlet/traction BC values and virtual fields
(reference: source/calibr8/src/control.cpp:103-119).  Expressions are
parsed with Python's ast module and evaluated against a whitelist of
math functions — no arbitrary code execution.
"""

from __future__ import annotations

import ast
import math

import numpy as np

_ALLOWED_FUNCS = {
    "sin": np.sin,
    "cos": np.cos,
    "tan": np.tan,
    "asin": np.arcsin,
    "acos": np.arccos,
    "atan": np.arctan,
    "atan2": np.arctan2,
    "sinh": np.sinh,
    "cosh": np.cosh,
    "tanh": np.tanh,
    "exp": np.exp,
    "log": np.log,
    "log10": np.log10,
    "sqrt": np.sqrt,
    "abs": np.abs,
    "fabs": np.abs,
    "pow": np.power,
    "min": np.minimum,
    "max": np.maximum,
    "floor": np.floor,
    "ceil": np.ceil,
}
_ALLOWED_CONSTS = {"pi": math.pi, "e": math.e}

_ALLOWED_NODES = (
    ast.Expression,
    ast.BinOp,
    ast.UnaryOp,
    ast.Constant,
    ast.Name,
    ast.Load,
    ast.Call,
    ast.Add,
    ast.Sub,
    ast.Mult,
    ast.Div,
    ast.Pow,
    ast.Mod,
    ast.USub,
    ast.UAdd,
    ast.Compare,
    ast.Lt,
    ast.Gt,
    ast.LtE,
    ast.GtE,
    ast.IfExp,
)


class Expression:
    """A compiled f(x, y, z, t) expression; evaluates on numpy arrays."""

    def __init__(self, src):
        self.src = str(src)
        tree = ast.parse(self.src, mode="eval")
        for node in ast.walk(tree):
            if not isinstance(node, _ALLOWED_NODES):
                raise ValueError(
                    f"disallowed syntax {type(node).__name__!r} in expression {src!r}"
                )
            if isinstance(node, ast.Call):
                if not (
                    isinstance(node.func, ast.Name)
                    and node.func.id in _ALLOWED_FUNCS
                ):
                    raise ValueError(f"disallowed function in expression {src!r}")
            if isinstance(node, ast.Name):
                if node.id not in ("x", "y", "z", "t") and node.id not in (
                    _ALLOWED_FUNCS | _ALLOWED_CONSTS
                ):
                    raise ValueError(
                        f"unknown name {node.id!r} in expression {src!r}"
                    )
        self._code = compile(tree, "<expr>", "eval")

    def __call__(self, x=0.0, y=0.0, z=0.0, t=0.0):
        env = dict(_ALLOWED_FUNCS)
        env.update(_ALLOWED_CONSTS)
        env.update({"x": x, "y": y, "z": z, "t": t})
        return eval(self._code, {"__builtins__": {}}, env)


def eval_expr(src, x=0.0, y=0.0, z=0.0, t=0.0):
    """One-shot evaluation, the analog of calibr8::eval (control.hpp:36-44)."""
    return Expression(src)(x, y, z, t)
