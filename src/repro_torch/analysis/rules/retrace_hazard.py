"""Rule ``retrace-hazard`` — patterns that make a fresh shape or a fresh
compilation per call.

* **RT1 value-dependent shape** — a value read back from the device
  (``int()`` / ``float()`` / ``.item()`` of a tensor) flowing into a
  tensor constructor's shape (``torch.zeros(n)``, ``torch.arange``,
  ``x.new_zeros``...), directly or through a name: a blocking copy before
  the launch and a fresh shape per distinct value (and, for a compiled or
  graph-captured consumer, a recompilation).
* **RT3 compile-under-loop** — ``torch.compile(...)`` applied inside a
  loop or a hot-path function: each call wraps a fresh function object,
  so every call compiles anew.

The reference's RT2 (unhashable ``jax.jit`` static arguments) has no
subject in the port.
"""
from __future__ import annotations

import ast
from typing import List, Optional, Set

from repro_torch.analysis.lint import (SHAPE_CONSTRUCTORS, Finding,
                                       ModuleCtx, assign_targets, dotted,
                                       expr_taint, tainted_names)

RULE = "retrace-hazard"

_COERCERS = {"int", "float"}


def _shape_constructor(node: ast.Call) -> bool:
    name = dotted(node.func)
    if name and name.startswith("torch.") and \
            name[len("torch."):] in SHAPE_CONSTRUCTORS:
        return True
    return isinstance(node.func, ast.Attribute) and \
        node.func.attr.startswith("new_") and \
        node.func.attr in SHAPE_CONSTRUCTORS


def _read_back(node: ast.AST, taint: Set[str]) -> Optional[str]:
    """Why ``node`` is a value read back from a tensor, or None."""
    if isinstance(node, ast.Call):
        if isinstance(node.func, ast.Name) and \
                node.func.id in _COERCERS and node.args:
            why = expr_taint(node.args[0], taint)
            if why:
                return f"{node.func.id}() of {why}"
        if isinstance(node.func, ast.Attribute) and \
                node.func.attr == "item":
            why = expr_taint(node.func.value, taint)
            if why:
                return f".item() of {why}"
    return None


def check(ctx: ModuleCtx) -> List[Finding]:
    findings: List[Finding] = []

    def flag(node: ast.AST, msg: str) -> None:
        findings.append(Finding(RULE, ctx.path, node.lineno,
                                node.col_offset, msg))

    # ---- RT1: read-back scalars flowing into shape constructors ----------
    for fn in ctx.funcs:
        taint = tainted_names(fn)
        scalars = {}
        for n in ctx.own_statements(fn):
            if isinstance(n, ast.Assign):
                why = _read_back(n.value, taint)
                if why:
                    for name in assign_targets(n):
                        scalars[name] = why
        for n in ctx.own_statements(fn):
            if not (isinstance(n, ast.Call) and _shape_constructor(n)):
                continue
            shape_args = list(n.args) + [kw.value for kw in n.keywords
                                         if kw.arg in ("size", "end",
                                                       "steps")]
            for arg in shape_args:
                why = None
                for sub in ast.walk(arg):
                    why = _read_back(sub, taint) or (
                        scalars.get(sub.id) if isinstance(sub, ast.Name)
                        else None)
                    if why:
                        break
                if why:
                    flag(n, f"value-dependent shape: {why} feeds a tensor "
                            "constructor — a blocking copy and a fresh "
                            "shape per distinct value; pad to a bounded "
                            "set of shapes instead")
                    break

    # ---- RT3: torch.compile applied per call -----------------------------
    for node in ast.walk(ctx.tree):
        if not (isinstance(node, ast.Call)
                and dotted(node.func) == "torch.compile"):
            continue
        enclosing = ctx.enclosing_function(node)
        in_loop = ctx.in_loop(node)
        hot = enclosing is not None and enclosing in ctx.hot and \
            not _is_setup_method(enclosing)
        if in_loop or hot:
            where = "inside a loop" if in_loop else "in a hot-path function"
            flag(node, f"torch.compile applied {where}: each call wraps a "
                       "fresh function object and compiles it anew; "
                       "compile once at setup and reuse it")
    return findings


def _is_setup_method(fn: ast.AST) -> bool:
    """__init__ / make_* factories legitimately build compiled callables."""
    name = getattr(fn, "name", "")
    return name == "__init__" or name.startswith("make_") or \
        name.startswith("_make_") or name.startswith("_build")
