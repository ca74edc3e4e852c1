"""Rule ``host-sync`` — blocking device-to-host copies on the host hot path
(the ``_SlotTable`` serving family and ``# repro: hot-path`` marks).

Each one stalls the host until the card has finished everything queued,
once per call, in the per-token loop. Flagged:

* ``.item()``, ``.tolist()`` and ``.cpu()`` — except ``.cpu().numpy()``,
  the step's one readback (the port's ``jax.device_get``), and calls on a
  value derived from a readback, which is already on the host;
* ``int()`` / ``float()`` / ``bool()`` and ``np.asarray`` / ``np.array``
  of a tensor (a ``torch.*`` result, or a name assigned from one);
* truth tests (``if`` / ``while`` / ``assert`` / ``and`` / ``not``) of a
  tensor.

The reference's jit-traced scope has no subject in the port: nothing is
traced, every torch call runs eagerly.
"""
from __future__ import annotations

import ast
from typing import Iterator, List, Set

from repro_torch.analysis.lint import (COERCION_BUILTINS, COERCION_METHODS,
                                       COERCION_NP, Finding, ModuleCtx,
                                       assign_targets, dotted, expr_taint,
                                       is_readback, tainted_names)

RULE = "host-sync"


def _coercion(node: ast.Call) -> str:
    """Name of the host coercion this call performs, or ''."""
    func = node.func
    if isinstance(func, ast.Name) and func.id in COERCION_BUILTINS \
            and node.args:
        return func.id
    name = dotted(func)
    if name and node.args:
        root, _, attr = name.rpartition(".")
        if root in ("np", "numpy") and attr in COERCION_NP:
            return name
    if isinstance(func, ast.Attribute) and func.attr in COERCION_METHODS:
        return f".{func.attr}()"
    return ""


def _truth_contexts(fn: ast.AST, ctx: ModuleCtx) -> Iterator[ast.AST]:
    for n in ctx.own_statements(fn):
        if isinstance(n, (ast.If, ast.While, ast.IfExp, ast.Assert)):
            yield n.test
        elif isinstance(n, ast.BoolOp):
            yield from n.values
        elif isinstance(n, ast.UnaryOp) and isinstance(n.op, ast.Not):
            yield n.operand


def _host_names(fn: ast.AST) -> Set[str]:
    """Names assigned from a readback (``host = t.cpu().numpy()``) or
    from such names: host values."""
    host: Set[str] = set()
    stmts = [n for n in ast.walk(fn)
             if isinstance(n, (ast.Assign, ast.AnnAssign))
             and n.value is not None]
    for _ in range(4):
        grew = False
        for stmt in stmts:
            v = stmt.value
            if is_readback(v) or (isinstance(v, (ast.Name, ast.Subscript))
                                  and _rooted_in(v, host)):
                for name in assign_targets(stmt):
                    if name not in host:
                        host.add(name)
                        grew = True
        if not grew:
            break
    return host


def _rooted_in(node: ast.AST, names: Set[str]) -> bool:
    while isinstance(node, (ast.Subscript, ast.Attribute)):
        node = node.value
    return isinstance(node, ast.Name) and node.id in names


def check(ctx: ModuleCtx) -> List[Finding]:
    findings: List[Finding] = []

    def flag(node: ast.AST, msg: str) -> None:
        findings.append(Finding(RULE, ctx.path, node.lineno,
                                node.col_offset, msg))

    for fn in ctx.hot:
        taint = tainted_names(fn)
        host = _host_names(fn)
        readback_cpu = {id(n.func.value) for n in ctx.own_statements(fn)
                        if is_readback(n)}
        for n in ctx.own_statements(fn):
            if not isinstance(n, ast.Call):
                continue
            coercion = _coercion(n)
            if not coercion:
                continue
            if coercion.startswith("."):
                target = n.func.value
                if id(n) in readback_cpu or is_readback(target) or \
                        _rooted_in(target, host):
                    continue
                flag(n, f"{coercion} on the host hot path — a blocking "
                        "device-to-host copy per call; fold it into the "
                        "step's one readback (.cpu().numpy())")
                continue
            if any(isinstance(sub, ast.Call) and _coercion(sub).startswith(
                    ".") for sub in ast.walk(n.args[0])):
                continue            # the copy inside is flagged itself
            why = expr_taint(n.args[0], taint)
            if why:
                flag(n, f"{coercion} of a tensor ({why}) on the host hot "
                        "path — a blocking copy per call; read it back "
                        "with the step's one readback")
        for test in _truth_contexts(fn, ctx):
            why = expr_taint(test, taint)
            if why:
                flag(test, f"truth test of a tensor ({why}) on the host hot "
                           "path — a blocking copy; read it back "
                           "explicitly")
    seen, out = set(), []
    for f in findings:
        key = (f.line, f.col, f.msg)
        if key not in seen:
            seen.add(key)
            out.append(f)
    return out
