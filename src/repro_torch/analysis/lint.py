"""repro-lint for the port (port of ``repro.analysis.lint``): AST static
analysis of the PyTorch host hot paths.

The reference's rules watch for host/device syncs hiding in the serving
step loop and for retraces. In the port every torch call runs eagerly, so
what stays is:

* ``host-sync``      — a blocking device-to-host copy on the host hot path
  (the ``_SlotTable`` step loop and friends): ``.item()``, ``.tolist()``,
  ``.cpu()``, ``int()`` / ``float()`` / ``bool()`` or ``np.asarray`` /
  ``np.array`` of a tensor, and truth tests of tensors. The sanctioned
  pattern is the step's one readback, ``<tensor>.cpu().numpy()``: one
  explicit copy of everything the host needs, like the reference's
  ``jax.device_get``; what is derived from it is a host value.
* ``retrace-hazard`` — RT1, a value read back from the device feeding a
  tensor constructor's shape (``torch.zeros(int(t.sum()))``: a fresh shape
  per value, and a blocking copy before the launch), and RT3,
  ``torch.compile`` applied inside a loop or a hot-path function (a fresh
  compilation per call).

The reference's RT2 (unhashable ``jax.jit`` static arguments) and its
``kernel-bounds`` rule (Pallas ``BlockSpec`` index maps) have no subject
here: the port has no jit static arguments, and its kernels' index bounds
live in CUDA C++, held by ``chip_smoke.py``'s edge cases.

Directives (comments scanned from raw source; a directive on a line of its
own also applies to the next line):

* ``# repro: allow-<rule> <why>`` — waive findings of ``<rule>`` on this
  line.
* ``# repro: hot-path`` — mark the next ``def``/``class`` as a host hot
  path (scanned like the built-in ``_SlotTable`` family).

Run ``python -m repro_torch.analysis <paths>``; exits nonzero on any
unwaived finding. Pure stdlib — no torch import.
"""
from __future__ import annotations

import ast
import dataclasses
import re
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Set

RULES = ("host-sync", "retrace-hazard")

# Classes whose methods form the serving host hot path: every method runs
# between device launches of the step loop, so a blocking copy here stalls
# the card for all slots.
HOT_CLASSES = {"_SlotTable", "SlotServer", "MixtureSlotServer",
               "DecentralizedSlotServer"}

# Host-coercion callables: called on a tensor, each copies it to the host
# and waits for the card.
COERCION_BUILTINS = {"int", "float", "bool", "complex"}
COERCION_NP = {"asarray", "array"}          # np.asarray / np.array
COERCION_METHODS = {"item", "tolist", "cpu"}

# Shape-constructing torch calls: a value read back from the device that
# flows into one of these makes a fresh shape per distinct value.
SHAPE_CONSTRUCTORS = {"zeros", "ones", "full", "empty", "arange", "rand",
                      "randn", "randint", "eye", "linspace", "new_zeros",
                      "new_ones", "new_empty", "new_full", "expand",
                      "broadcast_to", "tile", "repeat"}

# torch calls that make no device tensor (types, devices, contexts)
HOST_TORCH = {"torch.device", "torch.Size", "torch.dtype", "torch.Generator",
              "torch.no_grad", "torch.enable_grad", "torch.inference_mode",
              "torch.is_grad_enabled", "torch.is_tensor",
              "torch.get_num_threads", "torch.set_num_threads",
              "torch.finfo", "torch.iinfo"}

#: Attribute accesses that are host values even on a tensor.
STATIC_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda"}

_DIRECTIVE_RE = re.compile(r"#\s*repro:\s*(.+?)\s*$")


@dataclasses.dataclass
class Finding:
    rule: str
    path: str
    line: int
    col: int
    msg: str
    waived: bool = False

    def format(self) -> str:
        tag = " (waived)" if self.waived else ""
        return f"{self.path}:{self.line}:{self.col}: [{self.rule}]{tag} " \
               f"{self.msg}"


class Directives:
    """``# repro:`` comment directives, parsed from raw source lines."""

    def __init__(self, lines: Sequence[str]):
        self.allow: Dict[int, Set[str]] = {}       # line -> waived rules
        self.marks: Dict[int, Set[str]] = {}       # line -> {hot-path}
        for i, raw in enumerate(lines, start=1):
            m = _DIRECTIVE_RE.search(raw)
            if not m:
                continue
            word = m.group(1).partition(" ")[0]
            if word.startswith("allow-"):
                self.allow.setdefault(i, set()).add(word[len("allow-"):])
            elif word == "hot-path":
                self.marks.setdefault(i, set()).add(word)

    def waived(self, rule: str, line: int) -> bool:
        """A finding is waived by a directive on its line or the line
        directly above (comment-on-its-own-line style)."""
        return any(rule in self.allow.get(ln, ()) for ln in (line, line - 1))

    def marked(self, mark: str, node: ast.AST) -> bool:
        """``# repro: <mark>`` on the def/class line, a decorator line, or
        the line directly above the first of those."""
        first = min([node.lineno]
                    + [d.lineno for d in getattr(node, "decorator_list",
                                                 [])])
        for ln in range(first - 1, getattr(node, "body", [node])[0].lineno):
            if mark in self.marks.get(ln, ()):
                return True
        return False


# ---------------------------------------------------------------------------
# expression predicates
# ---------------------------------------------------------------------------

def dotted(node: ast.AST) -> Optional[str]:
    """``torch.argmax`` -> "torch.argmax"; None for non-name chains."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def is_readback(node: ast.AST) -> bool:
    """``<x>.cpu().numpy()``: the step's one explicit readback."""
    return (isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "numpy"
            and isinstance(node.func.value, ast.Call)
            and isinstance(node.func.value.func, ast.Attribute)
            and node.func.value.func.attr == "cpu")


def _device_call(name: Optional[str]) -> bool:
    """A ``torch.*`` call that makes or computes a tensor."""
    if not name or not name.startswith("torch."):
        return False
    return name not in HOST_TORCH and not name.startswith("torch.cuda.")


def walk_device(node: ast.AST) -> Iterable[ast.AST]:
    """ast.walk, but not into readbacks (their results are host values),
    nor static attribute accesses (``t.shape[0]`` is a host int)."""
    stack = [node]
    while stack:
        n = stack.pop()
        yield n
        for child in ast.iter_child_nodes(n):
            if is_readback(child):
                continue
            if isinstance(child, ast.Attribute) and \
                    child.attr in STATIC_ATTRS:
                continue
            stack.append(child)


def expr_taint(node: ast.AST, tainted: Set[str]) -> Optional[str]:
    """Why this expression holds a tensor, or None: a device ``torch.*``
    call anywhere inside (outside a readback), or a tainted name."""
    if is_readback(node):
        return None
    for n in walk_device(node):
        if isinstance(n, ast.Call) and _device_call(dotted(n.func)):
            return f"{dotted(n.func)}(...)"
        if isinstance(n, ast.Name) and n.id in tainted:
            return n.id
    return None


def assign_targets(stmt: ast.stmt) -> List[str]:
    names: List[str] = []

    def collect(t: ast.AST) -> None:
        if isinstance(t, ast.Name):
            names.append(t.id)
        elif isinstance(t, (ast.Tuple, ast.List)):
            for e in t.elts:
                collect(e)

    if isinstance(stmt, ast.Assign):
        for t in stmt.targets:
            collect(t)
    elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
        collect(stmt.target)
    return names


def tainted_names(fn: ast.AST) -> Set[str]:
    """Names in ``fn`` assigned (transitively) from tensor expressions
    (``expr_taint``): a conservative 'this local is on the device' mark.
    Fixpoint over name-to-name propagation."""
    taint: Set[str] = set()
    stmts = [n for n in ast.walk(fn)
             if isinstance(n, (ast.Assign, ast.AugAssign, ast.AnnAssign))
             and n.value is not None]
    for _ in range(4):
        changed = False
        for stmt in stmts:
            if expr_taint(stmt.value, taint):
                for name in assign_targets(stmt):
                    if name not in taint:
                        taint.add(name)
                        changed = True
        if not changed:
            break
    return taint


# ---------------------------------------------------------------------------
# module context: parse once, index the hot-path functions
# ---------------------------------------------------------------------------

FuncNode = (ast.FunctionDef, ast.AsyncFunctionDef)


class ModuleCtx:
    def __init__(self, path: Path, src: str):
        self.path = str(path)
        self.src = src
        self.lines = src.splitlines()
        self.tree = ast.parse(src, filename=self.path)
        self.directives = Directives(self.lines)
        self.parent: Dict[ast.AST, ast.AST] = {}
        for node in ast.walk(self.tree):
            for child in ast.iter_child_nodes(node):
                self.parent[child] = node
        self.funcs: List[ast.AST] = [
            n for n in ast.walk(self.tree)
            if isinstance(n, FuncNode + (ast.Lambda,))]
        self.hot: Set[ast.AST] = self._find_hot()

    def _find_hot(self) -> Set[ast.AST]:
        hot: Set[ast.AST] = set()
        hot_classes = set(HOT_CLASSES)
        for node in ast.walk(self.tree):
            if isinstance(node, ast.ClassDef):
                bases = {dotted(b) for b in node.bases}
                if node.name in hot_classes or bases & hot_classes or \
                        self.directives.marked("hot-path", node):
                    hot_classes.add(node.name)
                    hot.update(item for item in node.body
                               if isinstance(item, FuncNode))
        hot.update(fn for fn in self.funcs if isinstance(fn, FuncNode)
                   and self.directives.marked("hot-path", fn))
        # nested defs / lambdas inside a hot function run on the hot path
        for fn in self.funcs:
            p = self.parent.get(fn)
            while p is not None and fn not in hot:
                if p in hot:
                    hot.add(fn)
                p = self.parent.get(p)
        return hot

    def enclosing_function(self, node: ast.AST) -> Optional[ast.AST]:
        p = self.parent.get(node)
        while p is not None:
            if isinstance(p, FuncNode + (ast.Lambda,)):
                return p
            p = self.parent.get(p)
        return None

    def own_statements(self, fn: ast.AST) -> Iterable[ast.AST]:
        """Walk ``fn`` without descending into nested def/lambda bodies
        (those are scanned as their own functions)."""
        body = fn.body if isinstance(fn.body, list) else [fn.body]
        stack: List[ast.AST] = list(body)
        while stack:
            n = stack.pop()
            yield n
            for child in ast.iter_child_nodes(n):
                if not isinstance(child, FuncNode + (ast.Lambda,)):
                    stack.append(child)

    def in_loop(self, node: ast.AST) -> bool:
        p = self.parent.get(node)
        while p is not None and not isinstance(p, FuncNode + (ast.Lambda,)):
            if isinstance(p, (ast.For, ast.While)):
                return True
            p = self.parent.get(p)
        return False


# ---------------------------------------------------------------------------
# runner
# ---------------------------------------------------------------------------

def iter_py(paths: Sequence[str]) -> List[Path]:
    out: List[Path] = []
    for p in paths:
        path = Path(p)
        if path.is_dir():
            out.extend(sorted(path.rglob("*.py")))
        elif path.suffix == ".py":
            out.append(path)
    return out


def run_paths(paths: Sequence[str],
              rules: Optional[Sequence[str]] = None) -> List[Finding]:
    from repro_torch.analysis.rules import RULE_CHECKS
    selected = [(name, fn) for name, fn in RULE_CHECKS.items()
                if rules is None or name in rules]
    findings: List[Finding] = []
    for path in iter_py(paths):
        try:
            ctx = ModuleCtx(path, path.read_text())
        except (SyntaxError, UnicodeDecodeError) as e:
            findings.append(Finding("parse", str(path), 1, 0,
                                    f"could not parse: {e}"))
            continue
        for _, check in selected:
            for f in check(ctx):
                f.waived = ctx.directives.waived(f.rule, f.line)
                findings.append(f)
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings


def main(argv: Sequence[str]) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="repro-lint: PyTorch host hot-path static analysis "
                    "(host-sync, retrace-hazard)")
    ap.add_argument("paths", nargs="+", help="files or directories")
    ap.add_argument("--rule", action="append", choices=RULES, default=None,
                    help="restrict to one rule (repeatable)")
    ap.add_argument("--show-waived", action="store_true",
                    help="also print waived findings")
    args = ap.parse_args(argv)

    findings = run_paths(args.paths, rules=args.rule)
    unwaived = [f for f in findings if not f.waived]
    for f in findings:
        if not f.waived or args.show_waived:
            print(f.format())
    print(f"repro-lint: {len(unwaived)} finding(s), "
          f"{len(findings) - len(unwaived)} waived")
    return 1 if unwaived else 0
