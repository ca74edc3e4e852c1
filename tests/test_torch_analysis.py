"""The port's repro-lint (``repro_torch.analysis``), twins of the
reference's fixtures (``tests/test_analysis.py``) in torch idiom: for each
rule kept — host-sync and retrace-hazard (RT1, RT3) — flagged and clean
cases, the waiver, the hot-path marker, and the CLI's exit codes, on the
port's own tree too.

Every fixture is a small source file written to ``tmp_path`` and run
through the real ``run_paths`` pipeline, the path ``python -m
repro_torch.analysis`` takes.
"""
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from repro_torch.analysis.lint import main as lint_main
from repro_torch.analysis.lint import run_paths

REPO = Path(__file__).resolve().parents[1]


def lint(tmp_path, src, rules=None, name="mod.py"):
    p = tmp_path / name
    p.write_text(textwrap.dedent(src))
    return run_paths([str(p)], rules)


def unwaived(findings):
    return [f for f in findings if not f.waived]


# ---------------------------------------------------------------------------
# host-sync
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("expr", [
    "int(torch.argmax(scores, -1)[0])",
    "np.asarray(torch.argmax(scores, -1))",
    "scores.argmax(-1).item()",
    "scores.argmax(-1).tolist()",
    "scores.argmax(-1).cpu()",
])
def test_host_sync_flags_a_copy_in_the_step_loop(tmp_path, expr):
    """The reference's greedy-argmax incident, in torch: a hot-class step loop
    copying a token pick to the host outside the step's one readback."""
    fs = lint(tmp_path, f"""
        import numpy as np
        import torch

        class _SlotTable:
            def _next_tokens(self, scores):
                return {expr}
    """, rules=["host-sync"])
    assert len(unwaived(fs)) == 1, [f.format() for f in fs]
    assert "host hot path" in fs[0].msg and fs[0].line == 7


def test_host_sync_flags_a_truth_test_of_a_tensor(tmp_path):
    fs = lint(tmp_path, """
        import torch

        class SlotServer:
            def step(self, done):
                finished = torch.any(done)
                if finished:
                    return 1
                return 0
    """, rules=["host-sync"])
    assert len(unwaived(fs)) == 1 and "truth test" in fs[0].msg


def test_host_sync_flags_in_a_marked_function(tmp_path):
    fs = lint(tmp_path, """
        import torch

        def poll(scores):  # repro: hot-path
            return float(torch.softmax(scores, -1).max())
    """, rules=["host-sync"])
    assert len(unwaived(fs)) == 1 and "float" in fs[0].msg


def test_host_sync_clean_on_the_readback(tmp_path):
    """The fused-step contract: one launch, one explicit ``.cpu().numpy()``
    of everything the host needs, then free host use of what it read."""
    fs = lint(tmp_path, """
        import torch

        class _SlotTable:
            def _decode_step(self):
                nxt, done = self._run_fused(self.state)
                host = torch.stack([nxt, done]).cpu().numpy()
                toks = host[0]
                if host[1].any():
                    return int(toks[0]), toks.tolist()
                return None
    """, rules=["host-sync"])
    assert unwaived(fs) == []


def test_host_sync_clean_outside_hot_scope(tmp_path):
    fs = lint(tmp_path, """
        import torch

        class OfflineEval:
            def best(self, scores):
                return int(torch.argmax(scores)), scores.cpu()
    """, rules=["host-sync"])
    assert unwaived(fs) == []


def test_host_sync_waiver(tmp_path):
    fs = lint(tmp_path, """
        import torch

        class MixtureSlotServer:
            def _admit(self, logits):
                # repro: allow-host-sync admission's first token
                return int(torch.argmax(logits))
    """, rules=["host-sync"])
    assert len(fs) == 1 and fs[0].waived
    assert unwaived(fs) == []


def test_host_sync_nested_copy_flags_once(tmp_path):
    fs = lint(tmp_path, """
        import torch

        class _SlotTable:
            def pick(self, row):
                return int(torch.argmax(row).cpu()[0])
    """, rules=["host-sync"])
    assert len(unwaived(fs)) == 1 and ".cpu()" in fs[0].msg


# ---------------------------------------------------------------------------
# retrace-hazard
# ---------------------------------------------------------------------------

def test_retrace_flags_compile_in_loop(tmp_path):
    fs = lint(tmp_path, """
        import torch

        def bench(fns, x):
            outs = []
            for fn in fns:
                outs.append(torch.compile(fn)(x))
            return outs
    """, rules=["retrace-hazard"])
    assert len(unwaived(fs)) == 1 and "inside a loop" in fs[0].msg


def test_retrace_flags_compile_in_a_hot_function(tmp_path):
    fs = lint(tmp_path, """
        import torch

        class SlotServer:
            def step(self, x):
                return torch.compile(self.fwd)(x)
    """, rules=["retrace-hazard"])
    assert len(unwaived(fs)) == 1 and "hot-path" in fs[0].msg


@pytest.mark.parametrize("body", [
    "return torch.zeros(int(mask.sum()))",
    "n = int(torch.count_nonzero(mask))\n    return torch.arange(n)",
    "return mask.new_zeros(mask.sum().item(), 4)",
])
def test_retrace_flags_value_dependent_shape(tmp_path, body):
    fs = lint(tmp_path, f"""
import torch

def gather(mask):
    mask = torch.as_tensor(mask)
    {body}
""", rules=["retrace-hazard"])
    assert len(unwaived(fs)) == 1 and "value-dependent shape" in fs[0].msg


def test_retrace_clean_on_setup_compile_and_host_shapes(tmp_path):
    fs = lint(tmp_path, """
        import torch

        class SlotServer:
            def __init__(self, fwd, n):
                self._step = torch.compile(fwd)
                self.buf = torch.zeros(n, 4)

            def make_step(self, fwd):
                return torch.compile(fwd)

            def grow(self, x):
                return torch.zeros(x.shape[0] * 2)
    """, rules=["retrace-hazard"])
    assert unwaived(fs) == []


def test_retrace_waiver(tmp_path):
    fs = lint(tmp_path, """
        import torch

        def gather(mask):
            mask = torch.as_tensor(mask)
            # repro: allow-retrace-hazard bounded by the pool size
            return torch.zeros(int(mask.sum()))
    """, rules=["retrace-hazard"])
    assert len(fs) == 1 and fs[0].waived


# ---------------------------------------------------------------------------
# runner and the port's own tree
# ---------------------------------------------------------------------------

def test_main_exit_codes(tmp_path, capsys):
    bad = tmp_path / "bad.py"
    bad.write_text(textwrap.dedent("""
        import torch

        class _SlotTable:
            def f(self, s):
                return s.argmax().item()
    """))
    assert lint_main([str(bad)]) == 1
    out = capsys.readouterr().out
    assert "[host-sync]" in out and "1 finding(s)" in out
    good = tmp_path / "good.py"
    good.write_text("x = 1\n")
    assert lint_main([str(good)]) == 0


def test_the_ports_tree_is_clean():
    """``python -m repro_torch.analysis src/repro_torch`` exits 0: every
    finding in the serving hot path is a waived readback with its reason."""
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis",
         str(REPO / "src" / "repro_torch")],
        capture_output=True, text=True, timeout=120,
        env={"PYTHONPATH": str(REPO / "src")})
    assert proc.returncode == 0, proc.stdout[-3000:]
    fs = run_paths([str(REPO / "src" / "repro_torch")])
    assert fs and all(f.waived for f in fs)
    for f in fs:
        line = Path(f.path).read_text().splitlines()
        text = line[f.line - 1] + line[f.line - 2]
        reason = text.split("allow-host-sync", 1)[-1].strip()
        assert reason, f"waiver without a reason at {f.format()}"


def test_lint_imports_no_torch():
    code = ("import sys; import repro_torch.analysis.lint, "
            "repro_torch.analysis.rules; "
            "sys.exit('torch' in sys.modules)")
    proc = subprocess.run([sys.executable, "-c", code],
                          env={"PYTHONPATH": str(REPO / "src")},
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
