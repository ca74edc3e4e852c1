"""Nothing the harness runs imports JAX or the JAX package (compared by
whole top-level names: the port's name begins with the JAX package's), and
no harness file reads the JAX package's ``benchmarks/`` folder."""
import subprocess
import sys

from bench.tests.conftest import ROOT

SMOKE_RUN = """
import sys, torch
sys.path.insert(0, {root!r})
from bench.lib import cell
from bench.lib.manifest import Manifest
m = Manifest({smoke!r})
for w in ("qwen3_8b.train_4k", "qwen3_8b.docqa_c32"):
    cell.execute(m, w, 2 ** 31 + 5, 0.5, False, torch.device("cpu"), 0.0)
print(sorted({{k.split(".")[0] for k in sys.modules}}))
print(cell.foreign_modules())
"""


def test_a_smoke_run_loads_no_jax(smoke_root):
    code = SMOKE_RUN.format(root=str(ROOT), smoke=str(smoke_root))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=str(smoke_root))
    assert out.returncode == 0, out.stderr[-3000:]
    loaded, foreign = out.stdout.strip().splitlines()[-2:]
    assert "'repro_torch'" in loaded
    assert foreign == "[]"
    for name in ("jax", "jaxlib", "flax", "repro"):
        assert f"'{name}'" not in loaded


def test_whole_names_are_compared():
    from bench.lib import cell
    assert cell.foreign_modules(["repro_torch.kernels.ops", "reproducer",
                                 "jaxtyping", "flaxen.x"]) == []
    assert cell.foreign_modules(["repro.core.router", "jax.numpy", "flax",
                                 "jaxlib.xla_client"]) == [
        "flax", "jax", "jaxlib", "repro"]


def test_no_harness_file_reads_the_jax_benchmarks():
    for path in (ROOT / "bench").rglob("*"):
        if path.is_file() and path.suffix in (".py", ".json") and \
                "tests" not in path.relative_to(ROOT / "bench").parts:
            text = path.read_text()
            assert "benchmarks/" not in text, path
            assert "import jax" not in text and "from repro." not in text, \
                path
