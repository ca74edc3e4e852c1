"""Fixtures of the benchmark's CPU tests: a smoke-size copy of the
benchmark (``smoke.make``) shared by a module's tests, one torch thread."""
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture(scope="module")
def smoke_root(tmp_path_factory):
    from bench.tests import smoke
    torch.set_num_threads(1)
    return smoke.make(tmp_path_factory.mktemp("bench"))
