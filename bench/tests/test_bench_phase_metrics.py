"""The pod step's phase metrics: each reads its histogram of the program's
registry as sum over count, in ms, and is absent where the histogram is;
and a serving run at smoke size gives every one of them, its phases
tiling its pod steps."""
import json
from types import SimpleNamespace

import pytest
import torch

from bench.lib import cell, serve_cell
from bench.lib.manifest import Manifest
from bench.tests.conftest import ROOT

PHASE_METRICS = {
    "admit_ms.serve": "serve_step_admit_seconds",
    "prepare_ms.serve": "serve_step_prepare_seconds",
    "decode_dispatch_ms.serve": "serve_step_decode_dispatch_seconds",
    "chunk_dispatch_ms.serve": "serve_step_chunk_dispatch_seconds",
    "finish_ms.serve": "serve_step_finish_seconds",
    "gc_ms.serve": "serve_step_gc_seconds",
}
TILES = ("serve_step_admit_seconds", "serve_step_prepare_seconds",
         "serve_step_dispatch_seconds", "serve_step_device_get_seconds",
         "serve_step_finish_seconds")


def _reader(name, root=ROOT):
    return cell.load_reader(Manifest(root).metric_file(name))


@pytest.mark.parametrize("name", sorted(PHASE_METRICS))
def test_a_phase_metric_is_its_histograms_mean_in_ms(name):
    hist = PHASE_METRICS[name]
    read = _reader(name).read
    assert read(SimpleNamespace(registry={hist: (0.5, 4)})) == \
        pytest.approx(125.0)
    assert read(SimpleNamespace(registry={hist: (0.0, 0)})) is None
    assert read(SimpleNamespace(registry={})) is None
    entry = next(x for x in json.loads(
        (ROOT / "BENCHMARK.json").read_text())["per_layer"]
        if x["name"] == name)
    assert (entry["unit"], entry["better"], entry["source"],
            entry["workloads"]) == ("ms", "lower", "program_span",
                                    ["qwen3_8b.docqa_c32"])


def test_a_serving_run_gives_every_phase(smoke_root):
    m = Manifest(smoke_root)
    cell_ = m.workload("qwen3_8b.docqa_c32")
    cfg, mix = m.config(cell_["config"]), m.traffic(cell_["traffic"])
    run = serve_cell.run(cell_, cfg, mix, 2**31 + 5, 1.0, False,
                         torch.device("cpu"), 0.0)
    reg = run["context"]["registry"]
    ctx = SimpleNamespace(registry=reg)
    for name in PHASE_METRICS:
        assert _reader(name, smoke_root).read(ctx) is not None, name
    steps = reg["serve_step_seconds"]
    assert steps[1] == reg["serve_step_admit_seconds"][1] > 0
    assert sum(reg[h][0] for h in TILES) == pytest.approx(steps[0],
                                                          rel=1e-9)
    halves = reg["serve_step_decode_dispatch_seconds"][0] + \
        reg["serve_step_chunk_dispatch_seconds"][0]
    assert halves == pytest.approx(reg["serve_step_dispatch_seconds"][0],
                                   rel=1e-9)
