"""``BENCHMARK.json`` against the contract, and a cell, mix and per-layer
metric added to a copy by new files and entries alone."""
import json
import shutil

import torch

from bench.lib import cell, manifest
from bench.lib.manifest import Manifest
from bench.tests import smoke
from bench.tests.conftest import ROOT


def test_the_manifest_keeps_the_contract():
    assert manifest.problems(ROOT) == []


def test_names_units_and_moves():
    doc = json.loads((ROOT / "BENCHMARK.json").read_text())
    m = Manifest(ROOT)
    for kind in ("end_to_end", "per_layer"):
        for x in doc[kind]:
            assert manifest.NAME.match(x["name"])
            assert manifest.UNIT.match(x["unit"])
    for x in doc["per_layer"]:
        for c in x["workloads"]:
            reported = [e["name"] for e in m.metrics_of("end_to_end", c)]
            assert x["moves"] in reported, (x["name"], c)
    for w in doc["workloads"]:
        e2e = [e["name"] for e in m.metrics_of("end_to_end", w["name"])]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert m.metrics_of("per_layer", w["name"])


def test_a_broken_manifest_is_caught(tmp_path):
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    doc = json.loads((ROOT / "BENCHMARK.json").read_text())
    doc["configs"][1]["reduced"].append("hidden_size")
    doc["per_layer"][0]["moves"] = "serve_tokens_per_s"
    doc["per_layer"][0]["workloads"] = ["qwen3_8b.train_4k"]
    doc["end_to_end"][0]["unit"] = "tokens per second"
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(doc))
    found = " | ".join(manifest.problems(tmp_path))
    assert "reduced names a width 'hidden_size'" in found
    assert "does not report serve_tokens_per_s" in found
    assert "unit 'tokens per second'" in found


def test_a_cell_mix_and_metric_are_added_by_files_alone(tmp_path):
    root = smoke.make(tmp_path)
    before = {p: p.read_bytes() for p in (root / "bench").rglob("*")
              if p.is_file()}
    bench = root / "bench"
    toy = json.loads((bench / "configs" / "qwen3_8b.json").read_text())
    toy.update(name="toy_dense", num_hidden_layers=1)
    toy["reduced"] = ["num_hidden_layers"]
    (bench / "configs" / "toy_dense.json").write_text(json.dumps(toy))
    mix = json.loads((bench / "traffic" / "train_4k.json").read_text())
    mix.update(seq_len=32, check_steps=2)
    (bench / "traffic" / "toy_train.json").write_text(json.dumps(mix))
    (bench / "metrics" / "host_share.toy.py").write_text(
        '"""Share of the traced window the device was busy."""\n\n\n'
        "def read(ctx):\n"
        "    return 100.0 * ctx.trace['busy_s'] / ctx.trace['window_s']\n")
    (bench / "checks" / "toy_dense.toy_train.json").write_text(json.dumps(
        {"limits": {"loss": 1.0, "grad": 1.0, "change": 1.0}}))
    doc = json.loads((root / "BENCHMARK.json").read_text())
    doc["configs"].append({"name": "toy_dense", "source": toy["source"],
                           "file": "bench/configs/toy_dense.json",
                           "reduced": ["num_hidden_layers"],
                           "why": "a toy cell added by files alone"})
    doc["workloads"].append({"name": "toy_dense.toy_train",
                             "config": "toy_dense", "traffic": "toy_train",
                             "chips": 1, "why": "a toy cell"})
    for e in doc["end_to_end"]:
        if e["name"] == "train_tokens_per_s":
            e["workloads"].append("toy_dense.toy_train")
    doc["per_layer"].append({"name": "host_share.toy", "unit": "%",
                             "better": "lower", "source": "device_trace",
                             "layer": "device",
                             "moves": "train_tokens_per_s",
                             "workloads": ["toy_dense.toy_train"]})
    (root / "BENCHMARK.json").write_text(json.dumps(doc))
    assert manifest.problems(root) == []
    after = {p: p.read_bytes() for p in before}
    assert after == before          # no file that was there was edited
    m = Manifest(root)
    r = cell.execute(m, "toy_dense.toy_train", 11, 0.5, False,
                     torch.device("cpu"), 0.0)
    assert r["correct"] and "train_tokens_per_s" in r["metrics"]
    r = cell.execute(m, "toy_dense.toy_train", 11, 0.5, True,
                     torch.device("cpu"), 0.0)
    assert r["correct"] and r["metrics"]["host_share.toy"]["unit"] == "%"
