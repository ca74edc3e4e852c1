"""The control: the plain reference computed with fp8 products (e4m3
operands, e5m2 gradients, one scale a tensor), put in the program's place,
fails the cell's limits, at a size a test run holds. On the card the same
control was read at each cell's own size (``bench/calibrate.py
--control``; ``bench/checks/<workload>.json`` keeps its readings)."""
import json

import pytest
import torch

from bench.lib import checks, serve_cell, train_cell, traffic, weights
from bench.lib.manifest import Manifest
from bench.reference import common, decoder
from bench.tests.conftest import ROOT


def test_the_training_control_fails(smoke_root):
    workload = "qwen3_8b.train_4k"
    m = Manifest(smoke_root)
    w = m.workload(workload)
    cfg, mix = m.config(w["config"]), m.traffic(w["traffic"])
    layout = decoder.model_module(cfg).layout(cfg)
    cpu = torch.device("cpu")
    ref = train_cell.follow(cfg, mix, layout, 8, cpu, "fp32")
    ctl = train_cell.follow(cfg, mix, layout, 8, cpu, "fp8")
    limits = checks.load_limits(Manifest(ROOT).limits_file(workload))
    ok, table = checks.judge(checks.train_numbers(ctl, ref), limits)
    assert not ok, table


def test_the_serving_control_fails():
    """At D = 1024 over 16 layers, a vocabulary of 65536 and four requests
    of 256 tokens (32 scored): the widest gap of the token the fp8
    reference puts first, beside the float32 reference's best."""
    m = Manifest(ROOT)
    w = m.workload("qwen3_8b.docqa_c32")
    cfg = dict(m.config(w["config"]), hidden_size=1024,
               num_hidden_layers=16, vocab_size=65536, num_attention_heads=8,
               num_key_value_heads=2, head_dim=128, intermediate_size=3072)
    mix = json.loads(json.dumps(m.traffic(w["traffic"])))
    mix["prompt_tokens"] = {"min": 224, "max": 224, "levels": 1}
    mix["new_tokens"] = 32
    layout = decoder.model_module(cfg).layout(cfg)
    reqs = traffic.Requests(mix, 9, cfg["vocab_size"])
    torch.set_num_threads(4)
    chosen = []
    for j in range(4):
        r = reqs.get(j)
        g = torch.Generator().manual_seed(j)
        out = torch.randint(0, cfg["vocab_size"], (32,), generator=g)
        chosen.append(serve_cell.Sent(j, len(r.tokens), 0.0, True,
                                      tokens=out.tolist()))
    gaps = serve_cell.served_gaps(cfg, layout, 9, reqs, chosen,
                                  torch.device("cpu"), ("fp8",))["fp8"]
    limits = checks.load_limits(m.limits_file("qwen3_8b.docqa_c32"))
    assert len(gaps) == 128
    assert max(gaps) > limits["gap"], max(gaps)


def test_the_weights_are_drawn_again_alike():
    cfg = Manifest(ROOT).config("qwen3_8b_8l")
    cfg = dict(cfg, hidden_size=64, num_attention_heads=4,
               num_key_value_heads=2, head_dim=16, intermediate_size=128,
               vocab_size=256, num_hidden_layers=2)
    layout = decoder.model_module(cfg).layout(cfg)
    cpu = torch.device("cpu")
    w = weights.make_weights(layout, 2, 2 ** 33, 1, cpu, torch.bfloat16)
    again = weights.draw_group(layout, 2 ** 33, 1, 2, cpu, torch.bfloat16)
    for path, t in again.items():
        flat = dict(common.leaves(w))[path]
        assert torch.equal(flat[1], t), path
    other = weights.make_weights(layout, 2, 2 ** 33, 0, cpu, torch.bfloat16)
    assert not torch.equal(other["blocks"]["attn"]["wq"],
                           w["blocks"]["attn"]["wq"])
