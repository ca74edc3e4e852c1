"""The metric arithmetic against hand-computed cases: a rate over the
whole window, a p90 over every request sent, and MFU and roofline counts
at known shapes."""
from types import SimpleNamespace

import pytest
import torch

from bench.lib import cell, counts, serve_cell, train_cell
from bench.lib.manifest import Manifest
from bench.reference import decoder
from bench.tests.conftest import ROOT

H100 = {"bf16_flops": 989e12, "hbm_bytes": 3.35e12}


def _reader(name):
    return cell.load_reader(Manifest(ROOT).metric_file(name))


def test_p90_is_the_nearest_rank_over_every_request():
    assert serve_cell.p90(list(range(1, 11))) == 9
    assert serve_cell.p90(list(range(1, 101))) == 90
    assert serve_cell.p90([5.0]) == 5.0
    assert serve_cell.p90([3, 1, 2, 10, 4, 6, 5, 7, 9, 8, 11]) == 10


def test_causal_and_attention_counts():
    assert counts.causal_pairs(0, 4) == 1 + 2 + 3 + 4
    assert counts.causal_pairs(10, 2) == 11 + 12
    cfg = {"num_attention_heads": 32, "head_dim": 128,
           "num_hidden_layers": 2, "hidden_size": 4096}
    assert counts.attn_flops(cfg, 10) == 4 * 10 * 32 * 128 * 2
    assert counts.forward_flops(100, cfg, 0, 3) == \
        2 * 100 * 3 + 4 * 32 * 128 * 2 * 6


def test_dense_parameter_count():
    m = Manifest(ROOT)
    q = m.config("qwen3_8b")
    lay = decoder.model_module(q).layout(q)
    # Qwen3-8B: 8.19 B with both tables; the input table is not counted
    n = counts.dense_params(lay, q)
    assert n == 8_190_735_360 - 151936 * 4096


def test_kernel_counts_at_known_shapes():
    call = {"args": [{"shape": (1, 4096, 32, 128), "dtype": "torch.bfloat16"},
                     {"shape": (1, 4096, 8, 128), "dtype": "torch.bfloat16"}],
            "kwargs": {"causal": True}}
    f, b = counts.flash_fwd(call)
    assert f == 4 * 32 * 128 * 4096 * 4097 / 2
    assert b == 2 * (2 * 4096 * 32 * 128 + 2 * 4096 * 8 * 128) + \
        4 * 4096 * 32
    fb, bb = counts.flash_bwd(call)
    assert fb == 2.5 * f
    cp = {"args": [{"shape": (1, 2048, 32, 128), "dtype": "torch.bfloat16"},
                   {"shape": (6176, 16, 8, 128), "dtype": "torch.bfloat16"},
                   None, 2048, {"shape": (1, 386), "dtype": "torch.int32"}],
          "kwargs": {}}
    f, b = counts.chunk_prefill(cp)
    assert f == 4 * 32 * 128 * (2048 * 2048 + 2048 * 2049 / 2)
    assert b == 2 * (2 * 2048 * 32 * 128 + 2 * 4096 * 8 * 128)
    pd = {"args": [{"shape": (2, 32, 128), "dtype": "torch.bfloat16"},
                   {"shape": (100, 16, 8, 128), "dtype": "torch.bfloat16"},
                   None, {"shape": (2,), "dtype": "torch.int32",
                          "values": [9, 40]},
                   {"shape": (2, 2), "dtype": "torch.int32"}], "kwargs": {}}
    f, b = counts.paged_decode(pd)
    keys = 10 + 32            # the second row's span ends at 2 · 16 - 1
    assert f == 4 * 32 * 128 * keys
    assert b == 2 * (2 * 2 * 32 * 128 + 2 * keys * 8 * 128) + 4 * 2 * 3


def test_roofline_share_is_bound_over_device_time():
    call = {"args": [{"shape": (1, 4096, 32, 128), "dtype": "torch.bfloat16"},
                     {"shape": (1, 4096, 8, 128), "dtype": "torch.bfloat16"}],
            "kwargs": {"causal": True}}
    f, b = counts.flash_fwd(call)
    bound = max(f / H100["bf16_flops"], b / H100["hbm_bytes"])
    ctx = SimpleNamespace(calls={"_flash_fwd": [call, call]}, peaks=H100,
                          trace={"range_s": {"_flash_fwd": 4 * bound}})
    assert _reader("flash_fwd_roofline.train").read(ctx) == \
        pytest.approx(50.0)
    ctx.calls = {}
    assert _reader("flash_fwd_roofline.train").read(ctx) is None


def test_train_mfu_idle_and_elementwise():
    m = Manifest(ROOT)
    cfg, mix = m.config("qwen3_8b_8l"), m.traffic("train_4k")
    lay = decoder.model_module(cfg).layout(cfg)
    N = counts.dense_params(lay, cfg)
    step = 6 * N * 4096 + 3 * 4 * 4096 * 4097 / 2 * 32 * 128 * 8
    ctx = SimpleNamespace(cfg=cfg, mix=mix, layout=lay, peaks=H100,
                          steps=10, window_s=2.0, trace_steps=10,
                          trace={"busy_s": 1.5, "window_s": 2.0,
                                 "group_s": {"other": 0.8}})
    assert _reader("step_mfu.train").read(ctx) == pytest.approx(
        100 * 10 * step / (2.0 * 989e12))
    assert _reader("idle_share.train").read(ctx) == pytest.approx(25.0)
    assert _reader("elementwise_ms.train").read(ctx) == pytest.approx(80.0)


def test_serve_counters_and_mfu():
    ctx = SimpleNamespace(registry={
        "serve_request_queued_seconds": (3.0, 4),
        "serve_step_dispatch_seconds": (1.0, 10),
        "serve_step_device_get_seconds": (0.01, 10)})
    assert _reader("queue_ms.serve").read(ctx) == pytest.approx(750.0)
    assert _reader("dispatch_ms.serve").read(ctx) == pytest.approx(100.0)
    assert _reader("device_get_ms.serve").read(ctx) == pytest.approx(1.0)
    m = Manifest(ROOT)
    cfg = m.config("qwen3_8b")
    lay = decoder.model_module(cfg).layout(cfg)
    N = counts.dense_params(lay, cfg)
    sent = [serve_cell.Sent(0, 100, 0.0, True, streamed=[(0, 1.0),
                                                         (1, 1.5),
                                                         (2, 9.0)])]
    ctx = SimpleNamespace(cfg=cfg, layout=lay, peaks=H100, sent=sent,
                          t0=0.5, t1=2.5, window_s=2.0)
    want = counts.forward_flops(N, cfg, 0, 100) + \
        counts.forward_flops(N, cfg, 100, 1)
    assert _reader("step_mfu.serve").read(ctx) == pytest.approx(
        100 * want / (2.0 * 989e12))


def test_train_rate_is_every_step_over_the_whole_window(smoke_root):
    m = Manifest(smoke_root)
    cell_ = m.workload("qwen3_8b.train_4k")
    cfg, mix = m.config(cell_["config"]), m.traffic(cell_["traffic"])
    run = train_cell.run(cell_, cfg, mix, 5, 1.0, False,
                         torch.device("cpu"), 0.0)
    c = run["context"]
    assert c["tokens"] == run["attempted"] * mix["batch"] * mix["seq_len"]
    assert run["end_to_end"]["train_tokens_per_s"] == pytest.approx(
        c["tokens"] / c["window_s"])
    assert c["window_s"] >= 1.0


def test_serve_rate_and_tail_over_the_window(smoke_root):
    m = Manifest(smoke_root)
    cell_ = m.workload("qwen3_8b.docqa_c32")
    cfg, mix = m.config(cell_["config"]), m.traffic(cell_["traffic"])
    run = serve_cell.run(cell_, cfg, mix, 5, 1.0, False,
                         torch.device("cpu"), 0.0)
    c = run["context"]
    streamed = sum(1 for s in c["sent"] for _, t in s.streamed
                   if c["t0"] < t <= c["t1"])
    assert run["end_to_end"]["serve_tokens_per_s"] == pytest.approx(
        streamed / c["window_s"])
    window = [s for s in c["sent"] if s.in_window]
    assert run["attempted"] == len(window) and run["failed"] == 0
    assert all(s.t_first for s in window)
    assert run["end_to_end"]["ttft_p90_ms"] == pytest.approx(
        1e3 * serve_cell.p90([s.t_first - s.t_send for s in window]))
    # the check scores requests served whole inside the measured window
    by = {s.index: s for s in c["sent"]}
    checked = run["readings"]["checked_requests"]
    assert checked and all(c["t0"] < by[j].t_done <= c["t1"]
                           for j in checked)
