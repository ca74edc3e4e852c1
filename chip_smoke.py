#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` and the repository checkout (it builds the
CUDA kernels from ``src/repro_torch/kernels/csrc`` into ``build/kernels``).
Phases, each fatal on failure:

1. device — prints the card's ``nvidia-smi`` name and power limit;
2. build — one ``nvcc`` per kernel source, all started together;
3. kernels — each kernel against its plain PyTorch version at the main
   path's shapes (bf16) and at small float32 edge shapes, with the stated
   tolerances, and timed (kernel, plain version, one library call) with
   CUDA events;
4. parity — the smoke-size float32 Qwen3 deployment (2 pods, top-1) served
   on the card (kernels) and on the CPU (plain versions): greedy tokens,
   finish reasons and routing must be equal;
5. main path — full-width Qwen3-8B (36 layers, bf16, 2 experts of seeded
   random weights) served through ``make_engine`` → ``add_request``/
   ``step`` with the paged pool, chunked prefill and the fused decode
   step; every request must finish, every logit the engine sampled from
   (each decode step and each prefill chunk) must be finite, and every
   kernel's launch counter must be > 0.

The second-to-last line is the ``{"kernels": [...]}`` JSON record, the last
``{"ok": true, "device": {...}}``. Exits non-zero without a result when
there is no card or no checkout around the script.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
SRC = HERE / "src"

# peak rates of one H100 SXM (NVIDIA data sheet, dense): HBM bytes/s, bf16
# tensor-core FLOP/s, float32 FLOP/s outside the tensor cores
HBM_BPS = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
# kernel vs plain version: float32 differs only by summation order and the
# blocked online softmax; bf16 by where each side rounds (the plain version
# rounds the softmax weights to bf16 before the PV product, as ref.py does),
# which is one bf16 ulp (3.9e-3 for outputs in [0.5, 1)) on these inputs:
# the bf16 tolerance is twice that
TOL = {"float32": 5e-5, "bfloat16": 8e-3}

KERNEL_META = {
    "paged_decode_attention": (
        "src/repro_torch/kernels/csrc/decode_attention.cu",
        "src/repro/kernels/decode_attention.py:454"),
    "chunk_prefill_attention": (
        "src/repro_torch/kernels/csrc/decode_attention.cu",
        "src/repro/kernels/decode_attention.py:240"),
    "router_scores": (
        "src/repro_torch/kernels/csrc/router_scores.cu",
        "src/repro/kernels/router_scores.py:34"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call over ``iters`` back-to-back launches,
    timed with CUDA events after ``warmup`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def compare(name, got, want, dtype_name, cases):
    import torch
    err = (got.float() - want.float()).abs()
    tol = TOL[dtype_name]
    bad = (err > tol + tol * want.float().abs()).sum().item()
    finite = bool(torch.isfinite(got.float()).all())
    cases.append({"kernel": name, "max_abs_err": err.max().item(),
                  "dtype": dtype_name, "ok": bad == 0 and finite})
    if bad or not finite:
        raise AssertionError(
            f"{name} ({dtype_name}): {bad} elements beyond atol=rtol={tol} "
            f"(max abs err {err.max().item():.3e}, finite={finite})")


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def _paged_case(B, NB, block, H, KV, dh, pos, dtype, gen, window=0,
                scratch_tail=True):
    """q, pools, pos, tables on the card: distinct physical blocks per slot
    (block 0 is scratch); table entries past a slot's horizon point at the
    scratch block, as the scheduler leaves them."""
    import torch
    dev = "cuda"
    P = B * NB + 1
    q = torch.randn((B, H, dh), generator=gen, device=dev).to(dtype)
    kp = torch.randn((P, block, KV, dh), generator=gen, device=dev).to(dtype)
    vp = torch.randn((P, block, KV, dh), generator=gen, device=dev).to(dtype)
    perm = torch.randperm(P - 1, generator=gen, device=dev) + 1
    bt = perm[:B * NB].reshape(B, NB).to(torch.int32)
    pos_t = torch.tensor(pos, dtype=torch.int32, device=dev)
    if scratch_tail and window <= 0:
        cols = torch.arange(NB, device=dev)[None, :]
        bt = torch.where(cols <= (pos_t[:, None] // block), bt, 0) \
            .to(torch.int32).contiguous()
    return q, kp, vp, pos_t, bt


def _chunk_case(C, NB, block, H, KV, dh, start, dtype, gen):
    import torch
    dev = "cuda"
    P = 2 * NB + 1
    q = torch.randn((C, H, dh), generator=gen, device=dev).to(dtype)
    kp = torch.randn((P, block, KV, dh), generator=gen, device=dev).to(dtype)
    vp = torch.randn((P, block, KV, dh), generator=gen, device=dev).to(dtype)
    perm = torch.randperm(P - 1, generator=gen, device=dev) + 1
    bt = perm[:NB].to(torch.int32).contiguous()
    return q, kp, vp, start, bt


def phase_kernels():
    """Compare and time every kernel; returns {name: record}."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as dk
    from repro_torch.kernels import router_scores as rk

    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = []
    rec = {}

    # -- paged decode at the main path's shapes: 8 slots of Qwen3-8B heads,
    #    positions up to ~1k, 16-position blocks
    B, NB, block, H, KV, dh = 8, 64, 16, 32, 8, 128
    pos = np.random.default_rng(0).integers(200, NB * block, B)
    pos[0] = NB * block - 1
    q, kp, vp, pos_t, bt = _paged_case(B, NB, block, H, KV, dh, pos.tolist(),
                                       bf16, gen)
    got = dk.paged_decode_attention(q, kp, vp, pos_t, bt)
    want = dk.paged_decode_attention_ref(q, kp, vp, pos_t, bt)
    compare("paged_decode_attention", got, want, "bfloat16", cases)
    S = NB * block
    # the library call gets the gathered span with its KV heads repeated to
    # H (head h reads KV head h // group); gathering is not timed
    kf = kp[bt.long()].reshape(B, S, KV, dh).permute(0, 2, 1, 3) \
        .repeat_interleave(H // KV, dim=1).contiguous()
    vf = vp[bt.long()].reshape(B, S, KV, dh).permute(0, 2, 1, 3) \
        .repeat_interleave(H // KV, dim=1).contiguous()
    mask = (torch.arange(S, device="cuda")[None, :]
            <= pos_t[:, None].long())[:, None, None, :]
    keys = int((pos + 1).sum())
    live = int((pos // block + 1).sum())
    nbytes = (2 * B * H * dh * 2 + keys * KV * dh * 2 * 2 + B * 4
              + live * 4)
    flops = 4 * H * dh * keys
    rec["paged_decode_attention"] = {
        "shape": f"B={B} H={H} KV={KV} dh={dh} block={block} NB={NB} "
                 f"pos<= {int(pos.max())} bf16",
        "ms": cuda_ms(lambda: dk.paged_decode_attention(q, kp, vp, pos_t,
                                                        bt)),
        "plain_ms": cuda_ms(lambda: dk.paged_decode_attention_ref(
            q, kp, vp, pos_t, bt)),
        "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
            q[:, :, None], kf, vf, attn_mask=mask)),
        "bytes": nbytes, "flops": flops, "dtype": "bfloat16"}

    # -- chunk prefill at the main path's shapes: a 256-row chunk at
    #    position 512 of a Qwen3-8B prompt
    C, NB, start = 256, 48, 512
    q, kp, vp, start, bt = _chunk_case(C, NB, block, H, KV, dh, start, bf16,
                                       gen)
    got = dk.chunk_prefill_attention(q, kp, vp, start, bt)
    want = dk.chunk_prefill_attention_ref(q, kp, vp, start, bt)
    compare("chunk_prefill_attention", got, want, "bfloat16", cases)
    S = start + C
    kf = kp[bt.long()].reshape(NB * block, KV, dh)[:S].permute(1, 0, 2)[None]
    vf = vp[bt.long()].reshape(NB * block, KV, dh)[:S].permute(1, 0, 2)[None]
    kf = kf.repeat_interleave(H // KV, dim=1).contiguous()
    vf = vf.repeat_interleave(H // KV, dim=1).contiguous()
    cmask = (torch.arange(S, device="cuda")[None, :]
             <= start + torch.arange(C, device="cuda")[:, None])
    keys = sum(start + c + 1 for c in range(C))
    nbytes = 2 * C * H * dh * 2 + S * KV * dh * 2 * 2 + (S // block) * 4
    rec["chunk_prefill_attention"] = {
        "shape": f"C={C} start={start} H={H} KV={KV} dh={dh} block={block} "
                 f"NB={NB} bf16",
        "ms": cuda_ms(lambda: dk.chunk_prefill_attention(q, kp, vp, start,
                                                         bt)),
        "plain_ms": cuda_ms(lambda: dk.chunk_prefill_attention_ref(
            q, kp, vp, start, bt)),
        "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
            q.permute(1, 0, 2)[None], kf, vf, attn_mask=cmask)),
        "bytes": nbytes, "flops": 4 * H * dh * keys, "dtype": "bfloat16"}

    # -- router at the main path's shapes: synthetic-corpus features
    #    (D = 32), K = 2 experts, B = 1 at submission and B = 16 batched
    from repro_torch.data.synthetic import SyntheticConfig
    D, K = SyntheticConfig().feature_dim, 2
    cent = torch.randn((K, D), generator=gen, device="cuda")
    for Bx in (16, 1):
        x = torch.randn((Bx, D), generator=gen, device="cuda")
        compare("router_scores", rk.router_scores(x, cent, 10.0),
                rk.router_scores_ref(x, cent, 10.0), "float32", cases)
    rec["router_scores"] = {
        "shape": f"B=1 D={D} K={K} f32",
        "ms": cuda_ms(lambda: rk.router_scores(x, cent, 10.0), iters=100),
        "plain_ms": cuda_ms(lambda: rk.router_scores_ref(x, cent, 10.0),
                            iters=100),
        "library_ms": None,   # no single PyTorch call computes Eq. 28
        "bytes": (D + K * D + K) * 4, "flops": 3 * K * D + 3 * D + 4 * K,
        "dtype": "float32"}

    # -- float32 at the main path's shapes: here the two sides differ only
    #    by summation order, so a fault confined to one block of a long span
    #    (a dropped horizon block, a wrong table entry) cannot hide in bf16
    #    rounding
    B, NB, H, KV, dh = 8, 64, 32, 8, 128
    q, kp, vp, pos_t, bt = _paged_case(B, NB, block, H, KV, dh, pos.tolist(),
                                       f32, gen)
    compare("paged_decode_attention",
            dk.paged_decode_attention(q, kp, vp, pos_t, bt),
            dk.paged_decode_attention_ref(q, kp, vp, pos_t, bt),
            "float32", cases)
    q, kp, vp, start, bt = _chunk_case(256, 48, block, H, KV, dh, 512, f32,
                                       gen)
    compare("chunk_prefill_attention",
            dk.chunk_prefill_attention(q, kp, vp, start, bt),
            dk.chunk_prefill_attention_ref(q, kp, vp, start, bt),
            "float32", cases)

    # -- small float32 edge shapes
    edge_decode = [
        # B, NB, block, H, KV, dh, pos, window
        (3, 8, 16, 8, 2, 64, [0, 64, 127], 0),        # GQA 4:1, boundaries
        (2, 4, 32, 4, 4, 64, [5, 127], 0),            # MHA
        (1, 4, 64, 4, 1, 128, [200], 0),              # MQA, > 48 KB smem
        (2, 4, 16, 4, 2, 64, [3, 60], 64),            # ring, not wrapped
        (2, 4, 16, 4, 2, 64, [64, 200], 64),          # ring, wrapped
    ]
    for B, NB, block, H, KV, dh, pos, window in edge_decode:
        q, kp, vp, pos_t, bt = _paged_case(B, NB, block, H, KV, dh, pos,
                                           f32, gen, window=window)
        compare("paged_decode_attention",
                dk.paged_decode_attention(q, kp, vp, pos_t, bt,
                                          window=window),
                dk.paged_decode_attention_ref(q, kp, vp, pos_t, bt,
                                              window=window),
                "float32", cases)
    edge_chunk = [
        # C, NB, block, H, KV, dh, start
        (8, 4, 16, 4, 4, 64, 0),        # MHA, first chunk
        (6, 8, 8, 8, 2, 64, 34),        # GQA 4:1, straddles a block
        (16, 4, 32, 4, 1, 128, 112),    # MQA, ends at capacity
    ]
    for C, NB, block, H, KV, dh, start in edge_chunk:
        q, kp, vp, start, bt = _chunk_case(C, NB, block, H, KV, dh, start,
                                           f32, gen)
        compare("chunk_prefill_attention",
                dk.chunk_prefill_attention(q, kp, vp, start, bt),
                dk.chunk_prefill_attention_ref(q, kp, vp, start, bt),
                "float32", cases)
    x = torch.randn((100, 64), generator=gen, device="cuda")
    c6 = torch.randn((6, 64), generator=gen, device="cuda")
    compare("router_scores", rk.router_scores(x, c6, 1.0),
            rk.router_scores_ref(x, c6, 1.0), "float32", cases)
    xb, cb = x[:8, :32].to(bf16).contiguous(), c6[:2, :32].to(bf16)
    compare("router_scores", rk.router_scores(xb, cb.contiguous(), 10.0),
            rk.router_scores_ref(xb, cb, 10.0), "bfloat16", cases)
    torch.cuda.synchronize()

    for name, r in rec.items():
        mine = [c for c in cases if c["kernel"] == name]
        r["cases"] = len(mine)
        # the error at the main path's dtype (its tolerance is the one the
        # record states), and per dtype over every case
        r["max_abs_err_by_dtype"] = {
            d: max(c["max_abs_err"] for c in mine if c["dtype"] == d)
            for d in sorted({c["dtype"] for c in mine})}
        r["max_abs_err"] = r["max_abs_err_by_dtype"][r["dtype"]]
        t_bytes = r["bytes"] / HBM_BPS * 1e3
        t_ops = r["flops"] / PEAK_FLOPS[r["dtype"]] * 1e3
        r["bound_ms"] = max(t_bytes, t_ops)
        r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        log(f"kernel {name}: {r['shape']}: {r['cases']} cases within "
            f"tolerance, max abs err by dtype {r['max_abs_err_by_dtype']}; "
            f"{r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, library "
            f"{r['library_ms']}, bound {r['bound_ms']:.4f} by "
            f"{r['bound_by']})")
    return rec


# ---------------------------------------------------------------------------
# Phases 4-5: serving
# ---------------------------------------------------------------------------

def _serve(engine, prompts, feats, params):
    """Drive ``engine`` to completion; returns ({rid: (tokens, reason)},
    [[rids] per pod], outputs-by-rid, steps, wall seconds)."""
    import torch
    for i, p in enumerate(prompts):
        engine.add_request(p, params, features=feats[i], rid=i)
    routing = [[r.rid for r in pod.waiting] for pod in engine.pods]
    res, outs, steps = {}, {}, 0
    t0 = time.perf_counter()
    while engine.has_unfinished():
        for o in engine.step():
            if o.finished:
                res[o.rid] = (o.token_ids, o.finish_reason)
                outs[o.rid] = o
        steps += 1
    if engine.device.type == "cuda":
        torch.cuda.synchronize()
    return res, routing, outs, steps, time.perf_counter() - t0


def phase_parity():
    """Smoke-size float32 deployment: card (kernels) vs CPU (plain)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.router import CentroidRouter
    from repro_torch.models import build_model
    from repro_torch.serve.api import EngineConfig, SamplingParams
    from repro_torch.serve.scheduler import make_engine

    cfg = get_smoke_config("qwen3_8b")
    model = build_model(cfg)
    experts = [model.init(torch.Generator().manual_seed(k)) for k in (0, 1)]
    rng = np.random.default_rng(1)
    router = CentroidRouter(torch.as_tensor(
        rng.normal(size=(2, 32)).astype(np.float32)))
    lens = [5, 13, 19, 8, 30, 3, 40, 17]
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in lens]
    feats = rng.normal(size=(len(lens), 32)).astype(np.float32)
    ecfg = EngineConfig(n_slots=2, cache_len=56, paged=True, page_block=8,
                        chunked_prefill=True, chunk=16)
    sp = SamplingParams(max_new=12)
    runs = {dev: _serve(make_engine(model, experts=experts, router=router,
                                    config=ecfg, device=dev),
                        prompts, feats, sp)
            for dev in ("cuda", "cpu")}
    (gpu, groute, *_), (cpu, croute, *_) = runs["cuda"], runs["cpu"]
    if groute != croute or gpu != cpu:
        diff = [i for i in cpu if gpu.get(i) != cpu[i]]
        raise AssertionError(f"card and CPU disagree: routing {groute} vs "
                             f"{croute}; requests {diff}: "
                             f"{[(gpu.get(i), cpu[i]) for i in diff]}")
    log(f"parity: {len(cpu)} requests, routing {groute}, greedy tokens and "
        f"finish reasons equal on the card and the CPU")


def phase_main_path():
    """Full-width Qwen3-8B, 2 experts, top-1, paged + chunked + fused
    (``repro_torch/launch/main_path.py``)."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import main_path

    t0 = time.perf_counter()
    mp = main_path.build("cuda")
    torch.cuda.synchronize()
    cfg, model = mp.cfg, mp.model
    log(f"main path: {main_path.N_EXPERTS} experts of {cfg.arch_id} "
        f"({cfg.n_layers} layers, D={cfg.d_model}, bf16) initialized in "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card")
    mp.warm()
    torch.cuda.synchronize()

    # every logit the engine samples from (the decode forward inside each
    # fused step, the last row of each prefill chunk) is folded into one
    # flag kept on the card and read once after the run
    finite = torch.ones((), dtype=torch.bool, device="cuda")

    def watched(fn):
        def run(*args, **kwargs):
            out = fn(*args, **kwargs)
            finite.logical_and_(torch.isfinite(out[0]).all())
            return out
        return run

    model.decode_step_paged = watched(model.decode_step_paged)
    model.prefill_chunk = watched(model.prefill_chunk)
    try:
        ops.reset_launch_counts()
        res, routing, outs, steps, wall = _serve(
            mp.engine, mp.prompts, mp.features, mp.sampling)
        launches = {n: fn.launches for n, fn in ops.KERNELS.items()}
    finally:
        del model.decode_step_paged, model.prefill_chunk
    n_req = len(mp.prompts)
    if len(res) != n_req or any(r is None for _, r in res.values()):
        raise AssertionError(f"unfinished requests: {sorted(res)}")
    zero = [n for n, c in launches.items() if c == 0]
    if zero:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{zero}")
    if not bool(finite):
        raise AssertionError("non-finite logits on the main path")
    n_tok = sum(len(t) for t, _ in res.values())
    stats = {"requests": n_req,
             "prompt_tokens": int(sum(len(p) for p in mp.prompts)),
             "new_tokens": mp.sampling.max_new, "generated_tokens": n_tok,
             "requests_per_pod": [len(r) for r in routing],
             "finish_reasons": sorted({r for _, r in res.values()}),
             "logits_finite": True,
             "steps": steps, "wall_s": wall, "tok_per_s": n_tok / wall,
             "mean_ttft_s": float(np.mean([o.ttft for o in outs.values()])),
             "step_ms": wall / steps * 1e3, "launches": launches,
             "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
    log("main path: " + json.dumps(stats))
    return launches


def main() -> int:
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {Path(__file__).name} "
              f"— run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this check "
              "needs the card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    from repro_torch.kernels import build
    t0 = time.perf_counter()
    libs = build.build_all()
    log(f"build: {len(libs)} libraries in {time.perf_counter() - t0:.1f} s")
    for name in libs:
        logf = build.build_dir() / f"{name}.log"
        if logf.exists():
            for line in logf.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    log(f"  {name}: {line.strip()}")

    rec = phase_kernels()
    phase_parity()
    launches = phase_main_path()

    kernels = []
    for name, (source, replaces) in KERNEL_META.items():
        r = rec[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "tol": TOL[r["dtype"]],
            "max_abs_err_by_dtype": r["max_abs_err_by_dtype"],
            "shape": r["shape"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
