"""Serving launcher — decentralized continuous batching (paper §5.2) on
the port (twin of ``repro.launch.serve``).

Loads the per-expert checkpoints and the centroid router of a training
run, and serves synthetic multimodal requests through the
``DecentralizedSlotServer``: with ``--strategy top1`` the Eq. 28 router
picks each request's pod at submission; with ``--strategy mixture``
(``--top-k`` experts weigh in) one core serves the stacked experts and
mixes their next-token distributions by Eq. 27, routing each request at
admission. Either serves contiguous per-slot KV caches with monolithic
prefill at admission (``--paged`` / ``--chunked-prefill`` switch to the
paged pool and to chunked prefill; ``--speculative ngram`` adds n-gram
speculative decoding on the paged pool, and under the mixture
``--speculative expert`` drafts with expert 0) and decodes with the fused
step, greedy or, with ``--slot-temperature`` (and ``--slot-top-k``),
sampled, seeded per request by ``--seed``.
``--arch`` takes every ported config: ``qwen3_8b``, ``granite_3_8b``,
``llama3_405b`` and ``phi3_medium_14b`` (dense) and ``zamba2_2_7b``
(hybrid, whose prefill chunk must be a multiple of its chunkwise-scan
length, 16 at smoke size). Like the reference's, this launcher has no
image frontend: an ``internvl2_2b`` (vlm) request carries no patches, so
it is refused where the reference's fails, at submission when its text
plus the 16-row image prefix overflows the context, else at its first
admission ("the batch has no 'patches'"). Runs on the card unless
``--device cpu``.

    PYTHONPATH=src python -m repro_torch.launch.serve --run /tmp/run \\
        --arch qwen3_8b --requests 16 --new-tokens 24 --slots 8 \\
        [--strategy mixture --top-k 2]
        [--paged --page-block 16 [--chunked-prefill --prefill-chunk 16]
         [--speculative ngram|expert --spec-len 4]]
        [--slot-temperature 0.8 --slot-top-k 50]

The flags are the reference launcher's for this slice. Every serving flag
lands in ONE ``EngineConfig``; what the port has not reached yet (prefix
cache, preemption, sanitizer, tracing, metrics, the unfused step) is
refused by ``EngineConfig.validate`` with one ValueError before any work
starts.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.checkpoint import ckpt
from repro_torch.configs.base import PORTED_ARCH_IDS, get_smoke_config
from repro_torch.core.router import CentroidRouter, RouterConfig
from repro_torch.data.synthetic import SyntheticConfig, SyntheticMultimodal
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.serve.api import EngineConfig, SamplingParams
from repro_torch.serve.scheduler import Request, make_engine
from repro_torch.weights import from_tree


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--run", required=True, help="training run dir")
    ap.add_argument("--arch", choices=PORTED_ARCH_IDS, default="qwen3_8b")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=24)
    ap.add_argument("--top-k", type=int, default=1)
    ap.add_argument("--strategy", choices=["top1", "mixture"],
                    default="top1")
    ap.add_argument("--slots", type=int, default=8,
                    help="cache slots per pod")
    ap.add_argument("--paged", action="store_true",
                    help="block-table paged KV cache")
    ap.add_argument("--page-block", type=int, default=16)
    ap.add_argument("--pool-blocks", type=int, default=0,
                    help="physical blocks per pod (0 → full capacity)")
    ap.add_argument("--chunked-prefill", action="store_true",
                    help="chunked prefill co-scheduled with decode (needs "
                         "--paged)")
    ap.add_argument("--prefill-chunk", type=int, default=16)
    ap.add_argument("--token-budget", type=int, default=0)
    ap.add_argument("--prefix-cache", action="store_true")
    ap.add_argument("--slot-temperature", type=float, default=0.0,
                    help="per-request sampling temperature (0 → greedy; "
                         "seeded per request by --seed)")
    ap.add_argument("--slot-top-k", type=int, default=0,
                    help="sample from the k highest-scoring tokens (0 → "
                         "the full vocabulary)")
    ap.add_argument("--stop-token", type=int, action="append", default=None)
    ap.add_argument("--stream", action="store_true",
                    help="print per-token deltas as they decode")
    ap.add_argument("--preemption", choices=["off", "recompute", "swap"],
                    default="off")
    ap.add_argument("--sanitize", action="store_true")
    ap.add_argument("--no-fused-step", action="store_true")
    ap.add_argument("--speculative", choices=["ngram", "expert"],
                    default=None)
    ap.add_argument("--spec-len", type=int, default=4)
    ap.add_argument("--trace-out", default=None, metavar="PATH")
    ap.add_argument("--metrics-out", default=None, metavar="PATH")
    ap.add_argument("--vocab", type=int, default=512)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch).reduced(vocab=args.vocab)
    model = build_model(cfg)
    ecfg = EngineConfig(
        n_slots=args.slots, cache_len=args.prompt_len + args.new_tokens + 1,
        paged=args.paged, page_block=args.page_block,
        pool_blocks=args.pool_blocks, chunked_prefill=args.chunked_prefill,
        chunk=args.prefill_chunk, token_budget=args.token_budget,
        prefix_cache=args.prefix_cache, fused_step=not args.no_fused_step,
        sanitize=args.sanitize, preemption=args.preemption,
        strategy=args.strategy, speculative=args.speculative,
        spec_len=args.spec_len, trace=args.trace_out is not None,
        metrics=args.metrics_out is not None)
    ecfg.validate(model)
    device = resolve_device(args.device)

    centroids, tau, _ = ckpt.load_router(args.run)
    router = CentroidRouter(torch.as_tensor(centroids, dtype=torch.float32),
                            RouterConfig(temperature=tau, top_k=args.top_k))
    experts = []
    while True:
        state, _ = ckpt.restore_expert(args.run, len(experts))
        if state is None:
            break
        experts.append(from_tree(state["params"], device))
    if not experts:
        raise FileNotFoundError(f"no expert checkpoints under {args.run}")
    print(f"loaded {len(experts)} experts (router τ={tau}) on {device}")

    corpus = SyntheticMultimodal(SyntheticConfig(
        vocab=args.vocab, seq_len=args.prompt_len, seed=args.seed + 7))
    batch_np = corpus.sample_batch(args.requests, step=123)
    server = make_engine(model, experts=experts, router=router, config=ecfg,
                         device=device)
    reqs = [Request(i, batch_np["tokens"][i], args.new_tokens,
                    features=batch_np["features"][i],
                    params=SamplingParams(
                        max_new=args.new_tokens,
                        temperature=args.slot_temperature,
                        top_k=args.slot_top_k, seed=args.seed + i,
                        stop_token_ids=tuple(args.stop_token or ())))
            for i in range(args.requests)]
    routed = server.route(reqs)             # one batched router launch

    t0 = time.perf_counter()
    for req in reqs:
        server.add_request(req)
    finished, reasons = {}, {}
    while server.has_unfinished():
        for o in server.step():
            if args.stream and o.deltas:
                tail = f"  [{o.finish_reason}]" if o.finished else ""
                print(f"rid={o.rid:3d} +{[d.token for d in o.deltas]}{tail}")
            if o.finished:
                finished[o.rid] = o.token_ids
                reasons[o.rid] = o.finish_reason
    dt = time.perf_counter() - t0
    n_tok = sum(len(v) for v in finished.values())
    report = {
        "requests": args.requests, "new_tokens": args.new_tokens,
        "strategy": args.strategy, "slots": args.slots,
        "device": str(device), "pods": server.occupancy(),
        "wall_s": dt, "tok_per_s": n_tok / dt,
        "requests_per_expert": np.bincount(
            routed, minlength=len(experts)).tolist(),
        "finish_reasons": [reasons[i] for i in range(args.requests)],
    }
    if args.speculative is not None:
        pods = report["pods"]
        steps = sum(p["spec_steps"] for p in pods)
        toks = sum(p["spec_tokens"] for p in pods)
        report["spec"] = {"spec_len": args.spec_len, "spec_steps": steps,
                          "spec_tokens": toks,
                          "spec_tokens_per_step": toks / steps if steps
                          else 0.0}
    print(json.dumps(report, indent=1))
    for i in range(min(4, args.requests)):
        print(f"req {i} → expert {routed[i]}: "
              f"prompt={batch_np['tokens'][i, :8].tolist()}… "
              f"gen={finished[i][:12]}…")
    report["tokens"] = finished
    return report


if __name__ == "__main__":
    main()
