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
step (``--no-fused-step``: the unfused one, the same tokens), greedy or,
with ``--slot-temperature`` (and ``--slot-top-k``), sampled, seeded per
request by ``--seed``. ``--engine batch`` serves the whole request batch
with the ``DecentralizedServer`` instead (``generate_top1`` or
``generate_mixture``: lockstep over the whole budget, greedy at
``--temperature 0``, else drawn from the split key chain of ``--seed``).
The serving host layer
rides on the paged paths: ``--prefix-cache`` (paged + chunked),
``--preemption swap|recompute`` with ``--priorities`` and ``--tenants``
(and the QoS knobs ``--tenant-weight``, ``--qos-quantum``,
``--admit-lookahead``, ``--max-predicted-ttft``, ``--max-waiting``),
``--sanitize``, and the telemetry exports ``--trace-out`` (a
Chrome/Perfetto trace of every pod) and ``--metrics-out`` (a JSON
snapshot of every pod's registry).
``--arch`` takes every ported config: ``qwen3_8b``, ``granite_3_8b``,
``llama3_405b`` and ``phi3_medium_14b`` (dense), ``deepseek_moe_16b`` and
``qwen3_moe_235b_a22b`` (moe), ``zamba2_2_7b`` (hybrid) and ``xlstm_125m``
(ssm; it has no pageable leaves, so ``--paged`` serves its per-slot
states) — a recurrent family's prefill chunk must be a multiple of its
chunkwise-scan length, 16 at smoke size. Like the reference's, this launcher has no
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
        [--slot-temperature 0.8 --slot-top-k 50] [--no-fused-step]
        [--prefix-cache] [--preemption swap --priorities 0 --priorities 1
         --tenants 2 --tenant-weight tenant-1=3] [--sanitize]
        [--trace-out /tmp/trace.json --metrics-out /tmp/metrics.json]
        [--engine batch [--temperature 0.8]]

The flags are the reference launcher's. Every slot-engine flag lands in
ONE ``EngineConfig``, whose ``validate`` refuses a bad combination with
one ValueError before any work starts.
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
from repro_torch.serve.api import EngineConfig, QoSConfig, SamplingParams
from repro_torch.serve.ensemble_engine import DecentralizedServer
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
    ap.add_argument("--temperature", type=float, default=1.0,
                    help="batch engine only; the slot engine samples with "
                         "--slot-temperature")
    ap.add_argument("--strategy", choices=["top1", "mixture"],
                    default="top1")
    ap.add_argument("--engine", choices=["slots", "batch"], default="slots")
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
                    default="off",
                    help="under pool pressure park a lower-priority "
                         "request: 'swap' moves its blocks to host memory, "
                         "'recompute' re-prefills it at resume")
    ap.add_argument("--tenant-weight", action="append", default=None,
                    metavar="NAME=W",
                    help="QoS fair-share weight of a tenant (repeatable; "
                         "unlisted tenants weigh 1.0)")
    ap.add_argument("--qos-quantum", type=int, default=0,
                    help="DRR credit per round in prompt tokens (0 → the "
                         "prefill chunk)")
    ap.add_argument("--admit-lookahead", type=int, default=0,
                    help="admission skip-ahead past an unservable queue "
                         "head (0 → 8)")
    ap.add_argument("--max-predicted-ttft", type=float, default=0.0,
                    help="reject a submission whose predicted TTFT exceeds "
                         "this many seconds (0 → off; needs "
                         "--chunked-prefill)")
    ap.add_argument("--max-waiting", type=int, default=0,
                    help="reject submissions once the queue is this deep "
                         "(0 → unbounded)")
    ap.add_argument("--tenants", type=int, default=1,
                    help="assign requests round-robin to this many tenants "
                         "(tenant-0, tenant-1, …)")
    ap.add_argument("--priorities", type=int, action="append", default=None,
                    help="request priority cycle (repeatable): request i "
                         "gets the i-th value mod the list's length")
    ap.add_argument("--sanitize", action="store_true",
                    help="run the PoolSanitizer over the paged pool every "
                         "step (needs --paged)")
    ap.add_argument("--no-fused-step", action="store_true")
    ap.add_argument("--speculative", choices=["ngram", "expert"],
                    default=None)
    ap.add_argument("--spec-len", type=int, default=4)
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write a Chrome/Perfetto trace of the run to PATH")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write a JSON snapshot of every pod's metrics to "
                         "PATH")
    ap.add_argument("--vocab", type=int, default=512)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch).reduced(vocab=args.vocab)
    model = build_model(cfg)
    cache_len = args.prompt_len + args.new_tokens + 1
    slots = args.engine == "slots"
    qos = None
    if (args.tenant_weight or args.qos_quantum or args.admit_lookahead
            or args.max_predicted_ttft or args.max_waiting):
        qos = QoSConfig(
            tenant_weights=tuple(
                (name, float(w)) for name, _, w in
                (t.partition("=") for t in args.tenant_weight or ())),
            quantum=args.qos_quantum,
            admit_lookahead=args.admit_lookahead or 8,
            max_predicted_ttft_s=args.max_predicted_ttft,
            max_waiting=args.max_waiting)
    ecfg = EngineConfig(
        n_slots=args.slots, cache_len=cache_len, paged=args.paged, page_block=args.page_block,
        pool_blocks=args.pool_blocks, chunked_prefill=args.chunked_prefill,
        chunk=args.prefill_chunk, token_budget=args.token_budget,
        prefix_cache=args.prefix_cache, fused_step=not args.no_fused_step,
        sanitize=args.sanitize, qos=qos, preemption=args.preemption,
        strategy=args.strategy, speculative=args.speculative,
        spec_len=args.spec_len, trace=args.trace_out is not None,
        metrics=args.metrics_out is not None)
    if slots:
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
    if not slots:
        return _serve_batch(args, model, experts, router, batch_np,
                            cache_len, device)
    server = make_engine(model, experts=experts, router=router, config=ecfg,
                         device=device)
    prios = args.priorities or (0,)
    reqs = [Request(i, batch_np["tokens"][i], args.new_tokens,
                    features=batch_np["features"][i],
                    params=SamplingParams(
                        max_new=args.new_tokens,
                        temperature=args.slot_temperature,
                        top_k=args.slot_top_k, seed=args.seed + i,
                        stop_token_ids=tuple(args.stop_token or ()),
                        priority=prios[i % len(prios)],
                        tenant=f"tenant-{i % args.tenants}"
                        if args.tenants > 1 else "default"))
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
        "engine": args.engine, "strategy": args.strategy,
        "slots": args.slots, "paged": args.paged,
        "chunked_prefill": args.chunked_prefill,
        "prefix_cache": args.prefix_cache,
        "fused_step": not args.no_fused_step, "stream": args.stream,
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
    if args.trace_out:
        server.export_trace(args.trace_out)
        print(f"trace written to {args.trace_out} (load in "
              f"ui.perfetto.dev)")
    if args.metrics_out:
        server.export_metrics(args.metrics_out)
        print(f"metrics snapshot written to {args.metrics_out}")
    return _finish(report, args, batch_np, routed, finished)


def _serve_batch(args, model, experts, router, batch_np, cache_len,
                 device) -> dict:
    """``--engine batch``: the whole request batch through the
    ``DecentralizedServer`` — grouped top-1 or the stacked Eq. 27 mixture,
    every request for the whole ``--new-tokens`` budget."""
    batch = {name: torch.as_tensor(batch_np[name], device=device)
             for name in ("tokens", "labels", "features")}
    router = router.to(device)
    routed = router.top1(batch["features"]).cpu().numpy()
    server = DecentralizedServer(model, experts, router, cache_len=cache_len)
    gen = server.generate_top1 if args.strategy == "top1" \
        else server.generate_mixture
    t0 = time.perf_counter()
    arr = np.asarray(torch.as_tensor(gen(batch, SamplingParams(
        max_new=args.new_tokens, temperature=args.temperature,
        seed=args.seed))).cpu())
    dt = time.perf_counter() - t0
    report = {
        "requests": args.requests, "new_tokens": args.new_tokens,
        "engine": args.engine, "strategy": args.strategy,
        "slots": None, "paged": None, "chunked_prefill": None,
        "prefix_cache": None, "fused_step": None, "stream": None,
        "device": str(device), "pods": None, "wall_s": dt,
        "tok_per_s": args.requests * args.new_tokens / dt,
        "requests_per_expert": np.bincount(
            routed, minlength=len(experts)).tolist(),
        "finish_reasons": None,
    }
    return _finish(report, args, batch_np, routed,
                   {i: arr[i].tolist() for i in range(args.requests)})


def _finish(report: dict, args, batch_np, routed, finished) -> dict:
    """Print the JSON report and the first requests' routes and tokens;
    return the report with the tokens of every request."""
    print(json.dumps(report, indent=1))
    for i in range(min(4, args.requests)):
        print(f"req {i} → expert {routed[i]}: "
              f"prompt={batch_np['tokens'][i, :8].tolist()}… "
              f"gen={finished[i][:12]}…")
    report["tokens"] = finished
    return report


if __name__ == "__main__":
    main()
