"""Training launcher — the decentralized pipeline of paper §5.1 on the port
(twin of ``repro.launch.train``):

1. take every unique sample's features from the synthetic corpus;
2. balanced spherical k-means → K disjoint shards + the centroid router;
3. train K experts one after another, each with its own seed, data and
   optimizer and no communication with the others (or the dense baseline
   on everything); the previous expert's state is freed before the next
   one is built;
4. save per-expert checkpoints (``expert_<k>/step_<n>.npz``), the router
   (``router.npz``) and ``train_summary.json``, in the reference's layout.

The flags are the reference launcher's, plus ``--device`` (the card unless
``--device cpu``). The model is the smoke config of ``--arch`` at
``--vocab``, as in the reference; every family trains: dense
(``qwen3_8b``, ``granite_3_8b``, ``llama3_405b``, ``phi3_medium_14b``),
moe, hybrid (``zamba2_2_7b``) and ssm (``xlstm_125m``, the end-to-end
examples' default: ``repro_torch.examples.train_decentralized``), their
chunked scans in their training form; each run dir serves through
``repro_torch.launch.serve --run DIR --arch ARCH``. The synthetic corpus
has no images or audio, so ``--arch internvl2_2b`` and ``--arch
whisper_small`` fail at their first step, where the reference's do: the
batch has no patches, or no frames.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3_8b \\
        --mode decentralized --experts 2 --steps 200 --out /tmp/run \\
        [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import time

import torch

from repro_torch.checkpoint import ckpt
from repro_torch.configs.base import PORTED_ARCH_IDS, get_smoke_config
from repro_torch.data.partition import partition_dataset
from repro_torch.data.pipeline import LoaderConfig, ShardLoader, expert_loaders
from repro_torch.data.synthetic import SyntheticConfig, SyntheticMultimodal
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.trainer import (TrainConfig, init_train_state,
                                       train_host_loop)


def build_corpus(args) -> SyntheticMultimodal:
    return SyntheticMultimodal(SyntheticConfig(
        vocab=args.vocab, seq_len=args.seq_len, n_latent=args.latent,
        n_samples=args.samples, feature_dim=args.feature_dim,
        seed=args.seed))


def opt_config(args) -> AdamWConfig:
    """The launcher's schedule: peak ``--lr``, warmup max(steps // 20, 5),
    cosine to ``--steps``."""
    return AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 5),
                       total_steps=args.steps)


def expert_generator(args, k: int, device) -> torch.Generator:
    """Expert k's init seed (the reference's ``PRNGKey(seed + 100 + k)``;
    torch draws other numbers from it)."""
    return torch.Generator(device=device).manual_seed(args.seed + 100 + k)


def partition_and_loaders(args, corpus: SyntheticMultimodal):
    """Balanced spherical k-means of every sample's features into
    ``--experts`` shards, and one isolated loader per shard at the
    per-expert batch (``--batch`` over K, paper §6.1 compute matching)."""
    part = partition_dataset(corpus.all_features(), args.experts,
                             algorithm=args.clustering, seed=args.seed)
    per_expert_batch = max(args.batch // args.experts, 1)
    return part, expert_loaders(corpus, part.shards, per_expert_batch)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=PORTED_ARCH_IDS, default="qwen3_8b")
    ap.add_argument("--mode", choices=["dense", "decentralized"],
                    default="decentralized")
    ap.add_argument("--experts", type=int, default=2)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=16,
                    help="dense global batch; experts use batch/K (paper "
                         "§6.1 compute matching)")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--vocab", type=int, default=512)
    ap.add_argument("--latent", type=int, default=4)
    ap.add_argument("--samples", type=int, default=2048)
    ap.add_argument("--feature-dim", type=int, default=32)
    ap.add_argument("--clustering", choices=["balanced", "two_stage"],
                    default="balanced")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="/tmp/repro_run")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch).reduced(vocab=args.vocab)
    model = build_model(cfg)
    corpus = build_corpus(args)
    opt = opt_config(args)
    tc = TrainConfig(opt=opt)
    os.makedirs(args.out, exist_ok=True)

    if args.mode == "dense":
        loader = ShardLoader(corpus, LoaderConfig(batch_size=args.batch))
        state = init_train_state(
            model, torch.Generator(device=device).manual_seed(args.seed),
            opt)
        t0 = time.time()
        state, hist = train_host_loop(
            model, state, loader, args.steps, tc,
            callback=lambda s, m: print(f"dense step {s}: {m}", flush=True))
        ckpt.save_expert(args.out, 0, args.steps, state)
        print(f"dense done in {time.time()-t0:.1f}s; "
              f"final loss {hist[-1]['loss']:.4f}")
        return {"dense": hist}

    # ---- decentralized: partition → independent experts -----------------
    part, loaders = partition_and_loaders(args, corpus)
    sizes = [len(s) for s in part.shards]
    print(f"partitioned {args.samples} samples into {sizes} "
          f"(balanced k-means, {part.clustering.n_iter} iters)")
    ckpt.save_router(args.out, part.clustering.centroids,
                     part.router.config.temperature,
                     part.router.config.top_k)

    summary = []
    for k in range(args.experts):
        # each expert: its own seed, its own data, its own optimizer — and
        # NO communication with the others
        state = init_train_state(model, expert_generator(args, k, device),
                                 opt)
        t0 = time.time()
        state, hist = train_host_loop(
            model, state, loaders[k], args.steps, tc,
            callback=lambda s, m, k=k: print(f"expert {k} step {s}: {m}",
                                             flush=True))
        path = ckpt.save_expert(args.out, k, args.steps, state)
        del state                    # freed before the next expert is built
        if device.type == "cuda":
            torch.cuda.empty_cache()
        summary.append({"expert": k, "shard_size": sizes[k],
                        "final_loss": hist[-1]["loss"],
                        "wall_s": round(time.time() - t0, 1),
                        "checkpoint": path})
        print(f"expert {k} done: {summary[-1]}", flush=True)

    report = {"args": vars(args), "experts": summary}
    with open(os.path.join(args.out, "train_summary.json"), "w") as f:
        json.dump(report, f, indent=1)
    print("decentralized training complete →", args.out)
    return report


if __name__ == "__main__":
    main()
