"""Quickstart on the port: the paper's pipeline end to end in about a
minute on the CPU (twin of ``examples/quickstart.py``).

1. Verify the decentralization theorem numerically (§4.3, exact, float64).
2. Partition a synthetic multimodal corpus with balanced spherical k-means.
3. Train K=2 tiny experts independently and a compute-matched dense
   baseline.
4. Serve with the centroid router and compare ensemble vs dense NLL.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Runs on the card unless ``--device cpu``; ``--steps`` sets each model's
training steps (the reference's 60 by default).
"""
from __future__ import annotations

import argparse
from typing import Dict

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core.decentralize import ClusterSplit, decomposition_residual
from repro_torch.core.dfm import enumerate_states, n_states
from repro_torch.core.router import RouterConfig
from repro_torch.data.partition import partition_dataset
from repro_torch.data.pipeline import LoaderConfig, ShardLoader
from repro_torch.data.synthetic import SyntheticConfig, SyntheticMultimodal
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.serve.api import SamplingParams
from repro_torch.serve.ensemble_engine import DecentralizedServer
from repro_torch.train.trainer import (TrainConfig, init_train_state,
                                       train_host_loop)

STEPS = 60


def step1_theorem(device, log=print) -> float:
    """The largest residual ‖u_global − Σ_k r_k u_k‖∞ over the positions."""
    log("== 1. Decentralization theorem (exact, on [d]^N) ==")
    d, N, K, mask = 3, 3, 2, 2
    rng = np.random.default_rng(0)
    states = enumerate_states(d, N)
    q = rng.random(n_states(d, N))
    q[(states == mask).any(1)] = 0.0
    q /= q.sum()
    split = ClusterSplit(q=torch.as_tensor(q, device=device),
                         assignment=rng.integers(0, K, q.shape[0]), K=K)
    worst = 0.0
    for t in range(N):
        res = float(decomposition_residual(split, 0, t, d, N, mask))
        log(f"  t={t}: ‖u_global − Σ_k r_k u_k‖∞ = {res:.2e}")
        if not res < 1e-12:
            raise AssertionError(f"decomposition residual {res:.2e} at t={t}")
        worst = max(worst, res)
    log("  ✓ global velocity == router-weighted expert velocities\n")
    return worst


def step2_to_4(device, steps: int = STEPS, log=print) -> Dict[str, object]:
    log("== 2. Partition a clustered multimodal corpus ==")
    corpus = SyntheticMultimodal(SyntheticConfig(
        vocab=64, seq_len=32, n_samples=512, n_latent=2, seed=0))
    part = partition_dataset(corpus.all_features(), 2,
                             router_config=RouterConfig(top_k=1))
    log(f"  shards: {[len(s) for s in part.shards]} (balanced)\n")

    log("== 3. Train 2 independent experts + dense baseline ==")
    cfg = get_smoke_config("qwen3_8b").reduced(vocab=64)
    model = build_model(cfg)
    opt = AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=steps)
    tc = TrainConfig(opt=opt)

    def train(subset, batch, seed, offset=0):
        state = init_train_state(
            model, torch.Generator(device=device).manual_seed(seed), opt)
        loader = ShardLoader(corpus, LoaderConfig(batch_size=batch),
                             subset=subset, offset=offset)
        state, hist = train_host_loop(model, state, loader, steps, tc,
                                      log_every=max(steps // 2, 1))
        return state["params"], hist[-1]["loss"]

    dense_params, dense_loss = train(None, 8, 0)
    log(f"  dense final loss     : {dense_loss:.3f}")
    experts, losses = [], []
    for k in range(2):
        p, loss = train(part.shards[k], 4, 100 + k, offset=10_000 * k)
        experts.append(p)
        losses.append(loss)
        log(f"  expert {k} final loss  : {loss:.3f} (trained in isolation)")

    log("\n== 4. Serve: routed ensemble vs dense ==")
    server = DecentralizedServer(model, experts, part.router.to(device),
                                 cache_len=40)
    batch_np = corpus.sample_batch(32, step=777)
    batch = {k: torch.as_tensor(v, device=device)
             for k, v in batch_np.items()
             if k in ("tokens", "labels", "features")}
    with torch.no_grad():
        ens_nll = float(server.ensemble_eval_nll(batch))
        logits = model.forward(dense_params, {k: batch[k]
                                              for k in ("tokens", "labels")})
    logp = torch.log_softmax(logits.float(), -1)
    d_nll = float(-logp[:, :-1].gather(
        -1, batch["labels"][:, 1:, None].long()).mean())
    log(f"  dense NLL    = {d_nll:.3f}")
    log(f"  ensemble NLL = {ens_nll:.3f}  (top-1 routed, compute-matched)")
    # SamplingParams is the same object the slot engines consume — the
    # seed derives the sampling key (temperature > 0 → stochastic)
    toks = server.generate_top1(batch, SamplingParams(max_new=8,
                                                      temperature=1.0,
                                                      seed=1))
    log(f"  sample generation: {toks[0].tolist()}")
    return {"shards": [len(s) for s in part.shards],
            "dense_loss": dense_loss, "expert_losses": losses,
            "dense_nll": d_nll, "ensemble_nll": ens_nll, "tokens": toks}


def run(device="cuda", steps: int = STEPS, log=print) -> Dict[str, object]:
    dev = resolve_device(device)
    out = {"residual": step1_theorem(dev, log)}
    out.update(step2_to_4(dev, steps, log))
    log("\nquickstart complete ✓")
    return out


def main(argv=None) -> Dict[str, object]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default) or 'cpu'")
    ap.add_argument("--steps", type=int, default=STEPS,
                    help="training steps of each model")
    args = ap.parse_args(argv)
    return run(args.device, args.steps)


if __name__ == "__main__":
    main()
