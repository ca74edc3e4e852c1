"""Synthetic clustered multimodal data (the empirical substrate) — the
port's own copy of ``repro.data.synthetic`` (numpy only, same numbers
from the same seed).

The paper's experiments need (image, text) pairs whose *visual* features
carry latent cluster structure and whose *text* distribution depends on the
cluster (so independent experts specialize and the ensemble's parity with a
dense model is measurable). Offline we synthesize exactly that:

* features: unit-norm Gaussian mixture with ``n_latent`` components (the
  stand-in for frozen CLIP embeddings — the allowed frontend stub);
* tokens: per-cluster first-order Markov chains over a shared vocab, with a
  cluster-specific transition matrix (mixture of a shared base chain and a
  cluster chain) — giving a measurable per-cluster NLL gap.

Everything is deterministic in the seed and generated lazily per batch.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np


@dataclass(frozen=True)
class SyntheticConfig:
    vocab: int = 512
    seq_len: int = 64
    feature_dim: int = 32
    n_latent: int = 4            # ground-truth clusters
    cluster_sep: float = 4.0     # mixture separation in feature space
    mix: float = 0.75            # weight of the cluster-specific chain
    n_samples: int = 4_096
    seed: int = 0


class SyntheticMultimodal:
    """Deterministic synthetic corpus with latent cluster structure."""

    def __init__(self, cfg: SyntheticConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        K, V, D = cfg.n_latent, cfg.vocab, cfg.feature_dim
        self.centroids = rng.normal(size=(K, D)) * cfg.cluster_sep
        base = rng.dirichlet(np.ones(V) * 0.5, size=V)        # shared chain
        self.trans = np.empty((K, V, V))
        for k in range(K):
            spec = rng.dirichlet(np.ones(V) * 0.05, size=V)   # peaky per-k
            self.trans[k] = (1 - cfg.mix) * base + cfg.mix * spec
        self.init_probs = rng.dirichlet(np.ones(V), size=K)
        self.labels = rng.integers(0, K, size=cfg.n_samples)

    def features(self, idx: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        f = self.centroids[self.labels[idx]] + \
            rng.normal(size=(len(idx), self.cfg.feature_dim))
        return f / np.linalg.norm(f, axis=1, keepdims=True)

    def tokens(self, idx: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        cfg = self.cfg
        out = np.empty((len(idx), cfg.seq_len), dtype=np.int64)
        for row, i in enumerate(idx):
            k = self.labels[i]
            t = rng.choice(cfg.vocab, p=self.init_probs[k])
            out[row, 0] = t
            cum = self.trans[k].cumsum(axis=1)
            u = rng.random(cfg.seq_len - 1)
            for s in range(1, cfg.seq_len):
                t = int(np.searchsorted(cum[t], u[s - 1]))
                out[row, s] = t
        return out

    def sample_batch(self, batch: int, step: int,
                     subset: Optional[np.ndarray] = None) -> Dict[str, np.ndarray]:
        """Batch ``step`` from the (optionally partitioned) corpus."""
        rng = np.random.default_rng((self.cfg.seed, step))
        pool = subset if subset is not None else np.arange(self.cfg.n_samples)
        idx = pool[rng.integers(0, len(pool), size=batch)]
        toks = self.tokens(idx, rng)
        return {
            "tokens": toks.astype(np.int32),
            "labels": toks.astype(np.int32),
            "features": self.features(idx, rng).astype(np.float32),
            "cluster": self.labels[idx].astype(np.int32),
        }

    def all_features(self) -> np.ndarray:
        """Features of every unique sample — partitioning input (§5.1)."""
        rng = np.random.default_rng((self.cfg.seed, 0x7FFFFFFF))
        return self.features(np.arange(self.cfg.n_samples), rng)

    def oracle_nll(self, tokens: np.ndarray, k: int) -> float:
        """Exact NLL of sequences under cluster k's chain (eval oracle)."""
        nll = -np.log(self.init_probs[k][tokens[:, 0]] + 1e-12)
        for s in range(1, tokens.shape[1]):
            nll += -np.log(self.trans[k][tokens[:, s - 1], tokens[:, s]] + 1e-12)
        return float(nll.mean() / tokens.shape[1])
