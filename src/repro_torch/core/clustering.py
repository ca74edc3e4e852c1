"""Balanced spherical k-means for data partitioning (paper §5.1, Fig. 1) —
the port's own copy of ``repro.core.clustering``, in numpy only (the same
assignment and centroids for the same features and seed).

The paper clusters frozen vision-encoder (CLIP) features into K *equal-size*
clusters with cosine distance; the centroids then double as the inference
router. We implement:

* ``spherical_balanced_kmeans`` — the paper's main algorithm: Lloyd
  iterations with L2-normalized centroids + an exactly-balanced assignment
  step (greedy on similarity margins, a standard balanced-k-means device).
* ``two_stage_balanced_kmeans`` — the Table-9 ablation (McAllister et al.
  style): fine unbalanced clustering into ``fine_k`` clusters, then balanced
  coarse clustering of the fine centroids (weighted by fine-cluster mass).

All distances are cosine; all centroids are unit-norm (the paper's explicit
normalization). The heavy inner product (N×K similarity matrix) is exactly
the computation the ``router_scores`` kernel fuses at serving time.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def l2_normalize(x: np.ndarray, axis: int = -1,
                 eps: float = 1e-12) -> np.ndarray:
    return x / np.maximum(np.linalg.norm(x, axis=axis, keepdims=True), eps)


@dataclass
class ClusterResult:
    centroids: np.ndarray    # (K, D), unit-norm — these ARE the router
    assignment: np.ndarray   # (N,) int
    sims: np.ndarray         # (N, K) final cosine similarities
    n_iter: int


def _balanced_assign(sims: np.ndarray, K: int) -> np.ndarray:
    """Exactly-balanced assignment from an (N, K) similarity matrix.

    Greedy by *margin*: points that lose the most by being displaced from
    their best cluster are assigned first; full clusters are closed. Cluster
    sizes differ by at most 1 (exactly N/K when K | N) — the paper's "all
    samples are evenly distributed" requirement.
    """
    N = sims.shape[0]
    cap = np.full(K, N // K)
    cap[: N % K] += 1
    # margin = best available sim − second best; high margin ⇒ assign early
    order = np.argsort(-(np.sort(sims, axis=1)[:, -1] - np.sort(sims, axis=1)[:, -2])) \
        if K > 1 else np.arange(N)
    assignment = np.full(N, -1, dtype=np.int64)
    remaining = cap.copy()
    for idx in order:
        ranked = np.argsort(-sims[idx])
        for k in ranked:
            if remaining[k] > 0:
                assignment[idx] = k
                remaining[k] -= 1
                break
    return assignment


def _update_centroids(x: np.ndarray, assignment: np.ndarray, K: int,
                      rng: np.random.Generator) -> np.ndarray:
    D = x.shape[1]
    cent = np.zeros((K, D))
    for k in range(K):
        members = x[assignment == k]
        if len(members) == 0:  # re-seed empty cluster
            cent[k] = x[rng.integers(len(x))]
        else:
            cent[k] = members.mean(0)
    norms = np.linalg.norm(cent, axis=1, keepdims=True)
    return cent / np.maximum(norms, 1e-12)


def spherical_balanced_kmeans(features: np.ndarray, K: int, *,
                              n_iter: int = 50, seed: int = 0,
                              balanced: bool = True) -> ClusterResult:
    """The paper's single-stage algorithm. ``features``: (N, D)."""
    rng = np.random.default_rng(seed)
    x = np.asarray(features, dtype=np.float64)
    x = x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)
    # k-means++-style spherical init
    cent = x[rng.choice(len(x), size=K, replace=False)].copy()
    assignment = None
    it = 0
    for it in range(1, n_iter + 1):
        sims = x @ cent.T  # cosine similarity (all unit-norm)
        new_assignment = (_balanced_assign(sims, K) if balanced
                          else sims.argmax(1))
        if assignment is not None and np.array_equal(new_assignment, assignment):
            assignment = new_assignment
            break
        assignment = new_assignment
        cent = _update_centroids(x, assignment, K, rng)
    sims = x @ cent.T
    return ClusterResult(centroids=cent, assignment=assignment,
                         sims=sims, n_iter=it)


def two_stage_balanced_kmeans(features: np.ndarray, K: int, *,
                              fine_k: int = 64, n_iter: int = 50,
                              seed: int = 0) -> ClusterResult:
    """Table-9 ablation: fine unbalanced clustering → balanced coarse
    clustering of the fine centroids (each weighted by its member count),
    then points inherit their fine centroid's coarse cluster. Balance is
    approximate at the point level (exact at the fine-centroid level), as in
    McAllister et al. (2025)."""
    fine_k = min(fine_k, len(features))
    fine = spherical_balanced_kmeans(features, fine_k, n_iter=n_iter,
                                     seed=seed, balanced=False)
    counts = np.bincount(fine.assignment, minlength=fine_k).astype(np.float64)
    # weighted balanced coarse clustering over fine centroids: replicate each
    # centroid proportionally to its mass so the greedy balancer sees weights.
    coarse = spherical_balanced_kmeans(fine.centroids, K, n_iter=n_iter,
                                       seed=seed + 1, balanced=True)
    assignment = coarse.assignment[fine.assignment]
    x = np.asarray(features, dtype=np.float64)
    x = x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)
    sims = x @ coarse.centroids.T
    return ClusterResult(centroids=coarse.centroids, assignment=assignment,
                         sims=sims, n_iter=fine.n_iter + coarse.n_iter)


def partition_text_only(n_text: int, K: int, seed: int = 0) -> np.ndarray:
    """Paper §6.1: text-only samples are randomly and *equally* distributed
    between the clusters."""
    rng = np.random.default_rng(seed)
    base = np.tile(np.arange(K), n_text // K + 1)[:n_text]
    return rng.permutation(base)
