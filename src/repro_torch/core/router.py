"""The parameter-free centroid router (port of ``repro.core.router``; paper
§5.1–5.2, Eq. 28):

    p(S_k | x) = softmax_k( τ · cos(x, c_k) )

followed by top-k filtering and renormalization. ``cluster_probs`` goes
through ``kernels.ops.router_scores``: the fused CUDA kernel when the
features are on the card, its plain version on the CPU.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import ops as kops

Tensor = torch.Tensor


def l2_normalize(x: Tensor, dim: int = -1, eps: float = 1e-12) -> Tensor:
    """Port of ``repro.core.clustering.l2_normalize``."""
    return x / x.norm(dim=dim, keepdim=True).clamp_min(eps)


def topk_filter_renorm(weights: Tensor, k: int) -> Tensor:
    """Port of ``repro.core.decentralize.topk_filter_renorm``: keep the
    top-k weights along dim 0, renormalize, zero the rest."""
    K = weights.shape[0]
    if k >= K:
        return weights / weights.sum(dim=0, keepdim=True)
    ranks = torch.argsort(torch.argsort(-weights, dim=0, stable=True),
                          dim=0, stable=True)
    kept = weights * (ranks < k).to(weights.dtype)
    return kept / kept.sum(dim=0, keepdim=True).clamp_min(1e-30)


@dataclass(frozen=True)
class RouterConfig:
    temperature: float = 10.0
    top_k: int = 1


@dataclass
class CentroidRouter:
    """Holds the K centroids (K, D) from balanced spherical k-means."""

    centroids: Tensor
    config: RouterConfig = field(default_factory=RouterConfig)

    @property
    def K(self) -> int:
        return self.centroids.shape[0]

    def to(self, device) -> "CentroidRouter":
        return CentroidRouter(self.centroids.to(device), self.config)

    def cluster_probs(self, features: Tensor) -> Tensor:
        """Eq. 28. features: (..., D) → (..., K)."""
        flat = features.reshape(-1, features.shape[-1]).contiguous()
        out = kops.router_scores(flat, self.centroids,
                                 self.config.temperature)
        return out.reshape(features.shape[:-1] + (self.K,))

    def route(self, features: Tensor) -> Tensor:
        """Top-k filtered + renormalized weights: (..., K)."""
        probs = self.cluster_probs(features)
        filtered = topk_filter_renorm(probs.movedim(-1, 0),
                                      self.config.top_k)
        return filtered.movedim(0, -1)

    def top1(self, features: Tensor) -> Tensor:
        """Hard assignment: (...,) int64 expert ids."""
        return torch.argmax(self.cluster_probs(features), dim=-1)


def router_from_clustering(centroids: np.ndarray,
                           config: Optional[RouterConfig] = None
                           ) -> CentroidRouter:
    """The router straight from k-means output (port of
    ``repro.core.router.router_from_clustering``): no trainable
    parameters; the centroids as float32 on the CPU (``.to(device)``
    moves them)."""
    return CentroidRouter(torch.as_tensor(np.asarray(centroids),
                                          dtype=torch.float32),
                          config or RouterConfig())
