"""The production form of the paper's recomposition (port of the last
section of ``repro.core.decentralize``): the serving-time mixture of expert
next-token distributions. The theory half of the reference module (cluster
splits, velocities, the decomposition residual) is not ported yet, and
``topk_filter_renorm`` lives in ``core.router`` (see ROADMAP.md)."""
from __future__ import annotations

import torch

Tensor = torch.Tensor


def mix_expert_distributions(expert_probs: Tensor, weights: Tensor) -> Tensor:
    """Serving-time recomposition (``decentralize.py:118``). The velocity is
    affine in the next-token conditional (u = cond − onehot(mask)) and the
    router weights sum to 1, so mixing velocities is mixing conditionals:
    Σ_k r_k (c_k − δ_m) = (Σ_k r_k c_k) − δ_m.

    expert_probs: (K, ..., d); weights: (K, ...) broadcastable → (..., d).
    """
    w = weights[..., None] if weights.dim() == expert_probs.dim() - 1 \
        else weights
    return (expert_probs * w).sum(dim=0)
