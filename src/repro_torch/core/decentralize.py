"""Decentralization of the generating velocity (port of
``repro.core.decentralize``; paper §4.3, Eq. 25–27).

Split the target distribution into disjoint clusters ``S_k``; the global
marginal velocity then decomposes exactly as

    u_t^i(a, z) = Σ_k  r_k(z, t) · u_t^{i,(k)}(a, z)

where ``u^{(k)}`` is the velocity of the path built from the
cluster-conditional target ``q(·|S_k)`` (what expert k trains on, alone)
and the exact router is the posterior ``r_k(z, t) = p_t(z|S_k) p(S_k) /
p_t(z)``. The first half computes all three exactly on ``[d]^N`` in
float64 torch on the device of ``q``, so the theorem is checkable to
machine precision; the second is the serving-time form, the
router-weighted mixture of expert next-token distributions, and the
router's top-k filter (``core.router``'s).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .autoregressive import _revealed, ar_marginal_velocity
from .dfm import n_states
from .router import topk_filter_renorm  # noqa: F401  (the reference's surface)

Tensor = torch.Tensor


@dataclass
class ClusterSplit:
    """A partition of the target support into K disjoint clusters:
    ``assignment[x1] = k`` for every state with q(x1) > 0 (arbitrary
    where q = 0)."""

    q: Tensor                # (S,) global target
    assignment: np.ndarray   # (S,) int cluster ids
    K: int

    def _of(self, k: int) -> Tensor:
        return torch.as_tensor(self.assignment == k, device=self.q.device)

    def prior(self) -> Tensor:
        """p(S_k) = Σ_{x1 ∈ S_k} q(x1), shape (K,)."""
        return torch.stack([self.q[self._of(k)].sum() for k in range(self.K)])

    def cluster_target(self, k: int) -> Tensor:
        """q(·|S_k): the distribution expert k is trained on."""
        q = self.q.masked_fill(~self._of(k), 0.0)
        tot = q.sum()
        return q / tot if tot.item() > 0 else q


def expert_velocities(split: ClusterSplit, P: int, t: int, d: int, N: int,
                      mask_id: int) -> Tensor:
    """u^{(k)} of every cluster, shape (K, N, d, S): the marginal velocity
    of the AR path whose target is q(·|S_k), what expert k's model
    represents after training on its own data alone."""
    return torch.stack([
        ar_marginal_velocity(split.cluster_target(k), P, t, d, N, mask_id)
        for k in range(split.K)])


def router_weights(split: ClusterSplit, P: int, t: int, d: int, N: int,
                   mask_id: int) -> Tensor:
    """Exact router ``r_k(z,t) = p_t(z|S_k) p(S_k) / p_t(z)``, shape (K,
    S). Under the AR path p_t(z|S_k) p(S_k) is the cluster's mass on the
    prefix z; states with p_t(z) = 0 (never visited) get uniform
    weights."""
    q = split.q
    S = n_states(d, N)
    supp = q > 0
    xt = torch.as_tensor(_revealed(P + t, d, N, mask_id), device=q.device)
    k = torch.as_tensor(split.assignment.astype(np.int64), device=q.device)
    pz_k = torch.zeros((split.K, S), dtype=q.dtype, device=q.device)
    pz_k.index_put_((k[supp], xt[supp]), q[supp], accumulate=True)
    pz = pz_k.sum(dim=0)
    r = pz_k / torch.where(pz > 0, pz, torch.ones_like(pz))[None, :]
    r[:, pz == 0] = 1.0 / split.K
    return r


def global_velocity_from_experts(expert_u: Tensor, router: Tensor) -> Tensor:
    """Eq. 27 recomposition ``u(a,z) = Σ_k r_k(z) u^{(k)}(a,z)``.
    expert_u: (K, N, d, S); router: (K, S) → (N, d, S)."""
    return torch.einsum("knds,ks->nds", expert_u, router)


def decomposition_residual(split: ClusterSplit, P: int, t: int, d: int,
                           N: int, mask_id: int) -> Tensor:
    """‖u_global − Σ_k r_k u^{(k)}‖_∞ over the reachable states (the
    others are convention-dependent): the quantity the paper proves is
    exactly zero. A 0-dim tensor."""
    q = split.q
    u_global = ar_marginal_velocity(q, P, t, d, N, mask_id)
    recomposed = global_velocity_from_experts(
        expert_velocities(split, P, t, d, N, mask_id),
        router_weights(split, P, t, d, N, mask_id))
    xt = torch.as_tensor(_revealed(P + t, d, N, mask_id), device=q.device)
    reachable = torch.unique(xt[q > 0])
    return (u_global - recomposed)[:, :, reachable].abs().max()


# ---------------------------------------------------------------------------
# Production form: mixture of expert next-token distributions
# ---------------------------------------------------------------------------

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
