"""Shared building blocks (port of ``repro.models.layers``): norms, RoPE,
SwiGLU, embeddings, the training loss. Numerics follow the reference: norms and RoPE in
float32, projections in the working dtype, logits upcast to float32.

Every function also takes a stack of K experts' parameters
(``core.ensemble.stack_experts_for_decode``): each leaf then carries a
leading K dim, and the activations carry K folded into their batch, rows
expert-major (expert k's B rows are rows k·B .. k·B + B − 1). A weight
product is then one batched product over K (``expert_matmul``) and a
per-channel parameter pairs expert k's values with expert k's rows
(``per_expert``): the reference's ``jax.vmap`` over the expert dim,
written out. One model's parameters take the unchanged single-model
arithmetic."""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from .params import ParamSpec

Tensor = torch.Tensor


def expert_matmul(x: Tensor, w: Tensor) -> Tensor:
    """x (K·N, ..., D), rows expert-major, times an expert stack w (K, D,
    *out) → (K·N, ..., *out) in x's dtype: one batched product over K."""
    K, D = w.shape[:2]
    y = torch.bmm(x.reshape(K, -1, D), w.reshape(K, D, -1).to(x.dtype))
    return y.reshape(*x.shape[:-1], *w.shape[2:])


def linear(x: Tensor, w: Tensor) -> Tensor:
    """x (..., D) @ w (D, F) in x's dtype, or an expert stack w (K, D, F)
    over expert-major rows (``expert_matmul``)."""
    if w.dim() == 2:
        return x @ w.to(x.dtype)
    return expert_matmul(x, w)


def per_expert(op, x: Tensor, p: Tensor, base: int = 1) -> Tensor:
    """``op(x, p)`` with p (of ``base`` dims) broadcast over x's trailing
    dims; an expert stack p (K, *base dims) pairs expert k's values with
    its rows of x (K·N, ...), expert-major."""
    if p.dim() == base:
        return op(x, p)
    K = p.shape[0]
    xv = x.reshape(K, -1, *x.shape[1:])
    pv = p.reshape(K, *(1,) * (x.dim() - base), *p.shape[1:])
    return op(xv, pv).reshape(x.shape)


def rms_norm(x: Tensor, scale: Tensor, eps: float = 1e-5) -> Tensor:
    dtype = x.dtype
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return per_expert(torch.mul, out, scale.float()).to(dtype)


def rope_freqs(head_dim: int, theta: float, device=None) -> Tensor:
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    # a Python-scalar base: a device tensor built from ``theta`` here would
    # be a host-to-device copy, which synchronizes the host with the card
    # on every call
    return 1.0 / torch.pow(theta, exps)


def apply_rope(x: Tensor, positions: Tensor, theta: float) -> Tensor:
    """x: (..., S, H, dh); positions: broadcastable to (..., S). Half-split
    (not interleaved) rotation, computed in float32."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)                 # (dh/2,)
    angles = positions[..., None].float() * freqs           # (..., S, dh/2)
    cos = torch.cos(angles)[..., None, :]                   # (..., S, 1, dh/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def swiglu_specs(d_model: int, d_ff: int) -> Dict[str, ParamSpec]:
    return {
        "w_gate": ParamSpec((d_model, d_ff), ("embed", "mlp"), "scaled"),
        "w_up": ParamSpec((d_model, d_ff), ("embed", "mlp"), "scaled"),
        "w_down": ParamSpec((d_ff, d_model), ("mlp", "embed"), "scaled"),
    }


def swiglu(params: Dict[str, Tensor], x: Tensor) -> Tensor:
    gate = F.silu(linear(x, params["w_gate"]))
    up = linear(x, params["w_up"])
    return linear(gate * up, params["w_down"])


def embedding_specs(vocab: int, d_model: int, tie: bool) -> Dict[str, ParamSpec]:
    specs = {"embedding": ParamSpec((vocab, d_model), ("vocab", "embed"))}
    if not tie:
        specs["unembed"] = ParamSpec((d_model, vocab), ("embed", "vocab"),
                                     "scaled")
    return specs


def embed(params: Dict[str, Tensor], tokens: Tensor, dtype) -> Tensor:
    """tokens (B, ...) → (B, ..., D); an expert stack embeds the same
    tokens with each expert's table, (K·B, ..., D) expert-major."""
    table = params["embedding"]
    if table.dim() == 3:
        return table[:, tokens].flatten(0, 1).to(dtype)
    return table[tokens].to(dtype)


def unembed(params: Dict[str, Tensor], x: Tensor, tie: bool,
            true_vocab: int = 0) -> Tensor:
    w = params["embedding"].transpose(-1, -2) if tie else params["unembed"]
    # the product in the working dtype, then float32 for a stable softmax
    logits = linear(x, w).float()
    V = logits.shape[-1]
    if true_vocab and true_vocab < V:      # mask padded vocab rows
        pad = torch.arange(V, device=logits.device) >= true_vocab
        logits = logits.masked_fill(pad, -1e30)
    return logits


def cross_entropy_loss(logits: Tensor, labels: Tensor,
                       mask: Optional[Tensor] = None) -> Tensor:
    """Mean next-token NLL. logits: (B, S, V) float32; labels: (B, S) int;
    mask: (B, S), the positions that count (all when None)."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, labels[..., None].long())[..., 0]
    if mask is None:
        return nll.mean()
    mask = mask.to(nll.dtype)
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)
