"""Shared building blocks (port of ``repro.models.layers``): norms, RoPE,
SwiGLU, embeddings, the training loss. Numerics follow the reference: norms and RoPE in
float32, projections in the working dtype, logits upcast to float32."""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from .params import ParamSpec

Tensor = torch.Tensor


def rms_norm(x: Tensor, scale: Tensor, eps: float = 1e-5) -> Tensor:
    dtype = x.dtype
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * scale.float()).to(dtype)


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
    dt = x.dtype
    gate = F.silu(x @ params["w_gate"].to(dt))
    up = x @ params["w_up"].to(dt)
    return (gate * up) @ params["w_down"].to(dt)


def embedding_specs(vocab: int, d_model: int, tie: bool) -> Dict[str, ParamSpec]:
    specs = {"embedding": ParamSpec((vocab, d_model), ("vocab", "embed"))}
    if not tie:
        specs["unembed"] = ParamSpec((d_model, vocab), ("embed", "vocab"),
                                     "scaled")
    return specs


def embed(params: Dict[str, Tensor], tokens: Tensor, dtype) -> Tensor:
    return params["embedding"][tokens].to(dtype)


def unembed(params: Dict[str, Tensor], x: Tensor, tie: bool,
            true_vocab: int = 0) -> Tensor:
    w = params["embedding"].T if tie else params["unembed"]
    # the product in the working dtype, then float32 for a stable softmax
    logits = (x @ w.to(x.dtype)).float()
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
