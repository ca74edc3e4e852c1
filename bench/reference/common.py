"""Plain PyTorch pieces of the benchmark's reference decoders.

Everything here is written from the published descriptions (RMSNorm, RoPE
with the half-split rotation, grouped-query causal attention, SwiGLU,
next-token cross-entropy, AdamW) in float32 with TF32 off. It imports
nothing of the program under test and nothing of JAX.

``Prec`` is the arithmetic of every weight product: ``"fp32"`` is the
reference; ``"fp8"`` is the control, the step below bf16 that a later
change could be tempted to take: fp8 training's products (operands in
e4m3, the gradient flowing back in e5m2, one scale a tensor), multiplied
in float32.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterator, List

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def fp8_round(t: Tensor, fmt=torch.float8_e4m3fn) -> Tensor:
    """``t`` rounded to a float8 format under one per-tensor scale (the
    largest magnitude maps to the format's largest value), in float32."""
    top = torch.finfo(fmt).max
    scale = t.abs().amax().clamp_min(1e-30) / top
    return (t / scale).to(fmt).to(torch.float32) * scale


class Fp8Product(torch.autograd.Function):
    """a (M, K) @ b (K, N) as fp8 training computes it: both operands in
    e4m3 for the forward, and the incoming gradient in e5m2 for the two
    backward products, each under one per-tensor scale, multiplied in
    float32."""

    @staticmethod
    def forward(ctx, a, b):
        aq, bq = fp8_round(a), fp8_round(b)
        ctx.save_for_backward(aq, bq)
        return aq @ bq

    @staticmethod
    def backward(ctx, g):
        aq, bq = ctx.saved_tensors
        gq = fp8_round(g, torch.float8_e5m2)
        return gq @ bq.T, aq.T @ gq


class Prec:
    def __init__(self, name: str = "fp32"):
        if name not in ("fp32", "fp8"):
            raise ValueError(f"unknown reference precision {name!r}")
        self.name = name

    def mm(self, a: Tensor, b: Tensor) -> Tensor:
        """a (M, K) @ b (K, N) in float32 (in fp8 under the control)."""
        if self.name == "fp8":
            return Fp8Product.apply(a, b)
        return a @ b


@contextlib.contextmanager
def exact_float32() -> Iterator[None]:
    """TF32 off for every float32 product inside, restored after."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32,
           torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old[0]
        torch.backends.cudnn.allow_tf32 = old[1]
        torch.set_float32_matmul_precision(old[2])


def rms_norm(x: Tensor, scale: Tensor, eps: float) -> Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def rope(x: Tensor, positions: Tensor, theta: float) -> Tensor:
    """x (S, H, dh), positions (S,): rotate the two halves of each head
    (the "rotate_half" form of Qwen3's reference code)."""
    half = x.shape[-1] // 2
    inv = 1.0 / theta ** (torch.arange(half, dtype=torch.float32,
                                       device=x.device) / half)
    ang = positions.float()[:, None] * inv                  # (S, half)
    cos, sin = ang.cos()[:, None, :], ang.sin()[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)


def causal_attention(q: Tensor, k: Tensor, v: Tensor, q_pos: Tensor,
                     block: int = 1024) -> Tensor:
    """q (Sq, H, dh) at absolute positions ``q_pos``; k, v (Sk, KV, dh) at
    positions 0..Sk-1. Query rows in blocks of ``block`` so that the
    (H, block, Sk) scores stay small."""
    Sq, H, dh = q.shape
    Sk, KV, _ = k.shape
    g = H // KV
    kh = k.permute(1, 0, 2).repeat_interleave(g, 0)         # (H, Sk, dh)
    vh = v.permute(1, 0, 2).repeat_interleave(g, 0)
    keys = torch.arange(Sk, device=q.device)
    outs = []
    for lo in range(0, Sq, block):
        qb = q[lo:lo + block].permute(1, 0, 2)               # (H, b, dh)
        s = qb @ kh.transpose(1, 2) / math.sqrt(dh)          # (H, b, Sk)
        live = keys[None, :] <= q_pos[lo:lo + block, None]
        s = s.masked_fill(~live[None], float("-inf"))
        outs.append((torch.softmax(s, -1) @ vh).permute(1, 0, 2))
    return torch.cat(outs, 0)


def swiglu(prec: Prec, x: Tensor, w_gate: Tensor, w_up: Tensor,
           w_down: Tensor) -> Tensor:
    return prec.mm(F.silu(prec.mm(x, w_gate)) * prec.mm(x, w_up), w_down)


def attention_block(prec: Prec, p: Dict[str, Tensor], h: Tensor,
                    pos: Tensor, cfg: dict) -> Tensor:
    """Self-attention of the normed rows h (S, D) at positions ``pos``;
    p holds wq (D, H, dh), wk, wv (D, KV, dh), wo (H, dh, D) and, where
    the model has them, q_norm and k_norm (dh,)."""
    S, D = h.shape
    H, KV = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    dh = head_dim(cfg)
    eps = cfg["rms_norm_eps"]
    q = prec.mm(h, p["wq"].reshape(D, H * dh)).reshape(S, H, dh)
    k = prec.mm(h, p["wk"].reshape(D, KV * dh)).reshape(S, KV, dh)
    v = prec.mm(h, p["wv"].reshape(D, KV * dh)).reshape(S, KV, dh)
    if "q_norm" in p:
        q = rms_norm(q, p["q_norm"], eps)
        k = rms_norm(k, p["k_norm"], eps)
    q = rope(q, pos, cfg["rope_theta"])
    k = rope(k, pos, cfg["rope_theta"])
    o = causal_attention(q, k, v, pos)
    return prec.mm(o.reshape(S, H * dh), p["wo"].reshape(H * dh, D))


def head_dim(cfg: dict) -> int:
    return cfg.get("head_dim") or cfg["hidden_size"] // \
        cfg["num_attention_heads"]


def nll(logits: Tensor, targets: Tensor) -> Tensor:
    """Per-row next-token NLL, logits (N, V) float32."""
    return torch.logsumexp(logits, -1) - logits.gather(
        -1, targets[:, None]).squeeze(-1)


def leaves(tree, prefix: str = "") -> List:
    """(path, tensor) of a nested dict, keys sorted, paths joined by '.'."""
    out = []
    for k in sorted(tree):
        path = f"{prefix}.{k}" if prefix else k
        if isinstance(tree[k], dict):
            out += leaves(tree[k], path)
        else:
            out.append((path, tree[k]))
    return out
