"""Flash attention forward (CUDA, ``csrc/flash_attention.cu``) beside its
plain PyTorch version — port of ``repro/kernels/flash_attention.py``.

* ``flash_attention_with_lse`` — port of the Pallas kernel of the same
  name (``flash_attention.py:83``): full-sequence grouped-query
  self-attention, causal and/or windowed, returning the output and the
  per-row log-sum-exp (the residual a backward pass needs). It counts its
  launches in ``flash_attention_with_lse.launches``.
* ``flash_attention`` — the same, output only.

The plain versions (after ``repro/kernels/ref.py:18``) take one softmax
over the masked score matrix, with the weights rounded to q's dtype
before the product with V (``models.attention.gqa_sdpa``); the kernel
keeps them in float32, so the two differ by about one ulp of the working
dtype. ``kernels.ops`` picks kernel or plain version by the
tensors' device.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from . import build
from .decode_attention import check_operands, check_tensor_core_shape

Tensor = torch.Tensor


def flash_attention_with_lse(q: Tensor, k: Tensor, v: Tensor, *,
                             causal: bool = True,
                             window: int = 0) -> Tuple[Tensor, Tensor]:
    """CUDA kernel. q: (B,S,H,dh); k,v: (B,S,KV,dh) with H % KV == 0 →
    (out (B,S,H,dh) in q.dtype, lse (B,S,H) float32). Row i sees key j iff
    j ≤ i (causal) and i − j < window (window > 0, with causal only). Any
    S."""
    code = check_operands(q, k, v, (), "flash_attention_with_lse")
    B, S, H, dh = q.shape
    KV = k.shape[2]
    if H % KV or k.shape != (B, S, KV, dh):
        raise ValueError(
            f"flash_attention_with_lse: shapes q {tuple(q.shape)}, k/v "
            f"{tuple(k.shape)} do not agree")
    if q.dtype == torch.bfloat16:
        check_tensor_core_shape("flash_attention_with_lse", q, k, v)
    out = torch.empty_like(q)
    lse = torch.empty((B, S, H), dtype=torch.float32, device=q.device)
    lib = build.load("flash_attention")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = lib.flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), code, B, S, H, KV, dh, int(causal), int(window),
            1.0 / math.sqrt(dh), stream)
    build.check(lib, err, "flash_attention_with_lse")
    flash_attention_with_lse.launches += 1
    return out, lse


flash_attention_with_lse.launches = 0


def flash_attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True,
                    window: int = 0) -> Tensor:
    """CUDA kernel, output only (see ``flash_attention_with_lse``)."""
    return flash_attention_with_lse(q, k, v, causal=causal,
                                    window=window)[0]


def flash_attention_ref(q: Tensor, k: Tensor, v: Tensor, *,
                        causal: bool = True, window: int = 0) -> Tensor:
    """Plain version: ``gqa_sdpa`` under ``causal_mask`` — the reference
    model's attention without the kernel."""
    from repro_torch.models.attention import causal_mask, gqa_sdpa
    mask = causal_mask(q.shape[1], window, device=q.device) if causal \
        else None
    return gqa_sdpa(q, k, v, mask)


def flash_attention_with_lse_ref(q: Tensor, k: Tensor, v: Tensor, *,
                                 causal: bool = True,
                                 window: int = 0) -> Tuple[Tensor, Tensor]:
    """Plain version with the log-sum-exp of each row's masked, scaled
    scores."""
    from repro_torch.models.attention import NEG_INF, causal_mask
    B, S, H, dh = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, S, KV, H // KV, dh)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg, k).float() / math.sqrt(dh)
    if causal:
        mask = causal_mask(S, window, device=q.device)
        logits = logits.masked_fill(~mask[:, None, None], NEG_INF)
    lse = torch.logsumexp(logits, dim=-1)                   # (B,KV,g,S)
    out = flash_attention_ref(q, k, v, causal=causal, window=window)
    return out, lse.permute(0, 3, 1, 2).reshape(B, S, H)
