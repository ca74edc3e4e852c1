"""Flash attention backward (CUDA, ``csrc/flash_attention_bwd.cu``) beside
its plain PyTorch version — port of ``repro/kernels/flash_attention_bwd.py``.

* ``flash_attention_bwd`` — port of the Pallas kernel pair of the same name
  (``flash_attention_bwd.py:121``): dq, dk, dv of grouped-query
  self-attention from the forward's output and saved log-sum-exp
  (``flash_attention.flash_attention_with_lse``), causal and/or windowed,
  any S. Δ = rowsum(do ⊙ out) is one torch product-and-sum before the
  launch, as the reference computes it in jnp outside Pallas. The kernels
  sum dk/dv over each KV head's query group in float32. It counts its
  launches in ``flash_attention_bwd.launches``.
* ``flash_attention_bwd_ref`` — the plain version: the explicit formula
  from the saved lse, in float32.

``kernels.ops`` picks kernel or plain version by the tensors' device.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from . import build
from .decode_attention import check_operands
from .flash_attention import check_tensor_core_shape

Tensor = torch.Tensor


def _delta(out: Tensor, do: Tensor) -> Tensor:
    """Δ (B,S,H) float32 = rowsum(do ⊙ out)."""
    return (do.float() * out.float()).sum(-1)


def flash_attention_bwd(q: Tensor, k: Tensor, v: Tensor, out: Tensor,
                        lse: Tensor, do: Tensor, *, causal: bool = True,
                        window: int = 0) -> Tuple[Tensor, Tensor, Tensor]:
    """CUDA kernels. q, out, do: (B,S,H,dh); k, v: (B,S,KV,dh); lse: (B,S,H)
    float32, as ``flash_attention_with_lse`` returns it → (dq in q.dtype,
    dk, dv in k.dtype). The mask is the forward's. Any S. bf16 runs on
    the tensor cores (``flash_attention.check_tensor_core_shape``), float32
    on the scalar kernels."""
    code = check_operands(q, k, v, (), "flash_attention_bwd")
    B, S, H, dh = q.shape
    KV = k.shape[2]
    if H % KV or k.shape != (B, S, KV, dh):
        raise ValueError(
            f"flash_attention_bwd: shapes q {tuple(q.shape)}, k/v "
            f"{tuple(k.shape)} do not agree")
    for name, t in (("out", out), ("do", do)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device \
                or not t.is_contiguous():
            raise ValueError(f"flash_attention_bwd: {name} must be a "
                             f"contiguous {q.dtype} tensor of q's shape on "
                             f"{q.device}")
    if lse.shape != (B, S, H) or lse.dtype != torch.float32 \
            or lse.device != q.device or not lse.is_contiguous():
        raise ValueError("flash_attention_bwd: lse must be a contiguous "
                         f"(B,S,H) float32 tensor on {q.device}")
    if q.dtype == torch.bfloat16:
        check_tensor_core_shape("flash_attention_bwd", q, k, v, out, do)
    delta = _delta(out, do)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    lib = build.load("flash_attention_bwd")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = lib.flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), code, B, S, H, KV, dh, int(causal), int(window),
            1.0 / math.sqrt(dh), stream)
    build.check(lib, err, "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


def flash_attention_bwd_ref(q: Tensor, k: Tensor, v: Tensor, out: Tensor,
                            lse: Tensor, do: Tensor, *, causal: bool = True,
                            window: int = 0
                            ) -> Tuple[Tensor, Tensor, Tensor]:
    """Plain version, in float32: p = exp(q·kᵀ·scale − lse) on the visible
    entries (0 elsewhere), Δ = rowsum(do ⊙ out), ds = p ⊙ (do·vᵀ − Δ),
    dq = ds·k·scale, dk = dsᵀ·q·scale and dv = pᵀ·do, each summed over the
    GQA group of its KV head."""
    from repro_torch.models.attention import causal_mask
    B, S, H, dh = q.shape
    KV = k.shape[2]
    g = H // KV
    scale = 1.0 / math.sqrt(dh)
    qg = q.float().reshape(B, S, KV, g, dh)
    dog = do.float().reshape(B, S, KV, g, dh)
    kf, vf = k.float(), v.float()

    def rows(t):                        # (B,S,H) → (B,KV,g,S,1)
        return t.reshape(B, S, KV, g).permute(0, 2, 3, 1)[..., None]

    s = torch.einsum("bqkgd,bskd->bkgqs", qg, kf) * scale
    p = torch.exp(s - rows(lse.float()))
    if causal:
        p = p.masked_fill(~causal_mask(S, window, device=q.device)[:, None,
                                                                    None], 0)
    dp = torch.einsum("bqkgd,bskd->bkgqs", dog, vf)
    ds = p * (dp - rows(_delta(out, do)))
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, kf) * scale
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds, qg) * scale
    dv = torch.einsum("bkgqs,bqkgd->bskd", p, dog)
    return (dq.reshape(B, S, H, dh).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
