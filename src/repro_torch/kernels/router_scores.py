"""Fused centroid-router kernel (CUDA, ``csrc/router_scores.cu``) beside its
plain PyTorch version — port of ``repro/kernels/router_scores.py:34``
(paper Eq. 28: L2-normalize features and centroids, cosine similarities,
temperature softmax)."""
from __future__ import annotations

import torch

from . import build

Tensor = torch.Tensor
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def router_scores(x: Tensor, centroids: Tensor,
                  temperature: float) -> Tensor:
    """CUDA kernel. x: (B, D); centroids: (K, D) → routing probabilities
    (B, K) in x.dtype."""
    if x.device.type != "cuda":
        raise ValueError(f"router_scores: the CUDA kernel needs CUDA "
                         f"tensors, got {x.device}")
    code = _DTYPE_CODES.get(x.dtype)
    if code is None or centroids.dtype != x.dtype \
            or centroids.device != x.device:
        raise TypeError(f"router_scores: x {x.dtype} on {x.device}, "
                        f"centroids {centroids.dtype} on {centroids.device} "
                        f"(float32 or bfloat16, one device)")
    if x.dim() != 2 or centroids.dim() != 2 \
            or x.shape[1] != centroids.shape[1]:
        raise ValueError(f"router_scores: x {tuple(x.shape)} vs centroids "
                         f"{tuple(centroids.shape)}")
    if not (x.is_contiguous() and centroids.is_contiguous()):
        raise ValueError("router_scores: x and centroids must be contiguous")
    B, D = x.shape
    K = centroids.shape[0]
    out = torch.empty((B, K), dtype=x.dtype, device=x.device)
    if B == 0:
        return out
    lib = build.load("router_scores")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.router_scores(x.data_ptr(), centroids.data_ptr(),
                                out.data_ptr(), code, B, D, K,
                                float(temperature), stream)
    build.check(lib, err, "router_scores")
    router_scores.launches += 1
    return out


router_scores.launches = 0


def router_scores_ref(x: Tensor, centroids: Tensor,
                      temperature: float) -> Tensor:
    """Plain version (``repro/kernels/ref.py:99``): normalize with a 1e-12
    floor on the norm, cosine similarities, float32 τ-softmax."""
    xn = x / x.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    cn = centroids / centroids.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    sims = xn @ cn.T
    return torch.softmax(temperature * sims.float(), dim=-1).to(x.dtype)
