"""Fused centroid-router kernel (CUDA, ``csrc/router_scores.cu``) beside its
plain PyTorch version — port of ``repro/kernels/router_scores.py:34``
(paper Eq. 28: L2-normalize features and centroids, cosine similarities,
temperature softmax). The kernel runs each row on a few lanes of a warp,
one group of rows a block, over centroids staged in shared memory;
``router_plan`` fixes its launch from the shapes alone."""
from __future__ import annotations

import torch

from . import build

Tensor = torch.Tensor
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# warps a block at most, and the shared memory a block stages the
# centroids and its rows' sums in (the 48 KB a block takes without an
# opt-in)
ROUTER_MAX_WARPS = 8
ROUTER_SMEM_BYTES = 48 * 1024


def router_plan(B: int, D: int, K: int, itemsize: int,
                aligned: bool = True):
    """(warps, span, slab, vec) of the router kernel for x (B, D) and K
    centroids of ``itemsize``-byte elements: loads of ``vec`` elements (16
    bytes when D is a multiple and both operands are 16-byte aligned, else
    1); ``span`` lanes a row, the least power of two that gives each of
    D's pieces a lane, at most 32, so 32 // span rows a warp; ``warps``
    warps a block, as few as B needs up to ``ROUTER_MAX_WARPS`` (one at B =
    1), one group of rows a block; the centroids staged in slabs of
    ``slab`` columns (all of D when the K centroids fit
    ``ROUTER_SMEM_BYTES`` beside their norms and the rows' K sums, else
    the widest slab that does). Raises when not even one vector's slab
    fits."""
    wide = 16 // itemsize
    vec = wide if aligned and D % wide == 0 else 1
    pieces = -(-D // vec)
    span = min(32, 1 << (pieces - 1).bit_length())
    per_warp = 32 // span
    warps = max(1, min(ROUTER_MAX_WARPS, -(-B // per_warp)))
    free = ROUTER_SMEM_BYTES // 4 - K - warps * per_warp * K
    slab = free // K // vec * vec
    if slab < vec:
        raise ValueError(f"router_scores: {K} centroids leave no room for a "
                         f"slab of D in {ROUTER_SMEM_BYTES} bytes of shared "
                         f"memory")
    return warps, span, min(slab, pieces * vec), vec


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
    warps, span, slab, vec = router_plan(
        B, D, K, x.element_size(),
        aligned=x.data_ptr() % 16 == 0 and centroids.data_ptr() % 16 == 0)
    lib = build.load("router_scores")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.router_scores(x.data_ptr(), centroids.data_ptr(),
                                out.data_ptr(), code, B, D, K, warps, span,
                                slab, vec, float(temperature), stream)
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
