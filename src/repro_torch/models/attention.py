"""Grouped-query attention: full-sequence prefill, one-token decode against
contiguous cache rows, and the paged paths (port of
``repro.models.attention``; ``cross_attention``/``encode_kv`` are not
ported yet, see ROADMAP.md).

Public functions keep the reference's einsum layouts: ``wq`` (D,H,dh),
``wk``/``wv`` (D,KV,dh), ``wo`` (H,dh,D), caches (B,S,KV,dh), pools
(P,block,KV,dh). Where the reference writes new K/V functionally and
returns a new cache or pool, the port writes it IN PLACE with
``index_put_`` and returns the same tensors — caches and pools are the
serving state and are never shared with a caller that expects the old
contents. The attention itself goes through
``repro_torch.kernels.ops``: the CUDA kernel for tensors on the card, the
plain version on the CPU.

A stack of K experts' parameters (``layers``' expert-stack convention)
takes activations with K folded into the batch, expert-major, and caches,
pools, positions and block tables at that batch: each kernel then serves
all K experts in one launch.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops

from .layers import apply_rope, expert_matmul, rms_norm
from .params import ParamSpec

Tensor = torch.Tensor

NEG_INF = -1e30


def attention_specs(cfg) -> Dict[str, ParamSpec]:
    D, H, KV, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    specs = {
        "wq": ParamSpec((D, H, dh), ("embed", "heads", "head_dim"), "scaled"),
        "wk": ParamSpec((D, KV, dh), ("embed", "kv_heads", "head_dim"), "scaled"),
        "wv": ParamSpec((D, KV, dh), ("embed", "kv_heads", "head_dim"), "scaled"),
        "wo": ParamSpec((H, dh, D), ("heads", "head_dim", "embed"), "scaled"),
    }
    if cfg.qk_norm:
        specs["q_norm"] = ParamSpec((dh,), (None,), "ones")
        specs["k_norm"] = ParamSpec((dh,), (None,), "ones")
    return specs


def _project_in(x: Tensor, w: Tensor) -> Tensor:
    """x (B,S,D) through w (D,H,dh) → (B,S,H,dh); an expert stack w
    (K,D,H,dh) as one batched product over K."""
    if w.dim() == 3:
        return torch.einsum("bsd,dhk->bshk", x, w.to(x.dtype))
    return expert_matmul(x, w)


def _qkv(params, x: Tensor, cfg, positions: Tensor,
         rope: bool = True) -> Tuple[Tensor, Tensor, Tensor]:
    q = _project_in(x, params["wq"])
    k = _project_in(x, params["wk"])
    v = _project_in(x, params["wv"])
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"], cfg.norm_eps)
        k = rms_norm(k, params["k_norm"], cfg.norm_eps)
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def gqa_sdpa(q: Tensor, k: Tensor, v: Tensor, mask: Optional[Tensor],
             softmax_dtype=torch.float32) -> Tensor:
    """Grouped-query attention without materializing repeated KV heads.
    q: (B,Sq,H,dh); k,v: (B,Sk,KV,dh), H % KV == 0; mask broadcastable to
    (B,Sq,Sk) or None. Head h uses KV head h // (H/KV)."""
    B, Sq, H, dh = q.shape
    KV = k.shape[2]
    g = H // KV
    qg = q.reshape(B, Sq, KV, g, dh)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg, k).to(softmax_dtype)
    logits = logits / math.sqrt(dh)
    if mask is not None:
        logits = logits.masked_fill(~mask[:, None, None, :, :], NEG_INF)
    weights = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", weights, v)
    return out.reshape(B, Sq, H, dh)


def _project_out(params, out: Tensor, dt) -> Tensor:
    wo = params["wo"]
    if wo.dim() == 3:
        return torch.einsum("bshk,hkd->bsd", out, wo.to(dt))
    return expert_matmul(out.flatten(-2), wo.flatten(1, 2))


def causal_mask(S: int, window: int = 0, device=None) -> Tensor:
    """(1, S, S) bool: row i sees column j iff j ≤ i (and i − j < window
    when window > 0)."""
    i = torch.arange(S, device=device)[:, None]
    j = torch.arange(S, device=device)[None, :]
    m = j <= i
    if window > 0:
        m &= (i - j) < window
    return m[None]


def full_attention(params, x: Tensor, cfg, *, causal: bool = True,
                   positions: Optional[Tensor] = None) -> Tensor:
    """Self-attention over the whole sequence. x: (B,S,D) → (B,S,D)."""
    S = x.shape[1]
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    q, k, v = _qkv(params, x, cfg, positions)
    out = kops.flash_attention(q.contiguous(), k.contiguous(),
                               v.contiguous(), causal=causal,
                               window=cfg.sliding_window)
    return _project_out(params, out, x.dtype)


def prefill_attention(params, x: Tensor, cfg, cache_len: int):
    """Like ``full_attention`` (causal) but also returns the (K, V) to seed
    the cache, right-padded to ``cache_len``: (out, (k, v)) with k, v
    (B, cache_len, KV, dh)."""
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)[None, :]
    q, k, v = _qkv(params, x, cfg, positions)
    out = kops.flash_attention(q.contiguous(), k.contiguous(),
                               v.contiguous(), causal=True,
                               window=cfg.sliding_window)
    pad = (0, 0, 0, 0, 0, cache_len - S)
    return _project_out(params, out, x.dtype), (F.pad(k, pad), F.pad(v, pad))


def decode_attention(params, x: Tensor, cfg, cache: Tuple[Tensor, Tensor],
                     pos: Tensor, *, rope: bool = True):
    """One-token decode against contiguous cache rows. x: (B,1,D); cache
    K/V: (B,S_cache,KV,dh); pos: () or (B,) int32. Returns (out (B,1,D),
    cache) with each row's new K/V written in place at ``pos`` — or, when
    ``cfg.sliding_window > 0`` (the row is a ring of S_cache = window
    positions), at ``pos % S_cache``.

    The reference rewrites the whole cache through a one-hot mask because
    the scheduler passes a per-slot ``pos`` (B,); scattering one row per
    slot with ``index_put_`` writes the same values. A position past the
    row, which the scheduler never passes (a slot retires at cache_len),
    writes the row's last position, as the reference's scalar-``pos`` path
    does."""
    B = x.shape[0]
    k_cache, v_cache = cache
    S_cache = k_cache.shape[1]
    pos_b = pos.to(torch.int32).expand(B)
    q, k_new, v_new = _qkv(params, x, cfg, pos_b[:, None], rope=rope)
    slot = pos_b % S_cache if cfg.sliding_window > 0 \
        else pos_b.clamp(max=S_cache - 1)
    rows = torch.arange(B, device=x.device)
    k_cache.index_put_((rows, slot.long()), k_new[:, 0].to(k_cache.dtype))
    v_cache.index_put_((rows, slot.long()), v_new[:, 0].to(v_cache.dtype))
    out = kops.decode_attention(q[:, 0].contiguous(), k_cache, v_cache,
                                pos_b.contiguous(),
                                window=cfg.sliding_window)
    return _project_out(params, out[:, None], x.dtype), (k_cache, v_cache)


def paged_decode_attention(params, x: Tensor, cfg,
                           pool: Tuple[Tensor, Tensor], pos: Tensor,
                           block_tables: Tensor, *, rope: bool = True):
    """One-token decode against the paged cache. x: (B,1,D); pool K/V:
    (P,block,KV,dh); pos: (B,) int32; block_tables: (B,NB) int32. Returns
    (out (B,1,D), pool) — the new token's K/V written into the pool in
    place (inactive slots all write scratch block 0, offset 0)."""
    B = x.shape[0]
    k_pool, v_pool = pool
    bs = k_pool.shape[1]
    NB = block_tables.shape[1]
    S_log = NB * bs
    q, k_new, v_new = _qkv(params, x, cfg, pos[:, None], rope=rope)
    r = pos % S_log if cfg.sliding_window > 0 else pos
    col = (r // bs).clamp(max=NB - 1).long()
    blk = block_tables.gather(1, col[:, None])[:, 0].long()
    off = (r % bs).long()
    k_pool.index_put_((blk, off), k_new[:, 0].to(k_pool.dtype))
    v_pool.index_put_((blk, off), v_new[:, 0].to(v_pool.dtype))
    out = kops.paged_decode_attention(q[:, 0].contiguous(), k_pool, v_pool,
                                      pos, block_tables,
                                      window=cfg.sliding_window)
    return _project_out(params, out[:, None], x.dtype), (k_pool, v_pool)


def paged_verify_attention(params, x: Tensor, cfg,
                           pool: Tuple[Tensor, Tensor], pos: Tensor,
                           block_tables: Tensor, *, rope: bool = True):
    """Speculative multi-token verify against the paged cache. x: (B,L,D),
    row ℓ of slot b the candidate token at absolute position pos[b] + ℓ
    (row 0 the committed next token, rows 1..L-1 drafts); pool K/V:
    (P,block,KV,dh); pos: (B,) int32; block_tables: (B,NB) int32. Returns
    (out (B,L,D), pool).

    All B·L candidate K/V are written into the pool first (in place), then
    every row attends under the one fence key position ≤ pos + ℓ, which
    covers the committed prefix and the span's own causality. Rejected-tail
    writes sit past the post-accept position, hidden by the same fence,
    and the next span or vanilla step overwrites them before anything
    attends there. Positions past the table horizon NB·block write scratch
    block 0 (as do inactive slots: pos 0, zeroed tables). Windowless
    caches only (``Model.speculative_capable``)."""
    L = x.shape[1]
    positions = pos[:, None] + torch.arange(L, device=x.device,
                                            dtype=pos.dtype)[None, :]
    q, k_new, v_new = _qkv(params, x, cfg, positions, rope=rope)
    k_pool, v_pool = scatter_span(pool, k_new, v_new, pos, block_tables)
    out = kops.paged_verify_attention(q.contiguous(), k_pool, v_pool, pos,
                                      block_tables)
    return _project_out(params, out, x.dtype), (k_pool, v_pool)


def scatter_span(pool: Tuple[Tensor, Tensor], k_new: Tensor, v_new: Tensor,
                 pos: Tensor, block_tables: Tensor):
    """Write a span's K/V (B,L,KV,dh), row ℓ of slot b at position
    pos[b] + ℓ, into the pool in place through the (B,NB) tables;
    positions past NB·block go to scratch block 0 (offset 0). Live slots
    own distinct blocks, so only block 0 takes more than one write.
    Returns the pool."""
    B, L = k_new.shape[:2]
    k_pool, v_pool = pool
    bs = k_pool.shape[1]
    NB = block_tables.shape[1]
    flat = (pos[:, None] + torch.arange(L, device=pos.device,
                                        dtype=pos.dtype)).reshape(-1)
    rows = torch.arange(B, device=pos.device).repeat_interleave(L)
    safe = flat < NB * bs
    col = (flat // bs).clamp(0, NB - 1).long()
    blk = torch.where(safe, block_tables[rows, col], 0).long()
    off = torch.where(safe, flat % bs, 0).long()
    k_pool.index_put_((blk, off), k_new.reshape(B * L, *k_new.shape[2:])
                      .to(k_pool.dtype))
    v_pool.index_put_((blk, off), v_new.reshape(B * L, *v_new.shape[2:])
                      .to(v_pool.dtype))
    return k_pool, v_pool


def chunk_attention(params, x: Tensor, cfg, pool: Tuple[Tensor, Tensor],
                    start: int, length: int, block_tables: Tensor):
    """Chunked-prefill self-attention through the paged pool. x: (B,C,D),
    row c of each batch row at absolute position ``start + c``; ``length``
    valid rows (a final partial chunk is right-padded to C);
    block_tables: (B,NB) int32, one request's table a row (B = 1 for one
    model; B = K for an expert stack, whose rows share the request's
    logical table, offset into each expert's part of the pool); a (NB,)
    table is B = 1, the reference's form. ``start`` and ``length`` are host
    ints. The chunk's K/V are written into the
    pool first (in place; padded rows go to scratch block 0), so one fence
    — key position ≤ query position — covers the prefix and the chunk.
    Returns (out (B,C,D), pool)."""
    B, C = x.shape[:2]
    k_pool, v_pool = pool
    bs = k_pool.shape[1]
    block_tables = block_tables.reshape(B, -1)
    NB = block_tables.shape[1]
    offs = torch.arange(C, device=x.device)
    pos_c = start + offs
    q, k_new, v_new = _qkv(params, x, cfg, pos_c[None, :])
    valid = offs < length
    blk = torch.where(valid, block_tables[:, (pos_c // bs).clamp(0, NB - 1)],
                      0).long()
    off = torch.where(valid, pos_c % bs, 0).expand(B, C)
    k_pool.index_put_((blk, off), k_new.to(k_pool.dtype))
    v_pool.index_put_((blk, off), v_new.to(v_pool.dtype))
    out = kops.chunk_prefill_attention(q.contiguous(), k_pool, v_pool,
                                       start, block_tables)
    return _project_out(params, out, x.dtype), (k_pool, v_pool)
