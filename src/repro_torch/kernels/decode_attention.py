"""Decode and chunk-prefill attention kernels (CUDA,
``csrc/decode_attention.cu``) beside their plain PyTorch versions.

* ``paged_decode_attention`` — port of the Pallas kernel of the same name
  (``repro/kernels/decode_attention.py:454``): one query token per slot
  attends over its logical KV span through a (B, NB) block table.
* ``decode_attention`` — port of ``decode_attention.py:85``: the same over
  each slot's contiguous (S, KV, dh) cache row.
* ``chunk_prefill_attention`` — port of ``decode_attention.py:240``: a
  prompt chunk's queries attend over the request's paged prefix plus the
  chunk itself (its K/V already scattered into the pool).
* ``paged_verify_attention`` — port of ``decode_attention.py:381``: a
  speculative span of L candidate tokens per slot attends over the slot's
  paged span (the span's K/V already scattered in), row ℓ fenced to keys
  ≤ pos + ℓ.

The CUDA wrappers take CUDA tensors only and count their launches in
``<wrapper>.launches``; the ``*_ref`` plain versions (named after
``repro/kernels/ref.py``) run the grouped softmax attention of
``models.attention.gqa_sdpa`` over the cache row, or over the logical span
they gather out of the pool. The CPU
path and the on-card comparison use the plain versions; ``kernels.ops``
picks one by the tensors' device.
"""
from __future__ import annotations

import math

import torch

from . import build

Tensor = torch.Tensor
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def check_operands(q: Tensor, k: Tensor, v: Tensor, ints, what: str) -> int:
    """Validate device, dtype and contiguity before pointers reach C;
    returns the C side's dtype code."""
    if q.device.type != "cuda":
        raise ValueError(f"{what}: the CUDA kernel needs CUDA tensors, got "
                         f"{q.device}")
    code = _DTYPE_CODES.get(q.dtype)
    if code is None:
        raise TypeError(f"{what}: dtype {q.dtype} not supported "
                        f"(float32 or bfloat16)")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype or t.device != q.device:
            raise TypeError(f"{what}: {name} is {t.dtype} on {t.device}, "
                            f"q is {q.dtype} on {q.device}")
    if k.shape != v.shape:
        raise ValueError(f"{what}: k/v shapes differ")
    for name, t in ints:
        if t.dtype != torch.int32 or t.device != q.device:
            raise TypeError(f"{what}: {name} must be int32 on {q.device}, "
                            f"got {t.dtype} on {t.device}")
    for name, t in (("q", q), ("k", k), ("v", v), *ints):
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    return code


def paged_decode_attention(q: Tensor, k_pool: Tensor, v_pool: Tensor,
                           pos: Tensor, block_tables: Tensor, *,
                           window: int = 0) -> Tensor:
    """CUDA kernel. q: (B,H,dh); k_pool,v_pool: (P,block,KV,dh); pos: (B,)
    int32; block_tables: (B,NB) int32 → (B,H,dh) in q.dtype.

    Keys at logical index ≤ pos are live (with ``window > 0`` the slot's
    span NB·block is a ring: all keys are live once pos ≥ NB·block). Table
    entries must be pool block ids < P; unallocated ones point at the
    scratch block 0 and are killed by the position fence."""
    code = check_operands(q, k_pool, v_pool,
                           (("pos", pos), ("block_tables", block_tables)),
                           "paged_decode_attention")
    B, H, dh = q.shape
    _, block, KV, _ = k_pool.shape
    NB = block_tables.shape[1]
    if H % KV or k_pool.shape[3] != dh or pos.shape != (B,) \
            or block_tables.shape[0] != B:
        raise ValueError(
            f"paged_decode_attention: shapes q {tuple(q.shape)}, pool "
            f"{tuple(k_pool.shape)}, pos {tuple(pos.shape)}, tables "
            f"{tuple(block_tables.shape)} do not agree")
    out = torch.empty_like(q)
    lib = build.load("decode_attention")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = lib.paged_decode_attention(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            pos.data_ptr(), block_tables.data_ptr(), out.data_ptr(), code,
            B, H, KV, dh, block, NB, window, 1.0 / math.sqrt(dh), stream)
    build.check(lib, err, "paged_decode_attention")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0


def decode_attention(q: Tensor, k: Tensor, v: Tensor, pos: Tensor, *,
                     window: int = 0) -> Tensor:
    """CUDA kernel. q: (B,H,dh); k,v: (B,S,KV,dh) contiguous cache rows;
    pos: (B,) int32 → (B,H,dh) in q.dtype.

    Keys at index ≤ pos are live; with ``window > 0`` the row is a ring of
    S positions and every key is live once pos ≥ S. Any S (the kernel
    masks a ragged last key tile)."""
    code = check_operands(q, k, v, (("pos", pos),), "decode_attention")
    B, H, dh = q.shape
    _, S, KV, _ = k.shape
    if H % KV or k.shape != (B, S, KV, dh) or pos.shape != (B,):
        raise ValueError(
            f"decode_attention: shapes q {tuple(q.shape)}, k/v "
            f"{tuple(k.shape)}, pos {tuple(pos.shape)} do not agree")
    out = torch.empty_like(q)
    lib = build.load("decode_attention")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = lib.decode_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
            out.data_ptr(), code, B, H, KV, dh, S, window,
            1.0 / math.sqrt(dh), stream)
    build.check(lib, err, "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0


def chunk_prefill_attention(q: Tensor, k_pool: Tensor, v_pool: Tensor,
                            start: int, block_table: Tensor) -> Tensor:
    """CUDA kernel. q: (C,H,dh) one request's chunk queries (row c at
    absolute position ``start + c``, a host int); k_pool,v_pool:
    (P,block,KV,dh) with the chunk's K/V already scattered in;
    block_table: (NB,) int32 → (C,H,dh) in q.dtype."""
    code = check_operands(q, k_pool, v_pool,
                           (("block_table", block_table),),
                           "chunk_prefill_attention")
    C, H, dh = q.shape
    _, block, KV, _ = k_pool.shape
    NB = block_table.shape[0]
    if H % KV or k_pool.shape[3] != dh or block_table.dim() != 1:
        raise ValueError(
            f"chunk_prefill_attention: shapes q {tuple(q.shape)}, pool "
            f"{tuple(k_pool.shape)}, table {tuple(block_table.shape)} do "
            f"not agree")
    out = torch.empty_like(q)
    lib = build.load("decode_attention")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = lib.chunk_prefill_attention(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            block_table.data_ptr(), out.data_ptr(), code, int(start), C, H,
            KV, dh, block, NB, 1.0 / math.sqrt(dh), stream)
    build.check(lib, err, "chunk_prefill_attention")
    chunk_prefill_attention.launches += 1
    return out


chunk_prefill_attention.launches = 0


def paged_verify_attention(q: Tensor, k_pool: Tensor, v_pool: Tensor,
                           pos: Tensor, block_tables: Tensor) -> Tensor:
    """CUDA kernel. q: (B,L,H,dh) span queries (row ℓ of slot b at absolute
    position pos[b] + ℓ, its K/V already in the pool); k_pool,v_pool:
    (P,block,KV,dh); pos: (B,) int32, read on the device; block_tables:
    (B,NB) int32 → (B,L,H,dh) in q.dtype.

    Row ℓ sees keys at logical index ≤ pos + ℓ among the table's NB·block
    positions (a span past the table horizon sees all of them, as the
    plain version does). Windowless caches only."""
    code = check_operands(q, k_pool, v_pool,
                           (("pos", pos), ("block_tables", block_tables)),
                           "paged_verify_attention")
    B, L, H, dh = q.shape
    _, block, KV, _ = k_pool.shape
    NB = block_tables.shape[1]
    if H % KV or k_pool.shape[3] != dh or pos.shape != (B,) \
            or block_tables.shape[0] != B:
        raise ValueError(
            f"paged_verify_attention: shapes q {tuple(q.shape)}, pool "
            f"{tuple(k_pool.shape)}, pos {tuple(pos.shape)}, tables "
            f"{tuple(block_tables.shape)} do not agree")
    out = torch.empty_like(q)
    lib = build.load("decode_attention")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = lib.paged_verify_attention(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            pos.data_ptr(), block_tables.data_ptr(), out.data_ptr(), code,
            B, L, H, KV, dh, block, NB, 1.0 / math.sqrt(dh), stream)
    build.check(lib, err, "paged_verify_attention")
    paged_verify_attention.launches += 1
    return out


paged_verify_attention.launches = 0


def paged_decode_attention_ref(q: Tensor, k_pool: Tensor, v_pool: Tensor,
                               pos: Tensor, block_tables: Tensor, *,
                               window: int = 0) -> Tensor:
    """Plain version: gather each slot's logical span out of the pool, then
    grouped softmax attention under the position (or ring) rule."""
    from repro_torch.models.attention import gqa_sdpa
    B = q.shape[0]
    NB, block = block_tables.shape[1], k_pool.shape[1]
    S_log = NB * block
    idx = block_tables.long()
    kf = k_pool[idx].reshape(B, S_log, *k_pool.shape[2:])
    vf = v_pool[idx].reshape(B, S_log, *v_pool.shape[2:])
    keys = torch.arange(S_log, device=q.device)[None, :]
    p = pos.long()[:, None]
    valid = keys <= p
    if window > 0:
        valid = valid | (p >= S_log)
    return gqa_sdpa(q[:, None], kf, vf, valid[:, None, :])[:, 0]


def decode_attention_ref(q: Tensor, k: Tensor, v: Tensor, pos: Tensor, *,
                         window: int = 0) -> Tensor:
    """Plain version (after ``repro/kernels/ref.py:38``): grouped softmax
    attention of each slot's query over its cache row under the position
    (or ring) rule."""
    from repro_torch.models.attention import gqa_sdpa
    keys = torch.arange(k.shape[1], device=q.device)[None, :]
    p = pos.long()[:, None]
    valid = keys <= p
    if window > 0:
        valid = valid | (p >= k.shape[1])
    return gqa_sdpa(q[:, None], k, v, valid[:, None, :])[:, 0]


def chunk_prefill_attention_ref(q: Tensor, k_pool: Tensor, v_pool: Tensor,
                                start: int, block_table: Tensor) -> Tensor:
    """Plain version: gather the request's logical span, then grouped
    softmax attention with row c fenced to keys ≤ start + c."""
    from repro_torch.models.attention import gqa_sdpa
    C = q.shape[0]
    NB, block = block_table.shape[0], k_pool.shape[1]
    S_log = NB * block
    idx = block_table.long()
    kf = k_pool[idx].reshape(1, S_log, *k_pool.shape[2:])
    vf = v_pool[idx].reshape(1, S_log, *v_pool.shape[2:])
    pos_c = int(start) + torch.arange(C, device=q.device)
    mask = torch.arange(S_log, device=q.device)[None, :] <= pos_c[:, None]
    return gqa_sdpa(q[None], kf, vf, mask[None])[0]


def paged_verify_attention_ref(q: Tensor, k_pool: Tensor, v_pool: Tensor,
                               pos: Tensor, block_tables: Tensor) -> Tensor:
    """Plain version (the reference's jnp branch, ``models/attention.py
    :270-275``): gather each slot's logical span, then grouped softmax
    attention under a (B, L, S) mask, row ℓ fenced to keys ≤ pos + ℓ."""
    from repro_torch.models.attention import gqa_sdpa
    B, L = q.shape[:2]
    NB, block = block_tables.shape[1], k_pool.shape[1]
    S_log = NB * block
    idx = block_tables.long()
    kf = k_pool[idx].reshape(B, S_log, *k_pool.shape[2:])
    vf = v_pool[idx].reshape(B, S_log, *v_pool.shape[2:])
    rows = pos.long()[:, None] + torch.arange(L, device=q.device)[None, :]
    valid = torch.arange(S_log, device=q.device)[None, None, :] \
        <= rows[:, :, None]
    return gqa_sdpa(q, kf, vf, valid)
