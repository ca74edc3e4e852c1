"""Decode and chunk-prefill attention kernels (CUDA,
``csrc/decode_attention.cu``) beside their plain PyTorch versions.

* ``paged_decode_attention`` — port of the Pallas kernel of the same name
  (``repro/kernels/decode_attention.py:454``): one query token per slot
  attends over its logical KV span through a (B, NB) block table.
* ``decode_attention`` — port of ``decode_attention.py:85``: the same over
  each slot's contiguous (S, KV, dh) cache row.
* ``chunk_prefill_attention`` — port of ``decode_attention.py:240``: a
  prompt chunk's queries attend over the request's paged prefix plus the
  chunk itself (its K/V already scattered into the pool); with a batch
  axis, B such chunks at one shared ``start``, each through its own table
  row — the reference's ``jax.vmap`` of the kernel over an expert stack
  (``repro/core/ensemble.py:196-206``) as one launch.
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

In bf16 all four run on the tensor cores (``csrc/paged_sm90.cuh``) within
the limits ``check_tensor_core_shape`` states, and raise outside them;
float32 runs the scalar kernels. The bf16 verify and decode kernels split
each slot's key range across blocks (``verify_splits``,
``decode_splits``) and merge the float32 partials in a second kernel;
``split_partials_ref`` (over contiguous rows), ``verify_partials_ref``
(over the pool) and ``merge_partials_ref`` are the plain versions of
those two passes, decode's at one span row.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from . import build

Tensor = torch.Tensor
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
KEY_TILE = 64             # keys of a tensor-core key tile
# bf16 verify: at most this many key tiles a split (8 measured fastest of
# 1-16 at the speculative path's shape, PERF.md), until the cap on splits a
# slot binds (the workspace grows with them)
VERIFY_SPLIT_TILES = 8
VERIFY_MAX_SPLITS = 16
# bf16 decode: splits enough that (slot, KV head) pairs x splits reaches
# DECODE_BLOCKS thread blocks (the card's 132 SMs hold two decode blocks
# each; 3-4 key tiles a split, 5-6 splits, measured fastest of 1-17 at
# the main path's 17 tiles, PERF.md), at most DECODE_MAX_SPLITS (the
# merge's 32 lanes) and no more than the key tiles. DECODE_SPLIT_TILES,
# when set, fixes the key tiles a split instead (chip_smoke.py's sweep).
SMS = 132
DECODE_BLOCKS = 2 * SMS
DECODE_MAX_SPLITS = 32
DECODE_SPLIT_TILES: Optional[int] = None


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


def check_tensor_core_shape(what: str, q: Tensor, k: Tensor, *more: Tensor,
                            block: Optional[int] = None) -> None:
    """The bf16 tensor-core kernels' limits (``csrc/flash_sm90.cuh``,
    ``csrc/paged_sm90.cuh``): dh a multiple of 8 (the tensor maps' strides
    are whole 16 bytes) up to 128 (above it the float32 accumulators, dK
    and dV in the flash backward, O in the forwards, pass a thread's 255
    registers; every attention configuration of the repo has dh ≤ 128), at
    most 64 query heads a KV head (a 64-row tile holds whole positions),
    for the paged kernels a page ``block`` that is a power of two from 8 up
    (a 64-key tile is then whole pages, or 64 rows of one page, each landing
    on a 1024-byte boundary of the swizzled tile), operands on 16-byte
    boundaries. q is (..., H, dh), k (..., KV, dh). A shape outside them
    raises with the shapes named: it is never routed to the float32 kernel
    or to the plain version."""
    H, dh = q.shape[-2:]
    KV = k.shape[-2]
    pages = "" if block is None else \
        " and a page block that is a power of two from 8 up"
    if dh % 8 or dh > 128 or H // KV > 64 \
            or pages and (block < 8 or block & (block - 1)):
        raise ValueError(
            f"{what}: the bf16 tensor-core kernel takes dh a multiple of 8 "
            f"up to 128, at most 64 query heads per KV head{pages}; got q "
            f"{tuple(q.shape)}, k {tuple(k.shape)}")
    for t in (q, k, *more):
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: bf16 operands must start on a "
                             f"16-byte boundary (TMA); one of shape "
                             f"{tuple(t.shape)} does not")


def verify_splits(NB: int, block: int):
    """(splits, tiles per split) of the bf16 verify kernel for tables of
    NB blocks: each slot's ⌈NB·block / 64⌉ key tiles cut into as few
    consecutive ranges of at most ``VERIFY_SPLIT_TILES`` tiles as there
    can be, at most ``VERIFY_MAX_SPLITS`` of them, of near-equal length,
    none empty. Fixed by the shapes alone: the host never reads pos."""
    tiles = -(-NB * block // KEY_TILE)
    splits = max(1, min(VERIFY_MAX_SPLITS, -(-tiles // VERIFY_SPLIT_TILES)))
    tps = -(-tiles // splits)
    return -(-tiles // tps), tps


def decode_splits(keys: int, pairs: int):
    """(splits, tiles per split) of the bf16 decode kernels for slots of
    ``keys`` key positions (NB·block paged, S contiguous) and ``pairs``
    (slot, KV head) pairs: each slot's ⌈keys / 64⌉ key tiles cut into
    consecutive ranges of ``tps`` tiles (the last may be shorter), enough
    of them that pairs × splits reaches ``DECODE_BLOCKS``, but no more than
    there are tiles or ``DECODE_MAX_SPLITS`` (``DECODE_SPLIT_TILES``, when
    set, fixes ``tps`` instead).
    Fixed by the shapes alone: the host never reads pos, so the wrapper
    never synchronises."""
    tiles = -(-keys // KEY_TILE)
    if DECODE_SPLIT_TILES:
        tps = min(DECODE_SPLIT_TILES, tiles)
    else:
        tps = max(1, tiles // -(-DECODE_BLOCKS // pairs))
    tps = max(tps, -(-tiles // DECODE_MAX_SPLITS))
    return -(-tiles // tps), tps


def _decode_plan(what: str, q: Tensor, k: Tensor, v: Tensor, keys: int,
                 block: Optional[int] = None):
    """bf16: the tensor-core shape check (raises outside it), the split
    plan and the float32 workspace of the partials (acc, then m, then l)
    as (workspace or None, splits, tiles per split); float32 reads none of
    them."""
    if q.dtype != torch.bfloat16:
        return None, 1, 1
    check_tensor_core_shape(what, q, k, v, block=block)
    B, H, dh = q.shape
    KV = k.shape[-2]
    splits, tps = decode_splits(keys, B * KV)
    if splits == 1:
        return None, splits, tps
    return torch.empty(B * KV * splits * (H // KV) * (dh + 2),
                       dtype=torch.float32, device=q.device), splits, tps


def paged_decode_attention(q: Tensor, k_pool: Tensor, v_pool: Tensor,
                           pos: Tensor, block_tables: Tensor, *,
                           window: int = 0) -> Tensor:
    """CUDA kernel. q: (B,H,dh); k_pool,v_pool: (P,block,KV,dh); pos: (B,)
    int32; block_tables: (B,NB) int32 → (B,H,dh) in q.dtype.

    Keys at logical index ≤ pos are live (with ``window > 0`` the slot's
    span NB·block is a ring: all keys are live once pos ≥ NB·block; both
    rules are the fence min(pos, NB·block − 1), which the bf16 kernel
    applies). Table entries must be pool block ids < P; unallocated ones
    point at the scratch block 0 and are killed by the position fence. In
    bf16 each slot's keys are split across blocks (``decode_splits``)
    whose float32 partials a second kernel merges, in a workspace
    allocated here."""
    code = check_operands(q, k_pool, v_pool,
                           (("pos", pos), ("block_tables", block_tables)),
                           "paged_decode_attention")
    B, H, dh = q.shape
    P, block, KV, _ = k_pool.shape
    NB = block_tables.shape[1]
    if H % KV or k_pool.shape[3] != dh or pos.shape != (B,) \
            or block_tables.shape[0] != B:
        raise ValueError(
            f"paged_decode_attention: shapes q {tuple(q.shape)}, pool "
            f"{tuple(k_pool.shape)}, pos {tuple(pos.shape)}, tables "
            f"{tuple(block_tables.shape)} do not agree")
    work, splits, tps = _decode_plan("paged_decode_attention", q, k_pool,
                                     v_pool, NB * block, block=block)
    out = torch.empty_like(q)
    lib = build.load("decode_attention")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = lib.paged_decode_attention(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            pos.data_ptr(), block_tables.data_ptr(), out.data_ptr(),
            None if work is None else work.data_ptr(), code, B, H, KV, dh,
            block, NB, P, window, splits, tps, 1.0 / math.sqrt(dh), stream)
    build.check(lib, err, "paged_decode_attention")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0


def decode_attention(q: Tensor, k: Tensor, v: Tensor, pos: Tensor, *,
                     window: int = 0) -> Tensor:
    """CUDA kernel. q: (B,H,dh); k,v: (B,S,KV,dh) contiguous cache rows;
    pos: (B,) int32 → (B,H,dh) in q.dtype.

    Keys at index ≤ pos are live; with ``window > 0`` the row is a ring of
    S positions and every key is live once pos ≥ S (both the fence min(pos,
    S − 1)). Any S: the float32 kernel masks a ragged last key tile, the
    bf16 kernel's loads read zeros past S under the fence. In bf16 the keys
    are split and merged as in ``paged_decode_attention``."""
    code = check_operands(q, k, v, (("pos", pos),), "decode_attention")
    B, H, dh = q.shape
    _, S, KV, _ = k.shape
    if H % KV or k.shape != (B, S, KV, dh) or pos.shape != (B,):
        raise ValueError(
            f"decode_attention: shapes q {tuple(q.shape)}, k/v "
            f"{tuple(k.shape)}, pos {tuple(pos.shape)} do not agree")
    work, splits, tps = _decode_plan("decode_attention", q, k, v, S)
    out = torch.empty_like(q)
    lib = build.load("decode_attention")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = lib.decode_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
            out.data_ptr(), None if work is None else work.data_ptr(), code,
            B, H, KV, dh, S, window, splits, tps, 1.0 / math.sqrt(dh),
            stream)
    build.check(lib, err, "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0


def chunk_prefill_attention(q: Tensor, k_pool: Tensor, v_pool: Tensor,
                            start: int, block_table: Tensor) -> Tensor:
    """CUDA kernel. q: (B,C,H,dh), B requests' chunk queries (row c at
    absolute position ``start + c``, a host int shared by all B);
    k_pool,v_pool: (P,block,KV,dh) with the chunks' K/V already scattered
    in; block_table: (B,NB) int32, row b request b's table → (B,C,H,dh)
    in q.dtype. The unbatched form, q (C,H,dh) with a (NB,) table, is
    B = 1."""
    if q.dim() == 3:
        return chunk_prefill_attention(q[None], k_pool, v_pool, start,
                                       block_table[None])[0]
    code = check_operands(q, k_pool, v_pool,
                           (("block_table", block_table),),
                           "chunk_prefill_attention")
    B, C, H, dh = q.shape
    _, block, KV, _ = k_pool.shape
    NB = block_table.shape[-1]
    if H % KV or k_pool.shape[3] != dh or block_table.shape != (B, NB):
        raise ValueError(
            f"chunk_prefill_attention: shapes q {tuple(q.shape)}, pool "
            f"{tuple(k_pool.shape)}, table {tuple(block_table.shape)} do "
            f"not agree")
    if q.dtype == torch.bfloat16:
        check_tensor_core_shape("chunk_prefill_attention", q, k_pool,
                                v_pool, block=block)
    out = torch.empty_like(q)
    lib = build.load("decode_attention")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = lib.chunk_prefill_attention(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            block_table.data_ptr(), out.data_ptr(), code, int(start), B, C,
            H, KV, dh, block, NB, k_pool.shape[0], 1.0 / math.sqrt(dh),
            stream)
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
    plain version does). Windowless caches only. In bf16 each slot's keys
    are split across blocks (``verify_splits``) whose float32 partials a
    second kernel merges, in a workspace allocated here."""
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
    splits, tps = verify_splits(NB, block)
    work = None
    if q.dtype == torch.bfloat16:
        check_tensor_core_shape("paged_verify_attention", q, k_pool,
                                v_pool, block=block)
        if splits > 1:      # float32 partials (acc, then m, then l)
            work = torch.empty(B * KV * splits * L * (H // KV) * (dh + 2),
                               dtype=torch.float32, device=q.device)
    out = torch.empty_like(q)
    lib = build.load("decode_attention")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = lib.paged_verify_attention(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            pos.data_ptr(), block_tables.data_ptr(), out.data_ptr(),
            None if work is None else work.data_ptr(), code, B, L, H, KV,
            dh, block, NB, k_pool.shape[0], splits, tps,
            1.0 / math.sqrt(dh), stream)
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
    """Plain version: gather each request's logical span, then grouped
    softmax attention with row c fenced to keys ≤ start + c. q (B,C,H,dh)
    with tables (B,NB), or (C,H,dh) with (NB,)."""
    from repro_torch.models.attention import gqa_sdpa
    if q.dim() == 3:
        return chunk_prefill_attention_ref(q[None], k_pool, v_pool, start,
                                           block_table[None])[0]
    B, C = q.shape[:2]
    NB, block = block_table.shape[1], k_pool.shape[1]
    S_log = NB * block
    idx = block_table.long()
    kf = k_pool[idx].reshape(B, S_log, *k_pool.shape[2:])
    vf = v_pool[idx].reshape(B, S_log, *v_pool.shape[2:])
    pos_c = int(start) + torch.arange(C, device=q.device)
    mask = torch.arange(S_log, device=q.device)[None, :] <= pos_c[:, None]
    return gqa_sdpa(q, kf, vf, mask[None])


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


def split_partials_ref(q: Tensor, k: Tensor, v: Tensor, pos: Tensor,
                       splits: int, tps: int):
    """Plain version of the first pass of the bf16 verify and decode
    kernels, in float32, over contiguous rows: q (B, L, H, dh) span rows
    (decode: L = 1), k and v (B, S, KV, dh). For split s of each slot's key
    tiles, keys [64·tps·s, 64·tps·(s + 1)), the partials of every (slot, KV
    head, row) — rows (ℓ, group head) ℓ-major, row ℓ fenced to keys ≤
    min(pos + ℓ, S − 1) — as m (the largest scaled score, log2 units, −1e30
    where the row sees no key of the split), l (the sum of 2^(x − m)) and
    acc (the unnormalised output). Returns (m, l, acc, live): (B, KV,
    splits, L·group), the same, (B, KV, splits, L·group, dh), and (B,) the
    live splits of each slot, those that start at or before its horizon
    min(pos + L − 1, S − 1)."""
    from repro_torch.models.attention import NEG_INF
    B, L, H, dh = q.shape
    S, KV = k.shape[1], k.shape[2]
    group = H // KV
    kf = k.float()
    vf = v.float().permute(0, 2, 1, 3)
    qg = q.float().reshape(B, L, KV, group, dh).permute(0, 2, 1, 3, 4) \
        .reshape(B, KV, L * group, dh)
    x = torch.einsum("bkrd,bskd->bkrs", qg, kf) * (math.log2(math.e)
                                                   / math.sqrt(dh))
    offs = torch.arange(L, device=q.device).repeat_interleave(group)
    hi = (pos.long()[:, None] + offs[None]).clamp(max=S - 1)    # (B, rows)
    keys = torch.arange(S, device=q.device)
    x = x.masked_fill(keys > hi[:, None, :, None], NEG_INF)
    span = tps * KEY_TILE
    ms, ls, accs = [], [], []
    for s in range(splits):
        xs = x[..., s * span:(s + 1) * span]
        m = xs.amax(-1)
        p = torch.exp2(xs - m[..., None])
        ms.append(m)
        ls.append(p.sum(-1))
        accs.append(p @ vf[:, :, s * span:(s + 1) * span])
    horizon = (pos.long() + L - 1).clamp(max=S - 1)
    live = (horizon // span + 1).clamp(max=splits)
    return (torch.stack(ms, 2), torch.stack(ls, 2), torch.stack(accs, 2),
            live)


def verify_partials_ref(q: Tensor, k_pool: Tensor, v_pool: Tensor,
                        pos: Tensor, block_tables: Tensor, splits: int,
                        tps: int):
    """``split_partials_ref`` over each slot's logical span of NB·block
    positions, gathered out of the pool through its table row: the plain
    version of the first pass of the bf16 verify kernel, and at L = 1
    (q[:, None]) of the bf16 paged decode kernel."""
    B, NB = block_tables.shape
    block, KV, dh = k_pool.shape[1:]
    idx = block_tables.long()
    return split_partials_ref(q, k_pool[idx].reshape(B, NB * block, KV, dh),
                              v_pool[idx].reshape(B, NB * block, KV, dh),
                              pos, splits, tps)


def merge_partials_ref(m: Tensor, l: Tensor, acc: Tensor, live: Tensor,
                       L: int) -> Tensor:
    """Plain version of the merge of the bf16 verify and decode kernels:
    each row's live partials (``split_partials_ref``'s layout) combined as
    M = max mᵢ, out = Σ 2^(mᵢ − M)·accᵢ / max(Σ 2^(mᵢ − M)·lᵢ, 1e-30);
    splits past ``live`` are not read. Returns (B, L, H, dh) in float32."""
    from repro_torch.models.attention import NEG_INF
    B, KV, splits, R, dh = acc.shape
    dead = (torch.arange(splits, device=m.device)[None, :]
            >= live[:, None])[:, None, :, None]           # (B, 1, splits, 1)
    M = m.masked_fill(dead, NEG_INF).amax(2, keepdim=True)
    w = torch.exp2(m - M).masked_fill(dead, 0.0)
    num = (w[..., None] * acc.masked_fill(dead[..., None], 0.0)).sum(2)
    den = (w * l.masked_fill(dead, 0.0)).sum(2)
    out = num / den.clamp_min(1e-30)[..., None]            # (B, KV, R, dh)
    return out.reshape(B, KV, L, R // L, dh).permute(0, 2, 1, 3, 4) \
        .reshape(B, L, KV * (R // L), dh)
