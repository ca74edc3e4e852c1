"""The kernels' plain PyTorch versions against the reference: the
``repro/kernels/ref.py`` oracles and the Pallas kernels run in interpret
mode (tiny shapes — interpret mode is slow), at ragged shapes the Pallas
wrappers refuse against the oracles alone. Float32 on both sides;
rtol = atol = 2e-5 because the two differ only in summation order (the
oracles repeat KV heads and take one softmax, the Pallas kernels run a
blocked online softmax). The bf16 verify and decode kernels'
split-and-merge rule (their plain versions) is held at 1e-6 against the
unsplit plain versions: both are float32 sums of the same terms, within a
few ulps.

The CUDA kernels themselves have no CPU mode: their tests are in
``test_torch_cuda.py``, marked ``gpu``.
"""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref  # noqa: E402
from repro.kernels.decode_attention import (  # noqa: E402
    chunk_prefill_attention as pallas_chunk,
    decode_attention as pallas_decode,
    paged_decode_attention as pallas_paged,
    paged_verify_attention as pallas_verify)
from repro.kernels.flash_attention import (  # noqa: E402
    flash_attention_with_lse as pallas_flash)
from repro.kernels.router_scores import router_scores as pallas_router  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels import decode_attention as dk  # noqa: E402
from repro_torch.kernels import flash_attention as fk  # noqa: E402
from repro_torch.kernels import router_scores as rk  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-5)


def f32(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def paged_inputs(seed, B, NB, block, H, KV, dh, pos=None, unallocated=True):
    rng = np.random.default_rng(seed)
    P = B * NB + 3                        # pool bigger than needed
    q, kp, vp = f32(rng, B, H, dh), f32(rng, P, block, KV, dh), \
        f32(rng, P, block, KV, dh)
    bt = rng.permutation(np.arange(1, P))[:B * NB].reshape(B, NB) \
        .astype(np.int32)
    if pos is None:
        pos = rng.integers(0, NB * block, B)
    pos = np.asarray(pos, np.int32)
    if unallocated:                       # past-horizon entries → scratch 0
        bt = np.where(np.arange(NB)[None, :] <= pos[:, None] // block, bt,
                      0).astype(np.int32)
    return q, kp, vp, pos, bt


def check(got, *wants):
    for want in wants:
        np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                                   **TOL)


@pytest.mark.parametrize("B,NB,block,H,KV,dh", [
    (2, 4, 32, 4, 4, 64),     # MHA
    (3, 8, 16, 8, 2, 64),     # GQA 4:1
    (1, 4, 64, 4, 1, 128),    # MQA
])
def test_paged_decode_plain_matches_reference(B, NB, block, H, KV, dh):
    q, kp, vp, pos, bt = paged_inputs(0, B, NB, block, H, KV, dh)
    got = dk.paged_decode_attention_ref(*map(torch.as_tensor,
                                            (q, kp, vp, pos, bt)))
    j = [jnp.asarray(a) for a in (q, kp, vp, pos, bt)]
    check(got, ref.paged_decode_attention_ref(*j),
          pallas_paged(*j, interpret=True))


@pytest.mark.parametrize("pos_vals", [(3, 60), (64, 200), (63, 64)])
def test_paged_decode_plain_ring_matches_reference(pos_vals):
    """window > 0: the slot's logical span NB·block is a ring."""
    B, NB, block, H, KV, dh = 2, 4, 16, 4, 2, 64
    q, kp, vp, pos, bt = paged_inputs(1, B, NB, block, H, KV, dh, pos_vals,
                                      unallocated=False)
    got = dk.paged_decode_attention_ref(
        *map(torch.as_tensor, (q, kp, vp, pos, bt)), window=NB * block)
    j = [jnp.asarray(a) for a in (q, kp, vp, pos, bt)]
    check(got, ref.paged_decode_attention_ref(*j, window=NB * block),
          pallas_paged(*j, window=NB * block, interpret=True))


@pytest.mark.parametrize("C,NB,block,H,KV,dh,start", [
    (8, 4, 16, 4, 4, 64, 24),     # MHA, mid-prompt chunk
    (6, 8, 8, 8, 2, 64, 34),      # GQA 4:1, chunk straddles a block
    (16, 4, 32, 4, 1, 128, 112),  # MQA, final chunk ends at capacity
])
def test_chunk_prefill_plain_matches_reference(C, NB, block, H, KV, dh,
                                               start):
    rng = np.random.default_rng(0)
    P = NB + 3
    q, kp, vp = f32(rng, C, H, dh), f32(rng, P, block, KV, dh), \
        f32(rng, P, block, KV, dh)
    bt = rng.permutation(np.arange(1, P))[:NB].astype(np.int32)
    # entries past the chunk's horizon are unallocated (scratch block 0)
    bt[np.arange(NB) > (start + C - 1) // block] = 0
    got = dk.chunk_prefill_attention_ref(
        torch.as_tensor(q), torch.as_tensor(kp), torch.as_tensor(vp), start,
        torch.as_tensor(bt))
    j = [jnp.asarray(a) for a in (q, kp, vp)]
    check(got,
          ref.chunk_prefill_attention_ref(*j, jnp.int32(start),
                                          jnp.asarray(bt)),
          pallas_chunk(*j, jnp.int32(start), jnp.asarray(bt),
                       interpret=True))


def flash_inputs(seed, B, S, H, KV, dh):
    rng = np.random.default_rng(seed)
    return f32(rng, B, S, H, dh), f32(rng, B, S, KV, dh), \
        f32(rng, B, S, KV, dh)


def lse_oracle(q, k, causal, window):
    """Log-sum-exp of each row's masked scaled scores, in float64 numpy
    (the reference's ``ref.py`` oracle returns the output only)."""
    B, S, H, dh = q.shape
    kf = np.repeat(k, H // k.shape[2], axis=2).astype(np.float64)
    s = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64), kf) / np.sqrt(dh)
    if causal:
        i, j = np.arange(S)[:, None], np.arange(S)[None, :]
        m = j <= i
        if window:
            m &= (i - j) < window
        s = np.where(m, s, -np.inf)
    top = s.max(-1, keepdims=True)
    lse = (top + np.log(np.exp(s - top).sum(-1, keepdims=True)))[..., 0]
    return lse.transpose(0, 2, 1)                          # (B, S, H)


@pytest.mark.parametrize("B,S,H,KV,dh,causal,window", [
    (1, 64, 4, 4, 32, True, 0),       # MHA, one tile
    (1, 128, 8, 2, 32, True, 0),      # GQA 4:1, two tiles
    (2, 64, 4, 1, 32, False, 0),      # MQA, not causal
    (1, 128, 4, 2, 32, True, 48),     # window straddling tiles
])
def test_flash_plain_matches_pallas_kernel(B, S, H, KV, dh, causal, window):
    """Output and lse against the Pallas kernel (interpret mode, 64-row
    blocks)."""
    q, k, v = flash_inputs(0, B, S, H, KV, dh)
    out, lse = fk.flash_attention_with_lse_ref(
        *map(torch.as_tensor, (q, k, v)), causal=causal, window=window)
    jout, jlse = pallas_flash(*map(jnp.asarray, (q, k, v)), causal=causal,
                              window=window, block_q=64, block_k=64,
                              interpret=True)
    check(out, jout)
    check(lse, jlse)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 10),
                                           (False, 0)])
def test_flash_plain_ragged_matches_oracle(causal, window):
    """S = 77, which the Pallas wrapper refuses (S % 64 != 0): the output
    against ``ref.flash_attention_ref``, the lse against a float64 one."""
    q, k, v = flash_inputs(1, 2, 77, 8, 2, 32)
    out, lse = fk.flash_attention_with_lse_ref(
        *map(torch.as_tensor, (q, k, v)), causal=causal, window=window)
    check(out, ref.flash_attention_ref(*map(jnp.asarray, (q, k, v)),
                                       causal=causal, window=window))
    check(lse, lse_oracle(q, k, causal, window))
    torch.testing.assert_close(
        fk.flash_attention_ref(*map(torch.as_tensor, (q, k, v)),
                               causal=causal, window=window), out,
        rtol=0, atol=0)


def decode_inputs(seed, B, S, H, KV, dh, pos):
    rng = np.random.default_rng(seed)
    return f32(rng, B, H, dh), f32(rng, B, S, KV, dh), \
        f32(rng, B, S, KV, dh), np.asarray(pos, np.int32)


@pytest.mark.parametrize("B,S,H,KV,dh,pos,window", [
    (3, 256, 8, 2, 64, (0, 100, 255), 0),     # GQA 4:1, fence at both ends
    (2, 128, 4, 4, 64, (63, 64), 0),          # MHA, a block boundary
    (2, 128, 4, 2, 64, (40, 4000), 128),      # ring: one pre-, one post-wrap
    (2, 128, 4, 2, 64, (127, 128), 128),      # ring: the wrap boundary
])
def test_decode_plain_matches_pallas_kernel(B, S, H, KV, dh, pos, window):
    """Against ``ref.decode_attention_ref`` and the Pallas kernel
    (interpret mode, 64-key blocks); the ring cases are those of
    ``tests/test_kernels.py``."""
    a = decode_inputs(2, B, S, H, KV, dh, pos)
    got = dk.decode_attention_ref(*map(torch.as_tensor, a), window=window)
    j = [jnp.asarray(x) for x in a]
    check(got, ref.decode_attention_ref(*j, window=window),
          pallas_decode(*j, window=window, block_k=64, interpret=True))


@pytest.mark.parametrize("pos,window", [((0, 299, 157), 0),
                                        ((299, 300, 1000), 300)])
def test_decode_plain_ragged_matches_oracle(pos, window):
    """S = 300, which the Pallas wrapper refuses (300 % min(256, 300) !=
    0); against ``ref.decode_attention_ref``."""
    a = decode_inputs(3, 3, 300, 4, 1, 32, pos)
    check(dk.decode_attention_ref(*map(torch.as_tensor, a), window=window),
          ref.decode_attention_ref(*map(jnp.asarray, a), window=window))


@pytest.mark.parametrize("B,K,D,tau", [(8, 2, 32, 10.0), (100, 6, 64, 1.0),
                                       (1, 2, 32, 10.0)])
def test_router_plain_matches_reference(B, K, D, tau):
    rng = np.random.default_rng(4)
    x, c = f32(rng, B, D), f32(rng, K, D)
    got = rk.router_scores_ref(torch.as_tensor(x), torch.as_tensor(c), tau)
    check(got, ref.router_scores_ref(jnp.asarray(x), jnp.asarray(c), tau),
          pallas_router(jnp.asarray(x), jnp.asarray(c), tau, block_b=64,
                        interpret=True))


def test_ops_take_plain_version_on_cpu_without_launching():
    ops.reset_launch_counts()
    q, kp, vp, pos, bt = map(torch.as_tensor,
                             paged_inputs(2, 2, 4, 8, 4, 2, 16))
    torch.testing.assert_close(
        ops.paged_decode_attention(q, kp, vp, pos, bt),
        dk.paged_decode_attention_ref(q, kp, vp, pos, bt), rtol=0, atol=0)
    torch.testing.assert_close(
        ops.chunk_prefill_attention(q, kp, vp, 3, bt[0]),
        dk.chunk_prefill_attention_ref(q, kp, vp, 3, bt[0]), rtol=0, atol=0)
    x = torch.randn(3, 8)
    torch.testing.assert_close(ops.router_scores(x, x[:2], 5.0),
                               rk.router_scores_ref(x, x[:2], 5.0),
                               rtol=0, atol=0)
    fq, fkk, fv = map(torch.as_tensor, flash_inputs(4, 1, 9, 4, 2, 16))
    torch.testing.assert_close(
        ops.flash_attention(fq, fkk, fv, window=3),
        fk.flash_attention_ref(fq, fkk, fv, window=3), rtol=0, atol=0)
    dq, dkc, dv, dpos = map(torch.as_tensor,
                            decode_inputs(5, 2, 12, 4, 2, 16, (3, 11)))
    torch.testing.assert_close(
        ops.decode_attention(dq, dkc, dv, dpos),
        dk.decode_attention_ref(dq, dkc, dv, dpos), rtol=0, atol=0)
    assert all(fn.launches == 0 for fn in ops.KERNELS.values())


def test_kernel_wrappers_refuse_cpu_tensors_and_other_devices():
    """A CUDA wrapper never takes the plain path; ops has no path for a
    device that is neither cuda nor cpu."""
    q, kp, vp, pos, bt = map(torch.as_tensor,
                             paged_inputs(3, 1, 2, 8, 2, 1, 8))
    with pytest.raises(ValueError, match="CUDA tensors"):
        dk.paged_decode_attention(q, kp, vp, pos, bt)
    with pytest.raises(ValueError, match="CUDA tensors"):
        dk.chunk_prefill_attention(q, kp, vp, 0, bt[0])
    with pytest.raises(ValueError, match="CUDA tensors"):
        rk.router_scores(q[0], q[0], 1.0)
    with pytest.raises(ValueError, match="CUDA tensors"):
        dk.decode_attention(q, kp[:1], vp[:1], pos)
    fq = q[None]
    with pytest.raises(ValueError, match="CUDA tensors"):
        fk.flash_attention(fq, fq, fq)
    with pytest.raises(ValueError, match="no kernel"):
        ops.router_scores(torch.zeros(2, 4, device="meta"),
                          torch.zeros(2, 4, device="meta"), 1.0)


def test_build_dir_is_ignored_and_sources_exist():
    root = build.build_dir().parents[1]
    assert (root / ".gitignore").read_text().splitlines().count("build/")
    for name in build.SOURCES:
        assert (build.CSRC / f"{name}.cu").is_file()


@pytest.mark.parametrize("B,S,H,KV,dh,ok", [
    (1, 8, 32, 8, 128, True),      # Qwen3-8B's heads
    (1, 8, 32, 32, 80, True),      # Zamba2's
    (1, 8, 6, 2, 40, True),        # dh 40, a group of 3
    (1, 8, 4, 2, 32, True),
    (1, 8, 4, 2, 36, False),       # dh not a multiple of 8
    (1, 8, 4, 2, 136, False),      # dh past 128
    (1, 8, 128, 1, 64, False),     # 128 query heads on one KV head
])
def test_bf16_tensor_core_shape_check(B, S, H, KV, dh, ok):
    """The bf16 kernels' limits are checked before a launch and raise with
    the shape named; nothing is routed to another kernel."""
    q = torch.zeros((B, S, H, dh), dtype=torch.bfloat16)
    k = torch.zeros((B, S, KV, dh), dtype=torch.bfloat16)
    if ok:
        fk.check_tensor_core_shape("flash", q, k, k)
    else:
        with pytest.raises(ValueError, match=r"q \(1, 8, "):
            fk.check_tensor_core_shape("flash", q, k, k)


def test_bf16_tensor_core_alignment_check():
    """An operand off a 16-byte boundary (TMA reads whole 16-byte units)
    raises."""
    q = torch.zeros((1, 8, 4, 64), dtype=torch.bfloat16)
    k = torch.zeros(2 * 8 * 64 + 4, dtype=torch.bfloat16)[4:] \
        .view(1, 8, 2, 64)
    with pytest.raises(ValueError, match="16-byte boundary"):
        fk.check_tensor_core_shape("flash", q, k, k)


@pytest.mark.parametrize("block,dh,H,KV,ok", [
    (16, 128, 32, 8, True),      # the main path: Qwen3-8B's heads
    (8, 128, 32, 8, True),       # every power-of-two block from 8 up
    (32, 128, 32, 8, True),
    (64, 128, 32, 8, True),
    (128, 64, 8, 2, True),
    (16, 80, 32, 32, True),      # Zamba2's heads
    (16, 40, 6, 2, True),        # dh 40, a group of 3
    (16, 64, 64, 1, True),       # a group of 64 rows
    (4, 64, 8, 2, False),        # block below 8
    (12, 64, 8, 2, False),       # block not a power of two
    (48, 64, 8, 2, False),
    (16, 36, 8, 2, False),       # dh not a multiple of 8
    (16, 136, 8, 2, False),      # dh past 128
    (16, 64, 128, 1, False),     # 128 query heads on one KV head
])
@pytest.mark.parametrize("kind", ["chunk", "verify"])
def test_paged_tensor_core_shape_check(block, dh, H, KV, ok, kind):
    """The bf16 chunk-prefill and verify kernels' limits are checked before
    a launch and raise with the shapes named; nothing is routed to the
    float32 kernel or to the plain version."""
    q = torch.zeros((5, H, dh) if kind == "chunk" else (2, 3, H, dh),
                    dtype=torch.bfloat16)
    pool = torch.zeros((3, block, KV, dh), dtype=torch.bfloat16)
    if ok:
        dk.check_tensor_core_shape(kind, q, pool, pool, block=block)
    else:
        with pytest.raises(ValueError, match=re.escape(
                f"q {tuple(q.shape)}, k (3, {block}, {KV}, {dh})")):
            dk.check_tensor_core_shape(kind, q, pool, pool, block=block)


def test_paged_tensor_core_alignment_check():
    """An operand off a 16-byte boundary (TMA reads whole 16-byte units)
    raises."""
    q = torch.zeros((4, 8, 64), dtype=torch.bfloat16)
    pool = torch.zeros(3 * 16 * 2 * 64 + 4, dtype=torch.bfloat16)[4:] \
        .view(3, 16, 2, 64)
    with pytest.raises(ValueError, match="16-byte boundary"):
        dk.check_tensor_core_shape("chunk", q, pool, pool, block=16)


@pytest.mark.parametrize("NB", [1, 3, 7, 48, 68, 100, 4096])
@pytest.mark.parametrize("block", [8, 16, 32, 64, 128])
def test_verify_splits_cover_every_key_once(NB, block):
    """Every key of [0, NB·block) lies in exactly one split, no split is
    empty, there are at most VERIFY_MAX_SPLITS of them, and a split holds
    at most VERIFY_SPLIT_TILES key tiles unless that cap binds."""
    splits, tps = dk.verify_splits(NB, block)
    S, span = NB * block, tps * dk.KEY_TILE
    tiles = -(-S // dk.KEY_TILE)
    seen = np.zeros(S, np.int32)
    for s in range(splits):
        lo, hi = s * span, min((s + 1) * span, S)
        assert lo < hi
        seen[lo:hi] += 1
    assert (seen == 1).all()
    assert 1 <= splits <= dk.VERIFY_MAX_SPLITS
    assert tps <= max(dk.VERIFY_SPLIT_TILES,
                      -(-tiles // dk.VERIFY_MAX_SPLITS))


def verify_inputs(seed, B, NB, block, L, H, KV, dh, pos, idle=(),
                  tail=True):
    """Span queries, pools, pos and tables as the scheduler leaves them:
    ``idle`` slots at pos 0 with zeroed tables; with ``tail`` the entries
    past a slot's span horizon point at scratch 0."""
    rng = np.random.default_rng(seed)
    P = B * NB + 1
    q = f32(rng, B, L, H, dh)
    kp, vp = f32(rng, P, block, KV, dh), f32(rng, P, block, KV, dh)
    bt = rng.permutation(np.arange(1, P)).reshape(B, NB).astype(np.int32)
    pos = np.asarray(pos, np.int32)
    for b in idle:
        pos[b], bt[b] = 0, 0
    if tail:
        bt = np.where(np.arange(NB)[None, :] <= (pos[:, None] + L - 1)
                      // block, bt, 0).astype(np.int32)
    return q, kp, vp, pos, bt


SPLIT_CASES = [
    # B, NB, block, L, H, KV, dh, pos, idle, tail
    (3, 16, 16, 4, 8, 2, 32, (126, 127, 200), (), True),   # masked splits
    (4, 8, 16, 4, 8, 2, 32, (30, 0, 45, 0), (1, 3), True),  # idle slots
    (3, 4, 16, 4, 8, 2, 32, (62, 63, 61), (), False),      # past the horizon
    (2, 8, 16, 8, 32, 2, 16, (10, 120), (), True),         # two row tiles
    (2, 16, 8, 2, 4, 4, 32, (60, 100), (), True),          # block 8, L = 2
    (2, 2, 128, 4, 4, 1, 32, (100, 252), (), True),        # block 128, MQA
]


@pytest.mark.parametrize("B,NB,block,L,H,KV,dh,pos,idle,tail", SPLIT_CASES)
@pytest.mark.parametrize("plan", ["kernel", "one tile a split"])
def test_verify_split_merge_matches_unsplit(B, NB, block, L, H, KV, dh, pos,
                                            idle, tail, plan):
    """Partials over the splits, merged by the kernel's rule, equal the
    unsplit plain version in float32 — with rows whose split sees no key
    (m = −1e30), idle slots and spans past the table horizon."""
    q, kp, vp, p, bt = map(torch.as_tensor, verify_inputs(
        13, B, NB, block, L, H, KV, dh, pos, idle, tail))
    tiles = -(-NB * block // dk.KEY_TILE)
    splits, tps = dk.verify_splits(NB, block) if plan == "kernel" \
        else (tiles, 1)
    m, l, acc, live = dk.verify_partials_ref(q, kp, vp, p, bt, splits, tps)
    got = dk.merge_partials_ref(m, l, acc, live, L)
    want = dk.paged_verify_attention_ref(q, kp, vp, p, bt)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    if plan != "kernel" and pos[0] == 126:
        # rows 0-1 of slot 0 see keys <= 126, 127: none of split 2's
        assert (m[0, :, 2, :2 * (H // KV)] <= -1e30).all()
        assert (live == torch.tensor([3, 3, 4])).all()


def test_verify_split_merge_matches_pallas_kernel():
    """The split-and-merge rule against the reference's Pallas verify
    kernel in interpret mode, at a tiny shape with a masked split."""
    q, kp, vp, p, bt = verify_inputs(14, 2, 8, 16, 4, 4, 2, 16, (62, 20))
    m, l, acc, live = dk.verify_partials_ref(
        *map(torch.as_tensor, (q, kp, vp, p, bt)), 2, 1)
    check(dk.merge_partials_ref(m, l, acc, live, 4),
          pallas_verify(*map(jnp.asarray, (q, kp, vp, p, bt)),
                        interpret=True))


# bf16 decode: the split plan and the plain split-and-merge rule

@pytest.mark.parametrize("keys,pairs", [
    (68 * 16, 8 * 8),       # the main path: NB = 68 blocks of 16, Qwen3-8B
    (1088, 8 * 8),          # the contiguous path: S = 1088
    (68 * 16, 8 * 32),      # the hybrid path: Zamba2's 32 KV heads
    (64 * 16, 8 * 8),       # the timed paged shape: NB = 64
    (1, 1), (8, 3), (63, 64), (64, 1), (65, 1), (100, 2),   # edges
    (4096 * 16, 1),         # more tiles than the merge has lanes
    (4096 * 16, 512),
])
@pytest.mark.parametrize("fixed", [None, 1, 3, 17])
def test_decode_splits_cover_every_key_once(keys, pairs, fixed,
                                            monkeypatch):
    """Every key of [0, keys) lies in exactly one split, no split is empty,
    there are at most DECODE_MAX_SPLITS; by the rule, pairs × splits
    reaches DECODE_BLOCKS unless the tiles or that cap bind first, and a
    fixed DECODE_SPLIT_TILES (the sweep's) is taken where the cap allows."""
    monkeypatch.setattr(dk, "DECODE_SPLIT_TILES", fixed)
    splits, tps = dk.decode_splits(keys, pairs)
    span = tps * dk.KEY_TILE
    tiles = -(-keys // dk.KEY_TILE)
    seen = np.zeros(keys, np.int32)
    for s in range(splits):
        lo, hi = s * span, min((s + 1) * span, keys)
        assert lo < hi
        seen[lo:hi] += 1
    assert (seen == 1).all()
    assert 1 <= splits <= dk.DECODE_MAX_SPLITS
    if fixed is None:
        assert pairs * splits >= dk.DECODE_BLOCKS or splits == tiles \
            or tps == -(-tiles // dk.DECODE_MAX_SPLITS)
    elif tiles <= fixed * dk.DECODE_MAX_SPLITS:
        assert tps == min(fixed, tiles)


def test_decode_splits_at_the_main_path():
    """The main path's 17 key tiles over 64 (slot, KV head) pairs: more
    blocks than the card's 132 SMs."""
    splits, tps = dk.decode_splits(68 * 16, 64)
    assert splits * 64 >= dk.SMS and splits * tps >= 17


DECODE_SPLIT_CASES = [
    # B, NB, block, H, KV, dh, pos, window
    (3, 16, 16, 8, 2, 32, (0, 100, 255), 0),       # GQA 4:1, pos 0, cap - 1
    (2, 8, 16, 4, 4, 32, (64, 127), 0),            # MHA
    (2, 8, 16, 4, 1, 32, (31, 300), 0),            # MQA, pos past capacity
    (3, 8, 16, 8, 2, 16, (20, 128, 5000), 128),    # ring: not, at, far past
    (2, 4, 32, 4, 2, 16, (127, 128), 128),         # ring: the wrap boundary
]


@pytest.mark.parametrize("B,NB,block,H,KV,dh,pos,window", DECODE_SPLIT_CASES)
@pytest.mark.parametrize("plan", ["kernel", "one tile a split"])
def test_paged_decode_split_merge_matches_unsplit(B, NB, block, H, KV, dh,
                                                  pos, window, plan):
    """Paged decode as a span of one row: partials over the splits, merged
    by the kernel's rule, equal the unsplit plain version in float32, ring
    rule included (the kernel's fence min(pos, NB·block − 1))."""
    q, kp, vp, p, bt = map(torch.as_tensor, paged_inputs(
        15, B, NB, block, H, KV, dh, pos, unallocated=not window))
    tiles = -(-NB * block // dk.KEY_TILE)
    splits, tps = dk.decode_splits(NB * block, B * KV) \
        if plan == "kernel" else (tiles, 1)
    m, l, acc, live = dk.verify_partials_ref(q[:, None], kp, vp, p, bt,
                                             splits, tps)
    got = dk.merge_partials_ref(m, l, acc, live, 1)[:, 0]
    want = dk.paged_decode_attention_ref(q, kp, vp, p, bt, window=window)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    if plan != "kernel":
        assert (live == (p.clamp(max=NB * block - 1) // 64 + 1)).all()


@pytest.mark.parametrize("B,S,H,KV,dh,pos,window", [
    (3, 300, 8, 2, 32, (0, 150, 299), 0),          # ragged S, GQA 4:1
    (2, 128, 4, 4, 32, (63, 64), 0),               # MHA, a tile boundary
    (2, 100, 4, 1, 32, (99, 700), 0),              # MQA, pos past S
    (3, 200, 8, 2, 16, (40, 200, 4000), 200),      # ring: not, at, far past
    (2, 8, 4, 2, 16, (3, 20), 8),                  # ring shorter than a tile
])
@pytest.mark.parametrize("plan", ["kernel", "one tile a split"])
def test_contiguous_decode_split_merge_matches_unsplit(B, S, H, KV, dh, pos,
                                                       window, plan):
    """The contiguous twin, over ragged S and rings shorter than a tile."""
    q, k, v, p = map(torch.as_tensor, decode_inputs(16, B, S, H, KV, dh, pos))
    tiles = -(-S // dk.KEY_TILE)
    splits, tps = dk.decode_splits(S, B * KV) if plan == "kernel" \
        else (tiles, 1)
    m, l, acc, live = dk.split_partials_ref(q[:, None], k, v, p, splits, tps)
    got = dk.merge_partials_ref(m, l, acc, live, 1)[:, 0]
    torch.testing.assert_close(
        got, dk.decode_attention_ref(q, k, v, p, window=window), rtol=1e-6,
        atol=1e-6)


@pytest.mark.parametrize("window,pos", [(0, (0, 70)), (128, (100, 300))])
def test_decode_split_merge_matches_pallas_kernels(window, pos):
    """The split-and-merge rule of both decode kernels against the
    reference's Pallas kernels in interpret mode, at tiny shapes with one
    tile a split: paged (block 16, GQA 4:1) and contiguous (S = 128, a
    multiple of min(256, S), as its wrapper asserts)."""
    q, kp, vp, p, bt = paged_inputs(17, 2, 8, 16, 4, 1, 16, pos,
                                    unallocated=not window)
    m, l, acc, live = dk.verify_partials_ref(
        *map(torch.as_tensor, (q[:, None], kp, vp, p, bt)), 2, 1)
    check(dk.merge_partials_ref(m, l, acc, live, 1)[:, 0],
          pallas_paged(*map(jnp.asarray, (q, kp, vp, p, bt)),
                       window=window, interpret=True))
    a = decode_inputs(18, 2, 128, 4, 2, 16, pos)
    m, l, acc, live = dk.split_partials_ref(
        torch.as_tensor(a[0])[:, None], *map(torch.as_tensor, a[1:]), 2, 1)
    check(dk.merge_partials_ref(m, l, acc, live, 1)[:, 0],
          pallas_decode(*map(jnp.asarray, a), window=window, block_k=64,
                        interpret=True))
