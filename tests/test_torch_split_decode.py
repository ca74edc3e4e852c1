"""The contiguous decode's log-sum-exp and the seam's decode over a cache
split along its sequence, on the CPU (float32, one torch thread).

``decode_attention_ref``, the plain version of the CUDA kernel
``decode_attention`` (port of ``repro/kernels/decode_attention.py:85``),
with ``return_lse``: its lse against ``torch.logsumexp`` of the masked,
scaled scores; the empty fence (pos < 0: a 0 row and lse −inf); and
``return_lse=False`` unchanged bit for bit. The seam's rule for a cache
split along its sequence (``kernels/ops.py``): each key range [s0, s1) run
with the fence min(pos, S − 1) − s0, −1 at least, window 0 and
``return_lse``, then combined by ``merge_key_ranges`` — over 2, 3 and 4
ranges, ragged ones, ranges wholly past pos, and a full ring with window
> 0 — against the unsplit plain version within 1e-6 (both are float32
sums of the same terms, a few ulps apart) and against the reference's
oracle (``repro/kernels/ref.py:38``) within 2e-5 (``test_torch_kernels``'
tolerance: the oracle repeats the KV heads and sums in another order).
The bf16 kernel's lse, taken in log2 units from its split partials, is
held the same way through the plain versions of its two passes, at a
device's shard of ``decode_32k``.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref  # noqa: E402
from repro_torch.kernels import decode_attention as dk  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

torch.set_num_threads(1)
EXACT = dict(rtol=1e-6, atol=1e-6)
ORACLE = dict(rtol=2e-5, atol=2e-5)


def _case(B, S, H, KV, dh, pos, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.as_tensor(rng.standard_normal(s), dtype=torch.float32)
               for s in ((B, H, dh), (B, S, KV, dh), (B, S, KV, dh)))
    return q, k, v, torch.tensor(pos, dtype=torch.int32)


def _stacked(t, op):
    return t.amax(0) if op == "max" else t.sum(0)


def _split_merge(q, k, v, pos, bounds):
    """The seam's rule over key ranges [bounds[i], bounds[i + 1])."""
    S = k.shape[1]
    outs, lses = [], []
    for s0, s1 in zip(bounds[:-1], bounds[1:]):
        fence = (pos.clamp(max=S - 1) - s0).clamp(min=-1)
        out, lse = ops.decode_attention(
            q, k[:, s0:s1].contiguous(), v[:, s0:s1].contiguous(), fence,
            return_lse=True)
        outs.append(out)
        lses.append(lse)
    return ops.merge_key_ranges(torch.stack(outs), torch.stack(lses),
                                _stacked)


@pytest.mark.parametrize("window", [0, 40])
def test_lse_is_the_logsumexp_of_the_masked_scaled_scores(window):
    B, S, H, KV, dh = 4, 40, 8, 2, 16
    q, k, v, pos = _case(B, S, H, KV, dh, [0, 17, 39, 90])
    out, lse = dk.decode_attention_ref(q, k, v, pos, window=window,
                                       return_lse=True)
    scores = torch.einsum("bhd,bshd->bhs", q,
                          k.repeat_interleave(H // KV, 2)) / math.sqrt(dh)
    live = torch.arange(S)[None, :] <= pos[:, None].long()
    if window:
        live |= pos[:, None].long() >= S
    want = torch.logsumexp(scores.masked_fill(~live[:, None], -math.inf), -1)
    torch.testing.assert_close(lse, want, **EXACT)
    assert lse.dtype == torch.float32 and lse.shape == (B, H)
    torch.testing.assert_close(out, dk.decode_attention_ref(
        q, k, v, pos, window=window), rtol=0, atol=0)


def test_empty_fence_gives_a_zero_row_and_minus_infinity():
    q, k, v, pos = _case(3, 24, 4, 2, 16, [-1, 5, -1])
    out, lse = dk.decode_attention_ref(q, k, v, pos, return_lse=True)
    assert torch.equal(out[[0, 2]], torch.zeros_like(out[[0, 2]]))
    assert torch.isneginf(lse[[0, 2]]).all()
    assert torch.isfinite(out).all() and torch.isfinite(lse[1]).all()
    assert out[1].abs().sum() > 0
    # the seam's entry on plain tensors takes the same rule
    got, got_lse = ops.decode_attention(q, k, v, pos, return_lse=True)
    assert torch.equal(got, out) and torch.equal(got_lse, lse)


@pytest.mark.parametrize("window", [0, 24])
def test_return_lse_false_is_unchanged_bit_for_bit(window):
    from repro_torch.models.attention import gqa_sdpa
    q, k, v, pos = _case(4, 24, 8, 2, 16, [0, 9, 23, 50])
    plain = dk.decode_attention_ref(q, k, v, pos, window=window)
    with_lse, _ = dk.decode_attention_ref(q, k, v, pos, window=window,
                                          return_lse=True)
    keys = torch.arange(24)[None, :]
    valid = keys <= pos.long()[:, None]
    if window:
        valid |= pos.long()[:, None] >= 24
    before = gqa_sdpa(q[:, None], k, v, valid[:, None, :])[:, 0]
    assert torch.equal(plain, before) and torch.equal(with_lse, before)
    assert torch.equal(ops.decode_attention(q, k, v, pos, window=window),
                       before)


# (S, window, positions, key-range bounds): ranges of the seam's even
# split, ragged ones, some wholly past pos (rows at 0 and 7 see one range),
# and a ring of S over 4 ranges with rows past it (every key live)
SPLITS = {
    "2 even": (48, 0, [0, 7, 23, 24, 47], [0, 24, 48]),
    "3 ragged": (48, 0, [0, 4, 5, 29, 47], [0, 5, 30, 48]),
    "4 even, some past pos": (64, 0, [0, 7, 16, 40, 63], [0, 16, 32, 48, 64]),
    "4 ragged": (50, 0, [1, 12, 13, 37, 49], [0, 13, 14, 38, 50]),
    "ring of 4, full": (32, 32, [3, 31, 32, 45, 200], [0, 8, 16, 24, 32]),
}


@pytest.mark.parametrize("name", sorted(SPLITS))
def test_split_and_merge_equals_the_unsplit_decode(name):
    S, window, pos, bounds = SPLITS[name]
    B, H, KV, dh = len(pos), 8, 2, 16
    q, k, v, pos_t = _case(B, S, H, KV, dh, pos, seed=len(bounds))
    got, got_lse = _split_merge(q, k, v, pos_t, bounds)
    want, want_lse = dk.decode_attention_ref(q, k, v, pos_t, window=window,
                                             return_lse=True)
    torch.testing.assert_close(got, want, **EXACT)
    torch.testing.assert_close(got_lse, want_lse, **EXACT)
    oracle = ref.decode_attention_ref(
        jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
        jnp.asarray(v.numpy()), jnp.asarray(pos_t.numpy()), window=window)
    torch.testing.assert_close(got, torch.as_tensor(np.array(oracle)),
                               **ORACLE)


def test_merge_of_ranges_that_all_see_no_key():
    out = torch.randn(3, 2, 4, 8)
    lse = torch.full((3, 2, 4), -math.inf)
    merged, merged_lse = ops.merge_key_ranges(out, lse, _stacked)
    assert torch.equal(merged, torch.zeros_like(merged))
    assert torch.isneginf(merged_lse).all()


def test_bf16_kernel_lse_rule_at_a_decode_32k_shard():
    """The bf16 kernel writes lse = (M + log2 Σ 2^(m_s − M)·l_s)·ln 2 from
    its split partials (m in log2 units; one split: its own m and l). Its
    plain passes at a device's shard of ``decode_32k`` (8 slots, 2048 keys,
    Qwen3-8B's 32/8 heads of 128: ``decode_splits`` cuts it into 6 splits
    of 6 key tiles, where the whole 32768-key row takes 6 of 102, so the
    two lse come from other merges), on the float32 values, against the
    plain version's lse; the empty fence (pos −1) keeps split 0 live with
    l = 0, so −inf."""
    B, S, H, KV, dh = 8, 2048, 32, 8, 128
    pos = [-1, 0, 63, 64, 700, 2047, 5000, 1500]
    q, k, v, pos_t = _case(B, S, H, KV, dh, pos)
    splits, tps = dk.decode_splits(S, B * KV)
    assert (splits, tps) == (6, 6)
    assert dk.decode_splits(32768, B * KV) == (6, 102)
    m, l, acc, live = dk.split_partials_ref(q[:, None], k, v, pos_t, splits,
                                            tps)
    dead = (torch.arange(splits)[None, :] >= live[:, None])[:, None, :, None]
    M = m.masked_fill(dead, -1e30).amax(2)
    den = (torch.exp2(m - M[:, :, None]) * l).masked_fill(dead, 0.0).sum(2)
    lse = torch.where(den > 0, (M + torch.log2(den)) * math.log(2),
                      torch.full_like(den, -math.inf)).reshape(B, H)
    out = dk.merge_partials_ref(m, l, acc, live, 1)[:, 0]
    want, want_lse = dk.decode_attention_ref(q, k, v, pos_t,
                                             return_lse=True)
    torch.testing.assert_close(lse, want_lse, **EXACT)
    torch.testing.assert_close(out, want, rtol=2e-5, atol=2e-5)
