"""The port's dense model (chunked and monolithic prefill, paged and
contiguous decode, the cache splices) and fused epilogue against the JAX
reference, on the float32 qwen3_8b smoke config with the reference's
weights carried across by ``repro_torch.weights``.

Logits and pools are compared at rtol = atol = 2e-5: both sides run the
same float32 arithmetic through two layers, and differ only in summation
order. Pools are compared outside scratch block 0, where padded chunk rows
and idle decode slots all write (block 0, offset 0) and which duplicate
write wins is undefined in both frameworks.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.serve.fused import decode_epilogue as jax_epilogue  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serve.fused import (DONE_REASONS, argmax_tokens,  # noqa: E402
                                     decode_epilogue, pick_first)
from repro_torch.weights import from_tree  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(scope="module")
def models():
    jm = jax_build(jax_smoke("qwen3_8b"))
    jp = jm.init(jax.random.PRNGKey(3))
    return jm, jp, build_model(get_smoke_config("qwen3_8b")), \
        from_tree(jax.tree.map(np.asarray, jp))


def close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def close_caches(cache, jcache):
    for leaf in ("k", "v"):
        close(cache[leaf], jcache[leaf])


def close_pools(cache, jcache):
    for leaf in ("k", "v"):
        np.testing.assert_allclose(cache[leaf][:, 1:].numpy(),
                                   np.asarray(jcache[leaf])[:, 1:], **TOL)


def test_prefill_chunks_then_decode_match_reference(models):
    """A 13-token prompt in chunks of 8 (the second padded) over a block
    table, then decode steps of one live slot beside an idle one, growing
    the table across a block boundary: per-step logits and the pool after
    prefill and after every decode step."""
    jm, jp, tm, tp = models
    cfg = tm.cfg
    P, block, NB, C = 7, 8, 4, 8
    cache = tm.init_paged_cache(2, P, block, NB * block, device="cpu")
    jcache = jm.init_paged_cache(2, P, block, NB * block)
    prompt = np.random.default_rng(0).integers(0, cfg.vocab, 13) \
        .astype(np.int32)
    padded = np.concatenate([prompt, np.zeros(3, np.int32)])[None]
    x = tm.embed_prompt(tp, {"tokens": torch.as_tensor(padded).long()})
    jx = jm.embed_prompt(jp, {"tokens": jnp.asarray(padded)})
    close(x, jx)
    table = np.array([2, 4, 0, 0], np.int32)
    carry = tm.init_chunk_carry(tp, None, NB * block)
    jcarry = jm.init_chunk_carry(jp, None, NB * block)
    for start in (0, 8):
        length = min(C, 13 - start)
        logits, carry, cache = tm.prefill_chunk(
            tp, cache, carry, x[:, start:start + C], start, length,
            torch.as_tensor(table))
        jlogits, jcarry, jcache = jm.prefill_chunk(
            jp, jcache, jcarry, jx[:, start:start + C], jnp.int32(start),
            jnp.int32(length), jnp.asarray(table))
        close(logits, jlogits)
    close_pools(cache, jcache)

    tok = int(argmax_tokens(logits)[0])
    assert tok == int(jnp.argmax(jlogits[0]))
    tables = np.zeros((2, NB), np.int32)
    tables[0] = [2, 4, 5, 0]                    # block 5 for positions 16..23
    for pos in range(13, 19):
        nbl = pos // block + 1
        toks = np.array([tok, 0], np.int32)
        pos_v = np.array([pos, 0], np.int32)
        logits, cache = tm.decode_step_paged(
            tp, cache, torch.as_tensor(toks), torch.as_tensor(pos_v),
            torch.as_tensor(np.ascontiguousarray(tables[:, :nbl])))
        jlogits, jcache = jm.decode_step_paged(
            jp, jcache, jnp.asarray(toks), jnp.asarray(pos_v),
            jnp.asarray(tables[:, :nbl]))
        close(logits[0], jlogits[0])
        close_pools(cache, jcache)
        tok = int(argmax_tokens(logits)[0])
        assert tok == int(jnp.argmax(jlogits[0]))


@pytest.mark.parametrize("window", [0, 8])
def test_prefill_then_contiguous_decode_match_reference(models, window):
    """Monolithic prefill of a 13-token prompt (logits and the row cache:
    right-padded, or with a window of 8 the last 8 positions rolled into
    the ring), its splice into slot 0 of a 2-slot contiguous cache, then
    decode steps of slot 0 beside an idle slot 1 (parked at position 0,
    which writes its own row, as in the reference; with the window the
    ring wraps): per-step logits and the whole cache after every step."""
    jm, jp, tm, tp = models
    jm = jax_build(jm.cfg.reduced(sliding_window=window))
    tm = build_model(tm.cfg.reduced(sliding_window=window))
    cache_len = 24
    prompt = np.random.default_rng(1).integers(0, tm.cfg.vocab, 13) \
        .astype(np.int32)
    logits, row = tm.prefill(tp, {"tokens": torch.as_tensor(prompt[None])
                                  .long()}, cache_len)
    jlogits, jrow = jm.prefill(jp, {"tokens": jnp.asarray(prompt[None])},
                               cache_len)
    close(logits, jlogits)
    close_caches(row, jrow)
    assert row["k"].shape == (tm.n_groups, 1, window or cache_len,
                              tm.cfg.n_kv_heads, tm.cfg.head_dim)
    cache = tm.cache_spec().insert(
        tm.init_cache(2, cache_len, device="cpu"), row, 0)
    jcache = jm.cache_spec().insert(jm.init_cache(2, cache_len), jrow, 0)
    close_caches(cache, jcache)
    tok = int(argmax_tokens(logits[:, -1])[0])
    for pos in range(13, 19):
        toks = np.array([tok, 0], np.int32)
        pos_v = np.array([pos, 0], np.int32)
        logits, cache = tm.decode_step(tp, cache, torch.as_tensor(toks),
                                       torch.as_tensor(pos_v))
        jlogits, jcache = jm.decode_step(jp, jcache, jnp.asarray(toks),
                                         jnp.asarray(pos_v))
        close(logits, jlogits)
        close_caches(cache, jcache)
        tok = int(argmax_tokens(logits)[0])
        assert tok == int(jnp.argmax(jlogits[0]))


def test_insert_paged_matches_reference(models):
    """A 20-position row cache spliced into 3 blocks of 8 (the last one
    part-filled, zero-padded) of a 6-block pool, and a contiguous splice
    into slot 1."""
    jm, _, tm, _ = models
    rng = np.random.default_rng(2)
    shape = (tm.n_groups, 1, 20, tm.cfg.n_kv_heads, tm.cfg.head_dim)
    row = {k: rng.normal(size=shape).astype(np.float32) for k in "kv"}
    trow = {k: torch.as_tensor(v) for k, v in row.items()}
    jrow = {k: jnp.asarray(v) for k, v in row.items()}
    blocks = np.array([4, 1, 3], np.int32)
    pool = tm.cache_spec(8).insert_paged(
        tm.init_paged_cache(2, 6, 8, 20, device="cpu"), trow, 0,
        torch.as_tensor(blocks))
    jpool = jm.cache_spec(8).insert_paged(jm.init_paged_cache(2, 6, 8, 20),
                                          jrow, 0, jnp.asarray(blocks))
    close_caches(pool, jpool)
    flat = tm.cache_spec(0).insert(tm.init_cache(2, 20, device="cpu"), trow,
                                   1)
    jflat = jm.cache_spec().insert(jm.init_cache(2, 20), jrow, 1)
    close_caches(flat, jflat)


def _state(n, **kw):
    st = {"tok": np.zeros(n, np.int32), "pos": np.zeros(n, np.int32),
          "active": np.zeros(n, bool), "counts": np.zeros(n, np.int32),
          "max_new": np.full(n, 100, np.int32),
          "stop_ids": np.full((n, 2), -1, np.int32)}
    for k, v in kw.items():
        st[k] = np.asarray(v, st[k].dtype)
    return st


def _run_both(scores, st, cache_len):
    ts = {k: torch.as_tensor(v) for k, v in st.items()}
    new, nxt, done = decode_epilogue(torch.as_tensor(scores), ts,
                                     cache_len=cache_len)
    n = len(st["tok"])
    jst = dict({k: jnp.asarray(v) for k, v in st.items()},
               temps=jnp.zeros(n, jnp.float32),
               top_ks=jnp.zeros(n, jnp.int32),
               seeds=jnp.zeros(n, jnp.uint32))
    jnew, jnxt, jdone = jax_epilogue(jnp.asarray(scores), jst,
                                     cache_len=cache_len)
    np.testing.assert_array_equal(nxt.numpy(), np.asarray(jnxt))
    np.testing.assert_array_equal(done.numpy(), np.asarray(jdone))
    for k in ("tok", "pos", "counts", "active"):
        np.testing.assert_array_equal(new[k].numpy(), np.asarray(jnew[k]))
    return new, nxt.numpy(), done.numpy()


def test_epilogue_precedence_matches_reference():
    """stop > length > truncated, each gated on the slot being active; the
    bound is position-exact (pos == cache_len - 1 stays decodable)."""
    cache_len = 10
    scores = np.full((6, 8), -1.0, np.float32)
    picks = [5, 5, 3, 2, 2, 7]
    scores[np.arange(6), picks] = 1.0
    st = _state(
        6,
        tok=[1, 1, 1, 1, 1, 4],
        # row 0: stop + length + truncated → stop; row 1: length +
        # truncated → length; row 2: truncated; row 3: pos lands on
        # cache_len - 1, still decodable; row 4: plain; row 5: inactive
        pos=[9, 9, 9, 8, 3, 2],
        active=[1, 1, 1, 1, 1, 0],
        counts=[4, 4, 0, 0, 0, 0],
        max_new=[5, 5, 9, 9, 9, 9],
        stop_ids=[[5, -1], [6, -1], [-1, -1], [-1, -1], [-1, -1], [7, -1]])
    new, nxt, done = _run_both(scores, st, cache_len)
    assert [DONE_REASONS.get(int(d)) for d in done] == \
        ["stop", "length", "truncated", None, None, None]
    assert nxt.tolist() == [5, 5, 3, 2, 2, 4]          # inactive keeps tok
    assert new["pos"].tolist() == [0, 0, 0, 9, 4, 2]    # finished → parked
    assert new["active"].tolist() == [False] * 3 + [True, True, False]


def test_epilogue_ties_pick_first_index():
    scores = np.zeros((2, 5), np.float32)
    scores[0, [1, 3]] = 2.0
    _run_both(scores, _state(2, active=[1, 1]), 50)
    assert pick_first(torch.as_tensor(scores[:1])).tolist() == [1]
