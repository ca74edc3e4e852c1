"""The port's speculative decoding (n-gram drafts, one span verify per
decode-only step) against the JAX reference, on the float32 qwen3_8b
smoke config with the reference's weights carried across by
``repro_torch.weights``.

Units: the n-gram proposer, the greedy verify epilogue (exactly equal),
the verify attention's plain version against the Pallas kernel in
interpret mode and against paged decode at ``pos + j`` (float32, rtol =
atol = 2e-5: the two differ only in summation order and the blocked
online softmax), the verify attention layer (1e-5) and the model's
verify step (2e-5, as ``test_torch_model.py``). Pools are compared
outside scratch block 0, where idle slots and positions past the table
all write, and which duplicate write wins is undefined in both
frameworks.

The whole slice: the top-1 deployment over 2 expert pods with the paged
pool, chunked prefill and ``speculative="ngram"`` emits exactly the
reference's greedy tokens and finish reasons, and exactly its own tokens
with speculation off, with drafts accepted along the way.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import ckpt as jckpt  # noqa: E402
from repro.configs.base import get_smoke_config as jax_smoke  # noqa: E402
from repro.core.router import CentroidRouter as JaxRouter  # noqa: E402
from repro.core.router import RouterConfig as JaxRouterConfig  # noqa: E402
from repro.kernels.decode_attention import (  # noqa: E402
    paged_verify_attention as pallas_verify)
from repro.models import attention as jattn  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.serve import api as japi  # noqa: E402
from repro.serve.fused import verify_epilogue as jax_verify_epilogue  # noqa: E402
from repro.serve.scheduler import make_engine as jax_make_engine  # noqa: E402
from repro.serve.speculate import NGramProposer as JaxNGram  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.router import CentroidRouter  # noqa: E402
from repro_torch.kernels import decode_attention as dk  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serve.api import EngineConfig, SamplingParams  # noqa: E402
from repro_torch.serve.fused import verify_epilogue  # noqa: E402
from repro_torch.serve.scheduler import make_engine  # noqa: E402
from repro_torch.serve.speculate import NGramProposer  # noqa: E402
from repro_torch.weights import from_tree  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-5)
SPEC_LEN = 4
VOCAB = 256
ECFG = dict(n_slots=2, cache_len=40, paged=True, page_block=8,
            chunked_prefill=True, chunk=8, fused_step=True)
LENS = [7, 11, 5, 9, 13, 21, 6, 30]     # 30 + 12 passes cache_len: truncated


# ---------------------------------------------------------------------------
# The n-gram proposer
# ---------------------------------------------------------------------------

_RNG = np.random.default_rng(11)
HISTORIES = {
    "random": _RNG.integers(0, 6, 40).tolist(),
    "repetitive": np.tile([5, 9, 2, 7], 6).tolist(),
    "as_long_as_n": [3, 4],
    "shorter_than_n": [6],
    "empty": [],
    "no_match": [1, 2, 3, 4, 5, 6],
    "short_continuation": [5, 1, 2, 5, 1, 2],
    "latest_match_wins": [1, 2, 3, 7, 8, 9, 4, 5, 7, 8],
}


@pytest.mark.parametrize("name", sorted(HISTORIES))
@pytest.mark.parametrize("spec_len,n", [(4, 2), (6, 1), (3, 3)])
def test_ngram_proposer_matches_reference(name, spec_len, n):
    hist = HISTORIES[name]
    got = NGramProposer(spec_len, n).propose(hist)
    want = JaxNGram(spec_len, n).propose(hist)
    assert got.dtype == np.int32 and got.shape == (spec_len - 1,)
    np.testing.assert_array_equal(got, want)


def test_ngram_proposer_batch_and_guards():
    hists = [HISTORIES["random"], HISTORIES["no_match"]]
    np.testing.assert_array_equal(NGramProposer(4).propose_batch(hists),
                                  JaxNGram(4).propose_batch(hists))
    assert NGramProposer(4).propose_batch([]).shape == (0, 3)
    with pytest.raises(ValueError, match="spec_len must be >= 2"):
        NGramProposer(1)
    with pytest.raises(ValueError, match="n-gram length"):
        NGramProposer(4, n=0)


# ---------------------------------------------------------------------------
# The greedy verify epilogue
# ---------------------------------------------------------------------------

def _epilogue_case(case: str, offset: int):
    """Scores, drafts and greedy state of 4 slots (L = 4, V = 16) for one
    case; drafts follow the greedy trajectory (full accept) unless the
    case says otherwise."""
    B, L, V = 4, SPEC_LEN, 16
    rng = np.random.default_rng(offset + 7 * len(case))
    scores = rng.normal(size=(B, L, V)).astype(np.float32)
    true = scores.argmax(-1).astype(np.int32)
    drafts = true[:, :L - 1].copy()
    st = {"tok": rng.integers(0, V, B).astype(np.int32),
          "pos": np.full(B, 10, np.int32),
          "active": np.ones(B, bool),
          "counts": np.full(B, 3, np.int32),
          "max_new": np.full(B, 100, np.int32),
          "stop_ids": np.full((B, 2), -1, np.int32)}
    if case == "accept_reject":
        drafts[1] = (true[1, :L - 1] + 1) % V          # all reject
        drafts[2, 1] = (true[2, 1] + 1) % V            # accept 1 of 3
        drafts[3, 2] = (true[3, 2] + 1) % V            # accept 2 of 3
    elif case == "stop":
        st["stop_ids"][:, 0] = true[:, offset]
        drafts[3, 0] = (true[3, 0] + 1) % V            # stop past the run
    elif case == "length":
        st["max_new"][:] = st["counts"] + 1 + offset
        st["max_new"][2] += L                          # budget not reached
    elif case == "truncated":
        st["pos"][:] = 40 - 1 - offset                 # cache_len 40
        st["pos"][1] = 5
        st["stop_ids"][0, 1] = true[0, offset]         # stop beats trunc.
    elif case == "inactive":
        st["active"][[0, 2]] = False
        st["tok"][[0, 2]] = 0
        st["pos"][[0, 2]] = 0
    return scores, drafts, st


@pytest.mark.parametrize("case,offset", [
    ("accept_reject", 0), ("inactive", 0),
    *[(c, j) for c in ("stop", "length", "truncated")
      for j in range(SPEC_LEN)]])
def test_verify_epilogue_matches_reference(case, offset):
    scores, drafts, st = _epilogue_case(case, offset)
    B = scores.shape[0]
    tstate = {k: torch.as_tensor(v) for k, v in st.items()}
    new, toks, n_emit, done = verify_epilogue(
        torch.as_tensor(scores), torch.as_tensor(drafts), tstate,
        cache_len=40)
    jstate = {k: jnp.asarray(v) for k, v in st.items()}
    jstate.update(temps=jnp.zeros(B, jnp.float32),
                  top_ks=jnp.zeros(B, jnp.int32),
                  seeds=jnp.zeros(B, jnp.uint32))
    jnew, jtoks, jn, jdone = jax_verify_epilogue(
        jnp.asarray(scores), jnp.asarray(drafts), jstate, cache_len=40)
    for got, want in ((toks, jtoks), (n_emit, jn), (done, jdone),
                      *((new[k], jnew[k]) for k in
                        ("tok", "pos", "counts", "active"))):
        assert got.dtype in (torch.int32, torch.bool)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if case == "accept_reject":
        assert n_emit.tolist() == [SPEC_LEN, 1, 2, 3]
    if case in ("stop", "length"):
        true = scores.argmax(-1)[0].tolist()
        first = true.index(true[offset]) if case == "stop" else offset
        assert done[0].item() == (1 if case == "stop" else 2)
        assert n_emit[0].item() == first + 1


# ---------------------------------------------------------------------------
# The verify attention: plain version, layer
# ---------------------------------------------------------------------------

def verify_inputs(seed, B, NB, block, H, KV, dh, L, pos=None):
    rng = np.random.default_rng(seed)
    P = B * NB + 3
    q = rng.normal(size=(B, L, H, dh)).astype(np.float32)
    kp, vp = (rng.normal(size=(P, block, KV, dh)).astype(np.float32)
              for _ in range(2))
    bt = rng.permutation(np.arange(1, P))[:B * NB].reshape(B, NB) \
        .astype(np.int32)
    if pos is None:            # the span fits the table
        pos = rng.integers(0, NB * block - L + 1, B)
    return q, kp, vp, np.asarray(pos, np.int32), bt


@pytest.mark.parametrize("B,NB,block,H,KV,dh,L", [
    (2, 4, 16, 4, 4, 64, 3),     # MHA
    (3, 8, 16, 8, 2, 64, 4),     # GQA 4:1
])
def test_verify_plain_matches_pallas_and_decode(B, NB, block, H, KV, dh, L):
    """Against the Pallas kernel (interpret mode), and row j against the
    port's paged decode plain version at pos + j."""
    q, kp, vp, pos, bt = verify_inputs(0, B, NB, block, H, KV, dh, L)
    got = dk.paged_verify_attention_ref(
        *map(torch.as_tensor, (q, kp, vp, pos, bt)))
    assert got.shape == (B, L, H, dh)
    want = pallas_verify(*map(jnp.asarray, (q, kp, vp, pos, bt)),
                         interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for j in range(L):
        row = dk.paged_decode_attention_ref(
            *map(torch.as_tensor, (q[:, j], kp, vp, pos + j, bt)))
        np.testing.assert_allclose(got[:, j].numpy(), row.numpy(), **TOL)


def test_verify_plain_span_across_table_horizon():
    """pos + l past NB·block: those rows see exactly the table's NB blocks,
    as paged decode does at the same position; the Pallas kernel agrees."""
    B, NB, block, H, KV, dh, L = 3, 4, 16, 8, 2, 64, 4
    pos = [NB * block - 2, NB * block - 1, 5]
    q, kp, vp, pos, bt = verify_inputs(1, B, NB, block, H, KV, dh, L, pos)
    got = dk.paged_verify_attention_ref(
        *map(torch.as_tensor, (q, kp, vp, pos, bt)))
    for j in range(L):
        row = dk.paged_decode_attention_ref(
            *map(torch.as_tensor, (q[:, j], kp, vp, pos + j, bt)))
        np.testing.assert_allclose(got[:, j].numpy(), row.numpy(), **TOL)
    want = pallas_verify(*map(jnp.asarray, (q, kp, vp, pos, bt)),
                         interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.fixture(scope="module")
def models():
    jcfg = jax_smoke("qwen3_8b").reduced(vocab=VOCAB)
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(3))
    tm = build_model(get_smoke_config("qwen3_8b").reduced(vocab=VOCAB))
    return jm, jp, tm, from_tree(jax.tree.map(np.asarray, jp))


def _pool_case(cfg, seed, layers=None):
    """A random pool of 13 blocks of 8, 3 slots with 4-column tables: slot
    0 mid-span, slot 1 spanning past the table horizon (its last
    positions write scratch block 0), slot 2 inactive (pos 0, zero
    table)."""
    rng = np.random.default_rng(seed)
    shape = (13, 8, cfg.n_kv_heads, cfg.head_dim)
    if layers:
        shape = (layers,) + shape
    kp, vp = (rng.normal(size=shape).astype(np.float32) for _ in range(2))
    bt = np.array([[3, 7, 1, 9], [2, 4, 6, 12], [0, 0, 0, 0]], np.int32)
    pos = np.array([13, 30, 0], np.int32)
    return kp, vp, pos, bt


def test_verify_attention_layer_matches_reference(models):
    jm, jp, tm, tp = models
    cfg = tm.cfg
    kp, vp, pos, bt = _pool_case(cfg, 4)
    x = np.random.default_rng(5).normal(
        size=(3, SPEC_LEN, cfg.d_model)).astype(np.float32)
    jlayer = jax.tree.map(lambda a: a[0], jp["blocks"]["attn"])
    tlayer = {k: v[0] for k, v in tp["blocks"]["attn"].items()}
    out, (k2, v2) = tattn.paged_verify_attention(
        tlayer, torch.as_tensor(x), cfg,
        (torch.tensor(kp), torch.tensor(vp)), torch.as_tensor(pos),
        torch.as_tensor(bt))
    jout, (jk, jv) = jattn.paged_verify_attention(
        jlayer, jnp.asarray(x), jm.cfg, (jnp.asarray(kp), jnp.asarray(vp)),
        jnp.asarray(pos), jnp.asarray(bt))
    live = [0, 1]               # the inactive slot reads scratch block 0
    np.testing.assert_allclose(out.numpy()[live], np.asarray(jout)[live],
                               rtol=1e-5, atol=1e-5)
    for got, want in ((k2, jk), (v2, jv)):
        np.testing.assert_allclose(got.numpy()[1:], np.asarray(want)[1:],
                                   rtol=1e-5, atol=1e-5)
    # the span's K/V landed at its positions: slot 0 writes 13..16,
    # blocks 7 (13..15) and 1 (16); slot 1 writes 30, 31 in block 12
    assert not np.allclose(k2.numpy()[7, 5:], kp[7, 5:])
    assert not np.allclose(k2.numpy()[12, 6:], kp[12, 6:])
    np.testing.assert_array_equal(k2.numpy()[9], kp[9])


def test_verify_step_paged_matches_reference(models):
    jm, jp, tm, tp = models
    cfg = tm.cfg
    kp, vp, pos, bt = _pool_case(cfg, 6, layers=cfg.n_layers)
    toks = np.random.default_rng(7).integers(0, VOCAB, (3, SPEC_LEN)) \
        .astype(np.int32)
    logits, cache = tm.verify_step_paged(
        tp, {"k": torch.tensor(kp), "v": torch.tensor(vp)},
        torch.as_tensor(toks), torch.as_tensor(pos), torch.as_tensor(bt))
    jlogits, jcache = jm.verify_step_paged(
        jp, {"k": jnp.asarray(kp), "v": jnp.asarray(vp)}, jnp.asarray(toks),
        jnp.asarray(pos), jnp.asarray(bt))
    assert logits.shape == (3, SPEC_LEN, VOCAB)
    np.testing.assert_allclose(logits.numpy()[:2], np.asarray(jlogits)[:2],
                               **TOL)
    for leaf in ("k", "v"):
        np.testing.assert_allclose(cache[leaf].numpy()[:, 1:],
                                   np.asarray(jcache[leaf])[:, 1:], **TOL)


def test_windowed_model_cannot_verify():
    cfg = get_smoke_config("qwen3_8b").reduced(sliding_window=8)
    model = build_model(cfg)
    assert not model.speculative_capable
    assert build_model(get_smoke_config("qwen3_8b")).speculative_capable
    with pytest.raises(ValueError, match="cannot verify speculative spans"):
        model.verify_step_paged(None, None, None, None, None)


# ---------------------------------------------------------------------------
# The whole slice: top-1, paged + chunked + n-gram speculation
# ---------------------------------------------------------------------------

def _repetitive_prompts(rng, lens):
    """Period-4 prompts (the workload n-gram lookup targets)."""
    out = []
    for n in lens:
        base = rng.integers(1, VOCAB, size=4)
        out.append(np.tile(base, n // 4 + 2)[:n].astype(np.int32))
    return out


@pytest.fixture(scope="module")
def deployment(models):
    jm, _, tm, _ = models
    jexperts = [jm.init(jax.random.PRNGKey(k)) for k in (0, 1)]
    texperts = [from_tree(jax.tree.map(np.asarray, p)) for p in jexperts]
    rng = np.random.default_rng(0)
    cent = rng.normal(size=(2, 32)).astype(np.float32)
    prompts = _repetitive_prompts(rng, LENS)
    feats = rng.normal(size=(len(LENS), 32)).astype(np.float32)
    return jm, jexperts, tm, texperts, cent, prompts, feats


def _drive(engine, sp_cls, prompts, feats, stops, max_new=12):
    for i, p in enumerate(prompts):
        engine.add_request(p, sp_cls(max_new=max_new,
                                     stop_token_ids=stops.get(i, ())),
                           features=feats[i], rid=i)
    routing = [[r.rid for r in pod.waiting] for pod in engine.pods]
    res = {}
    while engine.has_unfinished():
        for o in engine.step():
            if o.finished:
                res[o.rid] = (o.token_ids, o.finish_reason)
    return res, routing


def _port_engine(deployment, **over):
    _, _, tm, texperts, cent, _, _ = deployment
    return make_engine(tm, experts=texperts,
                       router=CentroidRouter(torch.as_tensor(cent)),
                       config=EngineConfig(**dict(ECFG, **over)),
                       device="cpu")


def _spec_totals(engine):
    st = engine.occupancy()
    return (sum(p["spec_steps"] for p in st),
            sum(p["spec_tokens"] for p in st))


def _counting(engine, method):
    """Wrap ``method`` of every pod to count its calls; returns the count
    box."""
    box = [0]
    for pod in engine.pods:
        fn = getattr(pod, method)

        def run(*a, fn=fn, **kw):
            box[0] += 1
            return fn(*a, **kw)
        setattr(pod, method, run)
    return box


def test_spec_slice_matches_reference_token_for_token(deployment):
    """Both packages with speculation on, and the port with it off, give
    the same tokens and finish reasons (stop, length and truncated among
    them); both pods serve; drafts are accepted."""
    jm, jexperts, _, _, cent, prompts, feats = deployment
    free, _ = _drive(_port_engine(deployment), SamplingParams, prompts,
                     feats, {})
    stops = {1: (free[1][0][5],), 3: (free[3][0][0],)}
    vanilla, _ = _drive(_port_engine(deployment), SamplingParams, prompts,
                        feats, stops)
    eng = _port_engine(deployment, speculative="ngram", spec_len=SPEC_LEN)
    got, got_route = _drive(eng, SamplingParams, prompts, feats, stops)
    jeng = jax_make_engine(
        jm, experts=jexperts,
        router=JaxRouter(jnp.asarray(cent), JaxRouterConfig()),
        config=japi.EngineConfig(**ECFG, speculative="ngram",
                                 spec_len=SPEC_LEN, use_kernel=False))
    want, want_route = _drive(jeng, japi.SamplingParams, prompts, feats,
                              stops)
    assert got_route == want_route and all(got_route)
    assert got == want
    assert got == vanilla
    assert {"stop", "length", "truncated"} <= {r for _, r in got.values()}
    steps, toks = _spec_totals(eng)
    jst = [p.stats() for p in jeng.pods]
    assert (steps, toks) == (sum(p["spec_steps"] for p in jst),
                             sum(p["spec_tokens"] for p in jst))
    assert steps > 0 and toks > steps        # some drafts were accepted
    for pod in eng.pods:                     # every block back on the list
        assert pod.allocator.n_free == pod.allocator.n_blocks - 1


def test_spec_len_one_is_vanilla(deployment):
    prompts, feats = deployment[5], deployment[6]
    vanilla, _ = _drive(_port_engine(deployment), SamplingParams, prompts,
                        feats, {})
    eng = _port_engine(deployment, speculative="ngram", spec_len=1)
    got, _ = _drive(eng, SamplingParams, prompts, feats, {})
    assert got == vanilla
    assert not any(pod._can_spec for pod in eng.pods)
    assert _spec_totals(eng) == (0, 0)


def test_spec_under_chunked_co_scheduling(deployment):
    """Chunks ride beside decoding slots (those steps decode one vanilla
    token), speculation engages on the decode-only steps, and a tight
    token budget that delays the chunks changes no token."""
    prompts, feats = deployment[5], deployment[6]
    for budget in (0, 9):
        vanilla, _ = _drive(_port_engine(deployment, token_budget=budget),
                            SamplingParams, prompts, feats, {})
        eng = _port_engine(deployment, token_budget=budget,
                           speculative="ngram", spec_len=SPEC_LEN)
        mixed = _counting(eng, "_run_fused_chunk")
        got, _ = _drive(eng, SamplingParams, prompts, feats, {})
        assert got == vanilla
        assert mixed[0] > 0 and _spec_totals(eng)[0] > 0


def test_spec_pool_pressure_falls_back_to_vanilla(deployment):
    """One slot per pod over 3 usable blocks: a request of at most 24
    positions grows through them with vanilla steps, but a span near its
    end reaches a fourth block. Those steps take the vanilla one-token
    step, and the output is unchanged."""
    prompts, feats = deployment[5][:5], deployment[6]   # prompts <= 13
    over = dict(n_slots=1, pool_blocks=4)
    vanilla, _ = _drive(_port_engine(deployment, **over), SamplingParams,
                        prompts, feats, {})
    eng = _port_engine(deployment, speculative="ngram", spec_len=SPEC_LEN,
                       **over)
    fallback = _counting(eng, "_run_fused")
    got, _ = _drive(eng, SamplingParams, prompts, feats, {})
    assert got == vanilla
    assert fallback[0] > 0 and _spec_totals(eng)[0] > 0


@pytest.mark.parametrize("offset", range(SPEC_LEN))
def test_spec_stop_at_every_span_offset(deployment, offset):
    """Oracle drafts (the known greedy trajectory) make every span accept
    in full, so a stop token lands at span offset ``offset``: the request
    keeps exactly the tokens up to the stop and retires once."""
    _, _, tm, texperts, _, prompts, _ = deployment
    cfg = dict(ECFG, speculative="ngram", spec_len=SPEC_LEN)

    def serve(eng, stops=()):
        eng.add_request(prompts[0], SamplingParams(max_new=16,
                                                   stop_token_ids=stops))
        out = None
        while eng.has_unfinished():
            for o in eng.step():
                if o.finished:
                    out = (o.token_ids, o.finish_reason)
        return out

    traj, _ = serve(make_engine(tm, texperts[0], device="cpu",
                                config=EngineConfig(**ECFG)))
    # token 0 is the prefill pick; the first span covers traj[1..L]
    stop_id = traj[1 + offset]
    want = traj[:traj.index(stop_id) + 1]
    eng = make_engine(tm, texperts[0], device="cpu",
                      config=EngineConfig(**cfg))

    def oracle(dec):
        drafts = np.zeros((eng.n_slots, SPEC_LEN - 1), np.int32)
        for s in dec:
            fut = traj[len(eng.slot_req[s].out):][:SPEC_LEN - 1]
            drafts[s, :len(fut)] = fut
        return torch.as_tensor(drafts)
    eng._draft_tokens = oracle
    assert serve(eng, (stop_id,)) == (want, "stop")
    st = eng.stats()
    assert st["stopped"] == 1
    if len(want) > 1:
        assert st["spec_steps"] > 0


def test_windowed_config_degrades_to_vanilla(deployment):
    """Sliding-window (ring) caches cannot roll a span back: the engine
    serves them with vanilla decode, silently, and the same tokens."""
    _, _, _, texperts, cent, prompts, feats = deployment
    model = build_model(get_smoke_config("qwen3_8b").reduced(
        vocab=VOCAB, sliding_window=16))
    res = []
    for spec in (None, "ngram"):
        eng = make_engine(model, experts=texperts,
                          router=CentroidRouter(torch.as_tensor(cent)),
                          config=EngineConfig(n_slots=2, cache_len=40,
                                              paged=True, page_block=8,
                                              speculative=spec),
                          device="cpu")
        res.append(_drive(eng, SamplingParams, prompts[:4], feats, {})[0])
    assert res[0] == res[1]
    assert not any(pod._can_spec for pod in eng.pods)
    assert _spec_totals(eng) == (0, 0)


@pytest.mark.parametrize("over", [
    dict(speculative="bogus"),
    dict(speculative="ngram", paged=False, chunked_prefill=False),
    dict(speculative="ngram", fused_step=False),
    dict(speculative="expert"),
    dict(speculative="ngram", spec_len=0),
])
def test_validate_speculative_errors_match_reference(over):
    with pytest.raises(ValueError) as want:
        japi.EngineConfig(**dict(ECFG, **over)).validate()
    with pytest.raises(ValueError) as got:
        EngineConfig(**dict(ECFG, **over)).validate()
    assert str(got.value) == str(want.value)


def test_validate_serves_ngram_and_refuses_expert_drafting():
    """n-gram drafting is served under both strategies and expert drafting
    under the mixture; expert drafting under top-1 (no expert stack to
    draft from) is refused with the reference's message."""
    EngineConfig(**dict(ECFG, speculative="ngram")).validate()
    EngineConfig(**dict(ECFG, speculative="ngram", spec_len=1)).validate()
    for drafter in ("ngram", "expert"):
        cfg = dict(ECFG, speculative=drafter, strategy="mixture")
        japi.EngineConfig(**cfg).validate()
        EngineConfig(**cfg).validate()
    cfg = dict(ECFG, speculative="expert", strategy="top1")
    with pytest.raises(ValueError) as want:
        japi.EngineConfig(**cfg).validate()
    with pytest.raises(ValueError) as got:
        EngineConfig(**cfg).validate()
    assert str(got.value) == str(want.value)


def test_launcher_twin_speculates_with_the_same_tokens(tmp_path, models):
    jm, jp, _, _ = models
    for k in range(2):
        jckpt.save_expert(str(tmp_path), k, 1,
                          {"params": jm.init(jax.random.PRNGKey(k))})
    jckpt.save_router(str(tmp_path), np.random.default_rng(0).normal(
        size=(2, 32)).astype(np.float32), 10.0, 1)
    base = ["--run", str(tmp_path), "--requests", "3", "--prompt-len", "10",
            "--new-tokens", "8", "--slots", "2", "--device", "cpu",
            "--vocab", str(VOCAB), "--paged", "--page-block", "8",
            "--chunked-prefill", "--prefill-chunk", "8"]
    plain = launch_serve.main(base)
    spec = launch_serve.main(base + ["--speculative", "ngram",
                                     "--spec-len", "4"])
    assert spec["tokens"] == plain["tokens"]
    assert spec["spec"]["spec_steps"] > 0
    assert "spec" not in plain


def test_profile_script_counts_spec_verify_steps():
    """``launch/profile_serve.py --speculative --smoke --device cpu``: the
    decode-only steps of the speculative main path are ``spec_verify``
    steps, profiled in a window of their own; every step is counted."""
    from repro_torch.launch import profile_serve
    rep = profile_serve.main(["--smoke", "--device", "cpu",
                              "--speculative"])
    kinds = rep["steps_by_kind"]
    assert sum(kinds.values()) == rep["steps"]
    assert kinds["spec_verify"] > 0 and kinds["decode"] == 0
    for kind in ("mixed", "spec_verify"):
        assert rep["windows"][kind]["kinds"] == [kind] * profile_serve.WINDOW
