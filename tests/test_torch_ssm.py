"""The port's ssm family (xLSTM: groups of mLSTM layers closed by one
sLSTM layer) against the JAX reference, on the float32 ``xlstm_125m``
smoke config (2 layers: one mLSTM, one sLSTM; D = 128, H = 4, dh = 64,
scan chunk 16) with the reference's weights carried across by
``repro_torch.weights``.

Units: the mLSTM block, its prefill state and its decode step, the sLSTM
scan from a carried state, and the model's prefill, chunk and decode
paths with their caches. Float32 on both sides. The mLSTM memories reach
~1e5 on these random weights and the sLSTM feeds back its own output, so
summation order reaches every later value: tensors are held at rtol
2e-5 and an atol of 2e-5 times the tensor's largest magnitude (as
``test_torch_hybrid.py``). The model's mLSTM memories are held at 1e-4
of their largest magnitude (measured 3.2e-5 after a chunk with a carried
state: the sums cancel) and the sLSTM states behind them at 1e-3 (measured
1.5e-4). The sLSTM's
``length`` freeze is exact: padded steps leave (c, n, m, h) bit for bit
as the unpadded run leaves them.

The fault of ``_validate_model`` (two of the reference's checks dropped,
``effective_page_block`` comparing a tuple with 0): the port's accepts,
refusals and messages equal the reference's over paged × chunked ×
preemption, and ``effective_page_block`` is 0 where the reference's is.

The whole slice: the top-1 deployment over 2 pods and the K = 2 Eq. 27
mixture (top_k 2) emit exactly the reference's tokens and finish reasons
in every paged × chunked combination, fused and unfused, greedy (and,
chunked, with sampled requests) — paging degrades to the direct path, so
the reference's tokens of a (strategy, chunked) pair serve all four of
its runs, and chunked ≡ monolithic.
"""
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_smoke_config as jax_smoke  # noqa: E402
from repro.core.router import CentroidRouter as JaxRouter  # noqa: E402
from repro.core.router import RouterConfig as JaxRouterConfig  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.serve import api as japi  # noqa: E402
from repro.serve.engine import ServeEngine as JaxServeEngine  # noqa: E402
from repro.serve.scheduler import make_engine as jax_make_engine  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.router import CentroidRouter, RouterConfig  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.serve import api  # noqa: E402
from repro_torch.serve.api import EngineConfig, SamplingParams  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.serve.scheduler import make_engine  # noqa: E402
from repro_torch.weights import from_tree  # noqa: E402

ARCH = "xlstm_125m"
CACHE_LEN = 40
FEAT = 16
# prompts straddle the 16-position scan chunk; 30 + 12 runs past cache_len
# (truncated); request 5's whole budget is its prefill token; the last
# fills the context
LENS = [5, 13, 19, 8, 30, 3, 16, CACHE_LEN]
CHUNKED = dict(chunked_prefill=True, chunk=16)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module, restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def f32(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def close_scaled(got, want, rel=2e-5):
    """rtol 2e-5, atol ``rel`` of the tensor's largest magnitude."""
    want = np.asarray(want)
    np.testing.assert_allclose(
        got.detach().numpy(), want, rtol=2e-5,
        atol=rel * max(np.abs(want).max(), 1.0))


@pytest.fixture(scope="module")
def models():
    jm = jax_build(jax_smoke(ARCH))
    jp = jm.init(jax.random.PRNGKey(3))
    return jm, jp, build_model(get_smoke_config(ARCH)), \
        from_tree(jax.tree.map(np.asarray, jp))


def _tensors(tree):
    return {k: torch.as_tensor(np.array(v)) for k, v in tree.items()}


def test_param_specs_and_flags_match_reference(models):
    jm, jp, tm, tp = models
    assert jax.tree.map(lambda t: tuple(t.shape), tp) == \
        jax.tree.map(lambda a: tuple(a.shape), jp)
    assert (tm.n_groups, tm.group_m) == (jm.n_groups, jm.group_m) == (1, 1)
    assert not tm.prefix_cacheable and not tm.speculative_capable


def test_mlstm_block_prefill_and_step_match_reference(models):
    """A 21-position block (a padded last scan chunk), its state, then
    three steps from it."""
    jm, jp, tm, tp = models
    cfg, jcfg = tm.cfg, jm.cfg
    jmp = jax.tree.map(lambda a: a[0, 0], jp["blocks"]["mlstm"])
    tmp = _tensors(jmp)
    x = f32(np.random.default_rng(8), 2, 21, cfg.d_model)
    close_scaled(tssm.mlstm_block(tmp, torch.as_tensor(x), cfg),
                 jssm.mlstm_block(jmp, jnp.asarray(x), jcfg))
    y, st = tssm.mlstm_prefill(tmp, torch.as_tensor(x), cfg)
    q, k, v, log_f, _ = jssm._mlstm_qkvg(jmp, jnp.asarray(x), jcfg)
    _, jst = jssm.chunked_linear_attention(
        q, k, jnp.concatenate([v, jnp.ones_like(v[..., :1])], -1), log_f,
        jcfg.ssm.chunk)
    close_scaled(st, jst)
    for t in range(3):
        xt = f32(np.random.default_rng(t), 2, 1, cfg.d_model)
        y, st = tssm.mlstm_step(tmp, torch.as_tensor(xt), cfg, st)
        jy, jst = jssm.mlstm_step(jmp, jnp.asarray(xt), jcfg, jst)
        close_scaled(y, jy)
        close_scaled(st, jst)


def test_slstm_scan_matches_reference_and_freezes_exactly(models):
    """From the initial state and from a carried one; then the ``length``
    freeze: 11 valid rows of a 16-row chunk leave the state exactly where
    the 11-row scan does, and the padded rows' outputs repeat the last h,
    as the reference's."""
    jm, jp, tm, tp = models
    cfg, jcfg = tm.cfg, jm.cfg
    jsp = jax.tree.map(lambda a: a[0], jp["blocks"]["slstm"])
    rng = np.random.default_rng(9)
    # the random init leaves r and b at zero: give them values
    jsp = dict(jsp, r_gates=jnp.asarray(f32(rng, *jsp["r_gates"].shape)),
               b_gates=jnp.asarray(f32(rng, *jsp["b_gates"].shape)))
    tsp = _tensors(jsp)
    x = f32(rng, 2, 16, cfg.d_model)
    y, st = tssm.slstm_scan(tsp, torch.as_tensor(x), cfg)
    jy, jst = jssm.slstm_scan(jsp, jnp.asarray(x), jcfg)
    close_scaled(y, jy)
    for a, b in zip(st, jst):
        close_scaled(a, b)
    y2, st2 = tssm.slstm_scan(tsp, torch.as_tensor(x), cfg, state=st,
                              length=11)
    jy2, jst2 = jssm.slstm_scan(jsp, jnp.asarray(x), jcfg, state=jst,
                                length=jnp.int32(11))
    close_scaled(y2, jy2)
    for a, b in zip(st2, jst2):
        close_scaled(a, b)
    y3, st3 = tssm.slstm_scan(tsp, torch.as_tensor(x[:, :11]), cfg,
                              state=st)
    for a, b in zip(st2, st3):
        assert torch.equal(a, b)
    assert torch.equal(y2[:, :11], y3)
    # the padded rows' outputs are the last valid h, projected again
    assert torch.equal(y2[:, 11:], y3[:, 10:11].expand(-1, 5, -1))


def close_cache(cache, jcache):
    close_scaled(cache["mlstm"], jcache["mlstm"], 1e-4)
    for a, b in zip(cache["slstm"], jcache["slstm"]):
        close_scaled(a, b, 1e-3)


def test_prefill_chunks_and_decode_match_reference(models):
    """Monolithic prefill (logits at every row, the cache); a 37-token
    prompt in chunks of 16 (the last padded) with the carry spliced into
    slot 1 of 2; then decode steps, contiguous and through the paged
    entry point, which takes the direct path."""
    jm, jp, tm, tp = models
    cfg = tm.cfg
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (1, 21)) \
        .astype(np.int32)
    logits, row = tm.prefill(tp, {"tokens": torch.as_tensor(toks).long()},
                             CACHE_LEN)
    jlogits, jrow = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, CACHE_LEN)
    close_scaled(logits, jlogits)
    close_cache(row, jrow)

    prompt = np.random.default_rng(0).integers(0, cfg.vocab, 37) \
        .astype(np.int32)
    padded = np.concatenate([prompt, np.zeros(11, np.int32)])[None]
    x = tm.embed_prompt(tp, {"tokens": torch.as_tensor(padded).long()})
    jx = jm.embed_prompt(jp, {"tokens": jnp.asarray(padded)})
    carry = tm.init_chunk_carry(tp, None, CACHE_LEN)
    jcarry = jm.init_chunk_carry(jp, None, CACHE_LEN)
    cache = tm.init_cache(2, CACHE_LEN, device="cpu")
    jcache = jm.init_cache(2, CACHE_LEN)
    table = torch.zeros((1,), dtype=torch.int32)
    for start in (0, 16, 32):
        length = min(16, 37 - start)
        logits, carry, cache = tm.prefill_chunk(
            tp, cache, carry, x[:, start:start + 16], start, length, table)
        jlogits, jcarry, jcache = jm.prefill_chunk(
            jp, jcache, jcarry, jx[:, start:start + 16], jnp.int32(start),
            jnp.int32(length), jnp.zeros((1,), jnp.int32))
        close_scaled(logits, jlogits)
        close_cache(carry, jcarry)
    cache = tm.cache_spec(8).insert_direct(cache, carry, 1)
    jcache = jm.cache_spec(8).insert_direct(jcache, jcarry, 1)
    close_cache(cache, jcache)
    tok = np.array([0, int(np.argmax(np.asarray(jlogits)[0]))], np.int32)
    for step in range(4):
        pos = np.array([0, 37 + step], np.int32)
        step_fn = tm.decode_step_paged if step % 2 else tm.decode_step
        args = (torch.zeros((2, 1), dtype=torch.int32),) if step % 2 else ()
        logits, cache = step_fn(tp, cache, torch.as_tensor(tok),
                                torch.as_tensor(pos), *args)
        jlogits, jcache = jm.decode_step(jp, jcache, jnp.asarray(tok),
                                         jnp.asarray(pos))
        close_scaled(logits, jlogits)
        close_cache(cache, jcache)
        tok = np.array([0, int(np.argmax(np.asarray(jlogits)[1]))],
                       np.int32)


def test_serve_engine_matches_reference(models):
    """The whole-batch engine on the ssm family: greedy and sampled."""
    jm, jp, tm, tp = models
    toks = np.random.default_rng(4).integers(0, 512, (3, 9)).astype(np.int32)
    for temp in (0.0, 0.8):
        want = JaxServeEngine(jm, 24).generate(
            jp, {"tokens": jnp.asarray(toks)},
            japi.SamplingParams(max_new=6, temperature=temp, seed=2))
        got = ServeEngine(tm, 24).generate(
            tp, {"tokens": torch.as_tensor(toks)},
            SamplingParams(max_new=6, temperature=temp, seed=2))
        assert got.numpy().tolist() == np.asarray(want).tolist()


# ---------------------------------------------------------------------------
# The fault: the validation checks
# ---------------------------------------------------------------------------

def test_validate_outcomes_and_messages_match_reference(models):
    """Over paged × chunked × preemption the port accepts what the
    reference accepts and refuses the rest with its messages; the parent
    tree refused the family outright, and would have refused the chunked
    direct path and accepted preemption on a family with no pool."""
    jm, _, tm, _ = models
    outcomes = []
    for paged, chunked, pre in itertools.product(
            (False, True), (False, True), ("off", "recompute", "swap")):
        cfg = dict(n_slots=2, cache_len=CACHE_LEN, paged=paged,
                   page_block=8, chunked_prefill=chunked, chunk=16,
                   preemption=pre)
        got, want = [], []
        for mod, model, out in ((japi, jm, want), (api, tm, got)):
            try:
                mod.EngineConfig(**cfg).validate(model)
                out.append("served")
            except ValueError as e:
                out.append(str(e))
        assert got == want, cfg
        outcomes.append(got[0])
    assert outcomes.count("served") == 4         # preemption off only
    assert sum("no pageable cache leaves" in o for o in outcomes) == 3
    assert not any("enable paging (page_block > 0)" in o
                   and "chunked prefill" in o for o in outcomes)
    assert api.effective_page_block(tm, 8) == \
        japi.effective_page_block(jm, 8) == 0
    # a chunk off the scan length is the reference's refusal too
    with pytest.raises(ValueError) as want:
        japi.EngineConfig(chunked_prefill=True, chunk=8).validate(jm)
    with pytest.raises(ValueError) as got:
        EngineConfig(chunked_prefill=True, chunk=8).validate(tm)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# The whole slice
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def deployment():
    jm = jax_build(jax_smoke(ARCH))
    jexperts = [jm.init(jax.random.PRNGKey(k)) for k in (0, 1)]
    rng = np.random.default_rng(12)
    cent = rng.normal(size=(2, FEAT)).astype(np.float32)
    prompts = [rng.integers(0, 512, n).astype(np.int32) for n in LENS]
    feats = rng.normal(size=(len(LENS), FEAT)).astype(np.float32)
    texperts = [from_tree(jax.tree.map(np.asarray, p)) for p in jexperts]
    return jm, jexperts, texperts, cent, prompts, feats


def _drive(engine, sp_cls, prompts, feats, sampled):
    # request 5's whole budget is its prefill token; sampled, the even
    # requests draw at temperature 0.8 (top_k 0 and 40)
    for i, p in enumerate(prompts):
        samp = dict(temperature=0.8, top_k=40 * (i % 4 == 2), seed=9 + i) \
            if sampled and i % 2 == 0 else {}
        engine.add_request(p, sp_cls(max_new=1 if i == 5 else 12, **samp),
                           features=feats[i], rid=i)
    res = {}
    while engine.has_unfinished():
        for o in engine.step():
            if o.finished:
                res[o.rid] = (o.token_ids, o.finish_reason)
    return res


def _ecfg(strategy, chunked, paged=True, fused=True):
    return dict(n_slots=2, cache_len=CACHE_LEN, paged=paged, page_block=8,
                strategy=strategy, fused_step=fused,
                **(CHUNKED if chunked else {}))


@pytest.fixture(scope="module")
def reference_runs(deployment):
    """The reference's tokens for each (strategy, chunked, sampled), from
    its paged fused run."""
    jm, jexperts, _, cent, prompts, feats = deployment
    runs = {}
    for strategy, chunked in itertools.product(("top1", "mixture"),
                                               (False, True)):
        router = JaxRouter(jnp.asarray(cent), JaxRouterConfig(
            top_k=2 if strategy == "mixture" else 1))
        for sampled in (False, True)[:1 + chunked]:
            eng = jax_make_engine(jm, experts=jexperts, router=router,
                                  config=japi.EngineConfig(
                                      **_ecfg(strategy, chunked)))
            runs[strategy, chunked, sampled] = _drive(
                eng, japi.SamplingParams, prompts, feats, sampled)
    return runs


@pytest.mark.parametrize("strategy", ["top1", "mixture"])
def test_ssm_slice_matches_reference_token_for_token(deployment,
                                                     reference_runs,
                                                     strategy):
    """Every paged × chunked × fused combination, greedy and sampled."""
    _, _, texperts, cent, prompts, feats = deployment
    router = CentroidRouter(torch.as_tensor(cent), RouterConfig(
        top_k=2 if strategy == "mixture" else 1))
    for paged, chunked, fused, sampled in itertools.product(
            (True, False), (True, False), (True, False), (False, True)):
        if sampled and not chunked:
            continue
        eng = make_engine(
            build_model(get_smoke_config(ARCH)), experts=texperts,
            router=router, config=EngineConfig(
                **_ecfg(strategy, chunked, paged, fused)), device="cpu")
        assert all(not p.paged for p in eng.pods)       # the direct path
        got = _drive(eng, SamplingParams, prompts, feats, sampled)
        want = reference_runs[strategy, chunked, sampled]
        assert got == want, (paged, chunked, fused, sampled)
    assert {r for _, r in want.values()} == {"length", "truncated"}
    assert len(want[len(LENS) - 1][0]) == 1          # fills the context


def test_chunked_matches_monolithic(reference_runs):
    """chunked ≡ monolithic, as the port serves the reference's tokens in
    both (the scan chunk divides the prefill chunk)."""
    for strategy in ("top1", "mixture"):
        assert reference_runs[strategy, True, False] == \
            reference_runs[strategy, False, False]
