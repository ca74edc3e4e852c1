"""The port's hybrid family (Zamba2: Mamba2 groups + one shared attention
block) against the JAX reference, on the float32 ``zamba2_2_7b`` smoke
config with the reference's weights carried across by
``repro_torch.weights``.

Units: the ``chunk_scan`` plain version against ``repro/kernels/ref.py``
and the Pallas kernel in interpret mode, the chunkwise scan with a
carried state, the Mamba2 block and step, and the model's prefill, chunk
and decode paths with their cache contents. Float32 on both sides, rtol =
atol = 2e-5 (summation order only). The SSM states reach the thousands
on these random weights, and the Mamba2 layer's outputs the tens, so the
rounding of those sums reaches every later layer's inputs: the states,
the layer's outputs and every model-level tensor (logits, K/V, conv
windows) are held at rtol 2e-5 and an atol of 2e-5 times the largest
magnitude of the tensor. Pools are
compared outside scratch block 0, where padded chunk rows and idle decode
slots all write.

The whole slice: the top-1 deployment over 2 expert pods emits exactly
the reference's greedy tokens, finish reasons and routing in paged +
chunked, paged + monolithic and contiguous + monolithic serving; chunked
≡ monolithic inside the port; n-gram speculation degrades to the vanilla
step with the same tokens; the launchers serve the family.
"""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import ckpt as jckpt  # noqa: E402
from repro.configs.base import get_smoke_config as jax_smoke  # noqa: E402
from repro.core.router import CentroidRouter as JaxRouter  # noqa: E402
from repro.core.router import RouterConfig as JaxRouterConfig  # noqa: E402
from repro.kernels import ref  # noqa: E402
from repro.kernels.chunk_scan import chunk_scan as pallas_chunk_scan  # noqa: E402
from repro.launch import serve as jax_launch_serve  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.serve import api as japi  # noqa: E402
from repro.serve.scheduler import make_engine as jax_make_engine  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.router import CentroidRouter  # noqa: E402
from repro_torch.kernels import chunk_scan as cs  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import profile_serve  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.serve.api import EngineConfig, SamplingParams  # noqa: E402
from repro_torch.serve.scheduler import make_engine  # noqa: E402
from repro_torch.weights import from_tree  # noqa: E402

ARCH = "zamba2_2_7b"
TOL = dict(rtol=2e-5, atol=2e-5)
CACHE_LEN = 40
# prompts straddle the 16-position scan chunk and the 8-position block both
# ways; 30 + 12 runs past cache_len (truncated); the last fills the context
LENS = [5, 13, 19, 8, 30, 3, 16, 21, CACHE_LEN]
CHUNKED = dict(paged=True, page_block=8, chunked_prefill=True, chunk=16)
CONFIGS = {"paged-chunked": CHUNKED,
           "paged-monolithic": dict(paged=True, page_block=8),
           "contiguous-monolithic": {}}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module, restored after it: with
    parallel test workers each starting a thread per core, the threads
    contend and these smoke-size steps run many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def f32(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **(tol or TOL))


def close_scaled(got, want):
    """rtol 2e-5, atol 2e-5 of the leaf's largest magnitude."""
    want = np.asarray(want)
    close(got, want, rtol=2e-5, atol=2e-5 * max(np.abs(want).max(), 1.0))


# ---------------------------------------------------------------------------
# The kernel's plain version and the chunkwise scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,NC,L,H,dk,dv", [
    (1, 2, 64, 2, 32, 32),
    (2, 4, 32, 4, 16, 48),   # dk != dv (Mamba2: N != P)
    (1, 1, 128, 2, 64, 65),  # odd dv (mLSTM normalizer channel)
])
def test_chunk_scan_plain_matches_reference_and_pallas(B, NC, L, H, dk, dv):
    """The shapes of ``tests/test_kernels.py``'s chunk-scan test, with its
    realistic decays (cumulative sums of −|N|·0.1)."""
    rng = np.random.default_rng(5)
    qc, kc = f32(rng, B, NC, L, H, dk), f32(rng, B, NC, L, H, dk)
    vc = f32(rng, B, NC, L, H, dv)
    cum = np.cumsum(-np.abs(f32(rng, B, NC, L, H)) * 0.1, axis=2) \
        .astype(np.float32)
    intra, kv = cs.chunk_scan_ref(*map(torch.as_tensor, (qc, kc, vc, cum)))
    jargs = tuple(map(jnp.asarray, (qc, kc, vc, cum)))
    for want in (ref.chunk_scan_ref(*jargs),
                 pallas_chunk_scan(*jargs, interpret=True)):
        close(intra, want[0])
        close(kv, want[1])


def test_chunk_scan_dispatch_and_wrapper_guard():
    """On CPU tensors ``ops.chunk_scan`` is the plain version and launches
    nothing; the CUDA wrapper refuses them."""
    rng = np.random.default_rng(6)
    args = [torch.as_tensor(a) for a in
            (f32(rng, 1, 1, 16, 2, 8), f32(rng, 1, 1, 16, 2, 8),
             f32(rng, 1, 1, 16, 2, 5),
             np.cumsum(-np.abs(f32(rng, 1, 1, 16, 2)), axis=2))]
    ops.reset_launch_counts()
    got, want = ops.chunk_scan(*args), cs.chunk_scan_ref(*args)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert cs.chunk_scan.launches == 0
    assert cs.chunk_scan.tensor_core_launches == 0
    with pytest.raises(ValueError, match="CUDA tensors"):
        cs.chunk_scan(*args)


@pytest.mark.parametrize("dtype,dk,dv,tensor_cores", [
    (torch.bfloat16, 64, 160, True),     # Zamba2 at full width
    (torch.bfloat16, 16, 64, True),      # the smoke config's N and P
    (torch.bfloat16, 128, 200, True),    # dk at the TMA kernel's limit
    (torch.bfloat16, 24, 72, True),      # multiples of 8, not of 16
    (torch.float32, 64, 160, False),     # float32: scalar
    (torch.float32, 16, 64, False),
    (torch.float32, 384, 385, False),
    (torch.bfloat16, 64, 65, True),      # odd dv: V through registers
    (torch.bfloat16, 384, 385, True),    # mLSTM at full width
    (torch.bfloat16, 136, 64, True),     # dk past 128
    (torch.bfloat16, 192, 100, True),    # dk of three slabs
    (torch.bfloat16, 256, 385, True),    # dk of four slabs
    (torch.bfloat16, cs.TC_MAX_DK, 1, True),         # dk at the limit
    (torch.bfloat16, cs.TC_MAX_DK + 64, 64, False),  # one slab past it
    (torch.bfloat16, 20, 64, False),     # dk not a multiple of 8
])
def test_chunk_scan_route_rule(dtype, dk, dv, tensor_cores):
    """The CUDA wrapper's route, from dtype and widths alone: bf16 with dk
    a multiple of 8 (TMA's 16-byte row strides of Q and K) up to
    ``TC_MAX_DK`` (1408: the wide kernel's tiles fill a block's shared
    memory), and any dv, take the tensor cores; everything else the scalar
    kernels. V goes by TMA only at dk ≤ 128 with dv a multiple of 8."""
    assert cs.TC_MAX_DK == 1408
    assert cs.tensor_core_route(dtype, dk, dv) is tensor_cores
    assert cs.v_by_tma(dk, dv) is (dk <= 128 and dv % 8 == 0)


def _split_pv_error(parts, decay):
    """The tensor-core route's second product in plain torch: P (float32:
    unit-size scores of one 256-position chunk times exp(cum_t − cum_s),
    masked to s ≤ t) split into ``parts`` bf16 parts (part p = bf16(P −
    parts 0 .. p−1)), each part times bf16 V summed in float64, against
    the float64 product of the float32 P. Returns (max abs error, RMS
    error, largest share of the card's allowance 5e-5 + 5e-5·|want|)."""
    rng = np.random.default_rng(3)
    L, dv = 256, 160
    S = f32(rng, L, L)
    cum = np.cumsum(-np.abs(f32(rng, L)) * decay).astype(np.float32)
    mask = np.tril(np.ones((L, L), bool))
    D = np.exp(np.where(mask, cum[:, None] - cum[None, :], -np.inf))
    P = torch.as_tensor((S * D.astype(np.float32)).astype(np.float32))
    V = torch.as_tensor(f32(rng, L, dv)).to(torch.bfloat16).double()
    want = P.double() @ V
    got, rest = torch.zeros_like(want), P
    for _ in range(parts):
        part = rest.to(torch.bfloat16)
        got += part.double() @ V
        rest = rest - part.float()
    err = (got - want).abs()
    return (err.max().item(), err.pow(2).mean().sqrt().item(),
            (err / (5e-5 + 5e-5 * want.abs())).max().item())


@pytest.mark.parametrize("parts", [1, 2, 3])
def test_bf16_split_of_p_error(parts):
    """Over 256 unit-size terms of random sign (no decay: the slowest heads'
    case), one bf16 rounding of P leaves ~1e-2, far past the allowance; two
    parts leave about the 6e-5 estimated for them (RMS), with the largest
    errors past the 5e-5 allowance; three carry P's 24 bits exactly."""
    worst, rms, share = _split_pv_error(parts, decay=0.0)
    if parts == 1:
        assert share > 100
    elif parts == 2:
        assert 1e-5 < rms <= 6e-5 and share > 1
    else:
        assert worst <= 1e-12 and share < 1e-6


def test_chunk_scan_parts_is_the_fewest_that_hold():
    """``SCAN_PARTS`` is the fewest bf16 parts whose product stays inside
    the 5e-5 allowance both with no decay and with the tests' decays
    (−|N|·0.1 a step)."""
    holds = [k for k in (1, 2, 3)
             if all(_split_pv_error(k, decay)[2] <= 1 for decay in (0.0, 0.1))]
    assert cs.SCAN_PARTS == holds[0] == 3


def test_chunked_linear_attention_with_carry_matches_reference():
    """S = 37 over chunks of 16 (the last padded), a carried-in state."""
    rng = np.random.default_rng(7)
    B, S, H, dk, dv = 2, 37, 3, 8, 12
    q, k = f32(rng, B, S, H, dk) * 0.5, f32(rng, B, S, H, dk) * 0.5
    v = f32(rng, B, S, H, dv)
    log_g = -np.abs(f32(rng, B, S, H)) * 0.2
    state = f32(rng, B, H, dk, dv)
    y, st = tssm.chunked_linear_attention(
        *map(torch.as_tensor, (q, k, v, log_g)), 16,
        state=torch.as_tensor(state))
    jy, jst = jssm.chunked_linear_attention(
        *map(jnp.asarray, (q, k, v, log_g)), 16, state=jnp.asarray(state))
    close(y, jy)
    close(st, jst)
    # the O(1) step from the carried state
    g = np.exp(log_g[:, 0])
    ys, sts = tssm.linear_attention_step(
        st, *map(torch.as_tensor, (q[:, 0], k[:, 0], v[:, 0], g)))
    jys, jsts = jssm.linear_attention_step(
        jst, *map(jnp.asarray, (q[:, 0], k[:, 0], v[:, 0], g)))
    close(ys, jys)
    close(sts, jsts)


# ---------------------------------------------------------------------------
# Mamba2 and the model
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    jm = jax_build(jax_smoke(ARCH))
    jp = jm.init(jax.random.PRNGKey(3))
    return jm, jp, build_model(get_smoke_config(ARCH)), \
        from_tree(jax.tree.map(np.asarray, jp))


def _layer(tree, g, m):
    return jax.tree.map(lambda a: a[g, m], tree)


def test_param_specs_match_reference(models):
    jm, jp, tm, tp = models
    shapes = jax.tree.map(lambda a: tuple(a.shape), jp)
    assert jax.tree.map(lambda t: tuple(t.shape), tp) == shapes
    assert (tm.n_groups, tm.group_m) == (jm.n_groups, jm.group_m)
    assert not tm.prefix_cacheable and not tm.speculative_capable


def test_mamba2_block_and_step_match_reference(models):
    """A 21-position block (a padded last scan chunk), then three steps from
    its state."""
    jm, jp, tm, tp = models
    cfg, jcfg = tm.cfg, jm.cfg
    jmp = _layer(jp["blocks"]["mamba"], 0, 1)
    tmp = {k: torch.as_tensor(np.array(v)) for k, v in jmp.items()}
    x = f32(np.random.default_rng(8), 2, 21, cfg.d_model)
    close_scaled(tssm.mamba2_block(tmp, torch.as_tensor(x), cfg),
                 jssm.mamba2_block(jmp, jnp.asarray(x), jcfg))
    y, st = tssm.mamba2_prefill(tmp, torch.as_tensor(x), cfg)
    jy, jst = jm._mamba2_prefill(jmp, jnp.asarray(x), False)
    close_scaled(y, jy)
    close_scaled(st[0], jst[0])
    close_scaled(st[1], jst[1])
    for t in range(3):
        xt = f32(np.random.default_rng(t), 2, 1, cfg.d_model)
        y, st = tssm.mamba2_step(tmp, torch.as_tensor(xt), cfg, st)
        jy, jst = jssm.mamba2_step(jmp, jnp.asarray(xt), jcfg, jst)
        close_scaled(y, jy)
        close_scaled(st[0], jst[0])
        close_scaled(st[1], jst[1])


def close_cache(cache, jcache, pooled=False):
    for leaf in ("ssm", "conv", "k", "v"):
        got, want = cache[leaf], np.asarray(jcache[leaf])
        if pooled and leaf in ("k", "v"):
            got, want = got[:, 1:], want[:, 1:]
        close_scaled(got, want)


def test_prefill_chunks_then_decode_match_reference(models):
    """A 37-token prompt in chunks of 16 (the last padded) over a block
    table, the carry spliced into slot 1 of 2, then paged decode steps:
    per-chunk logits and carries, the pool, and per-step logits and
    caches."""
    jm, jp, tm, tp = models
    cfg = tm.cfg
    P, block, NB, C = 9, 8, 6, 16
    cache = tm.init_paged_cache(2, P, block, NB * block, device="cpu")
    jcache = jm.init_paged_cache(2, P, block, NB * block)
    prompt = np.random.default_rng(0).integers(0, cfg.vocab, 37) \
        .astype(np.int32)
    padded = np.concatenate([prompt, np.zeros(11, np.int32)])[None]
    x = tm.embed_prompt(tp, {"tokens": torch.as_tensor(padded).long()})
    jx = jm.embed_prompt(jp, {"tokens": jnp.asarray(padded)})
    table = np.array([3, 5, 1, 7, 2, 0], np.int32)
    carry = tm.init_chunk_carry(tp, None, NB * block)
    jcarry = jm.init_chunk_carry(jp, None, NB * block)
    for start in (0, 16, 32):
        length = min(C, 37 - start)
        logits, carry, cache = tm.prefill_chunk(
            tp, cache, carry, x[:, start:start + C], start, length,
            torch.as_tensor(table))
        jlogits, jcarry, jcache = jm.prefill_chunk(
            jp, jcache, jcarry, jx[:, start:start + C], jnp.int32(start),
            jnp.int32(length), jnp.asarray(table))
        close_scaled(logits, jlogits)
        close_scaled(carry["ssm"], jcarry["ssm"])
        close_scaled(carry["conv"], jcarry["conv"])
    spec, jspec = tm.cache_spec(block), jm.cache_spec(block)
    cache = spec.insert_direct(cache, carry, 1)
    jcache = jspec.insert_direct(jcache, jcarry, 1)
    close_cache(cache, jcache, pooled=True)
    tables = np.zeros((2, NB), np.int32)
    tables[1] = table
    tok = np.array([0, int(np.argmax(np.asarray(jlogits)[0]))], np.int32)
    for step in range(4):
        pos = np.array([0, 37 + step], np.int32)
        logits, cache = tm.decode_step_paged(
            tp, cache, torch.as_tensor(tok), torch.as_tensor(pos),
            torch.as_tensor(tables))
        jlogits, jcache = jm.decode_step_paged(
            jp, jcache, jnp.asarray(tok), jnp.asarray(pos),
            jnp.asarray(tables))
        close_scaled(logits, jlogits)
        close_cache(cache, jcache, pooled=True)
        tok = np.array([0, int(np.argmax(np.asarray(jlogits)[1]))],
                       np.int32)


@pytest.mark.parametrize("width", [21, 2])
def test_prefill_then_contiguous_decode_match_reference(models, width):
    """Monolithic prefill (logits at every row and the cache), its splice
    into slot 0 of 2 by ``insert`` and into the paged cache by
    ``insert_paged``, then contiguous decode steps. A 2-token prompt leaves
    a conv window one row short of W − 1 = 3, which both splices write at
    the window's offset 0, as the reference's ``dynamic_update_slice``
    does."""
    jm, jp, tm, tp = models
    cfg = tm.cfg
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (1, width)) \
        .astype(np.int32)
    logits, row = tm.prefill(tp, {"tokens": torch.as_tensor(toks).long()},
                             CACHE_LEN)
    jlogits, jrow = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, CACHE_LEN)
    close_scaled(logits, jlogits)
    close_cache(row, jrow)
    spec, jspec = tm.cache_spec(8), jm.cache_spec(8)
    blocks = np.array([4, 2, 6], np.int32)
    paged = spec.insert_paged(tm.init_paged_cache(2, 7, 8, CACHE_LEN, "cpu"),
                              row, 1, torch.as_tensor(blocks))
    jpaged = jspec.insert_paged(jm.init_paged_cache(2, 7, 8, CACHE_LEN),
                                jrow, 1, jnp.asarray(blocks))
    close_cache(paged, jpaged)
    cache = tm.cache_spec().insert(tm.init_cache(2, CACHE_LEN, "cpu"), row,
                                   0)
    jcache = jm.cache_spec().insert(jm.init_cache(2, CACHE_LEN), jrow, 0)
    close_cache(cache, jcache)
    tok = np.array([int(np.argmax(np.asarray(jlogits)[0, -1])), 0], np.int32)
    for step in range(3):
        pos = np.array([width + step, 0], np.int32)
        logits, cache = tm.decode_step(tp, cache, torch.as_tensor(tok),
                                       torch.as_tensor(pos))
        jlogits, jcache = jm.decode_step(jp, jcache, jnp.asarray(tok),
                                         jnp.asarray(pos))
        close_scaled(logits, jlogits)
        close_cache(cache, jcache)
        tok = np.array([int(np.argmax(np.asarray(jlogits)[0])), 0], np.int32)


# ---------------------------------------------------------------------------
# The whole slice
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def deployment():
    jm = jax_build(jax_smoke(ARCH))
    jexperts = [jm.init(jax.random.PRNGKey(k)) for k in (0, 1)]
    rng = np.random.default_rng(12)
    cent = rng.normal(size=(2, 32)).astype(np.float32)
    prompts = [rng.integers(0, 512, n).astype(np.int32) for n in LENS]
    feats = rng.normal(size=(len(LENS), 32)).astype(np.float32)
    texperts = [from_tree(jax.tree.map(np.asarray, p)) for p in jexperts]
    return jm, jexperts, texperts, cent, prompts, feats


def _drive(engine, sp_cls, prompts, feats, stops, sampled=False):
    # request 5's whole budget is its prefill token; sampled, the even
    # requests draw at temperature 0.8 (top_k 0 and 40)
    for i, p in enumerate(prompts):
        samp = dict(temperature=0.8, top_k=40 * (i % 4 == 2), seed=9 + i) \
            if sampled and i % 2 == 0 else {}
        engine.add_request(p, sp_cls(max_new=1 if i == 5 else 12,
                                     stop_token_ids=stops.get(i, ()),
                                     **samp),
                           features=feats[i], rid=i)
    routing = [[r.rid for r in pod.waiting] for pod in engine.pods]
    res = {}
    while engine.has_unfinished():
        for o in engine.step():
            if o.finished:
                res[o.rid] = (o.token_ids, o.finish_reason)
    return res, routing


def _port_engine(deployment, **ecfg):
    return make_engine(build_model(get_smoke_config(ARCH)),
                       experts=deployment[2],
                       router=CentroidRouter(torch.as_tensor(deployment[3])),
                       config=EngineConfig(n_slots=2, cache_len=CACHE_LEN,
                                           **ecfg), device="cpu")


@pytest.fixture(scope="module")
def stops(deployment):
    """Stop ids that requests 1 and 3 generate mid-stream (found by a free
    run), so both retire on "stop"."""
    free, _ = _drive(_port_engine(deployment, **CHUNKED), SamplingParams,
                     deployment[4], deployment[5], {})
    return {1: (free[1][0][4],), 3: (free[3][0][2],)}


@pytest.mark.parametrize("kind", list(CONFIGS) + ["paged-chunked-sampled"])
def test_hybrid_slice_matches_reference_token_for_token(deployment, stops,
                                                        kind):
    jm, jexperts, _, cent, prompts, feats = deployment
    sampled = kind.endswith("-sampled")
    ecfg = CONFIGS[kind.removesuffix("-sampled")]
    got, got_route = _drive(_port_engine(deployment, **ecfg), SamplingParams,
                            prompts, feats, stops, sampled)
    jeng = jax_make_engine(
        jm, experts=jexperts,
        router=JaxRouter(jnp.asarray(cent), JaxRouterConfig()),
        config=japi.EngineConfig(n_slots=2, cache_len=CACHE_LEN, **ecfg))
    want, want_route = _drive(jeng, japi.SamplingParams, prompts, feats,
                              stops, sampled)
    assert got_route == want_route and all(got_route)
    assert got == want
    assert {r for _, r in got.values()} == {"stop", "length", "truncated"}
    assert got[len(LENS) - 1][1] == "truncated" \
        and len(got[len(LENS) - 1][0]) == 1       # fills the context


def test_chunked_and_paged_match_contiguous_monolithic(deployment, stops):
    """The port's own invariants on the hybrid family: chunked ≡
    monolithic and paged ≡ contiguous, tokens, reasons and routing."""
    runs = [_drive(_port_engine(deployment, **ecfg), SamplingParams,
                   deployment[4], deployment[5], stops)
            for ecfg in CONFIGS.values()]
    assert runs[0] == runs[1] == runs[2]


def test_ngram_speculation_degrades_to_vanilla(deployment, stops):
    """A hybrid model is not ``speculative_capable``: ``speculative=
    "ngram"`` serves the vanilla step — the same tokens as off, and no
    span is ever verified."""
    base = _drive(_port_engine(deployment, **CHUNKED), SamplingParams,
                  deployment[4], deployment[5], stops)
    eng = _port_engine(deployment, speculative="ngram", spec_len=4,
                       **CHUNKED)
    assert _drive(eng, SamplingParams, deployment[4], deployment[5],
                  stops) == base
    assert all(pod.stats()["spec_steps"] == 0 for pod in eng.pods)


def test_misaligned_chunk_is_refused_with_the_reference_message():
    cfg = dict(n_slots=2, cache_len=CACHE_LEN, paged=True, page_block=8,
               chunked_prefill=True, chunk=8)
    with pytest.raises(ValueError) as want:
        japi.EngineConfig(**cfg).validate(jax_build(jax_smoke(ARCH)))
    with pytest.raises(ValueError) as got:
        EngineConfig(**cfg).validate(build_model(get_smoke_config(ARCH)))
    assert str(got.value) == str(want.value)
    assert "chunkwise-scan length 16" in str(got.value)
    # a multiple of the scan length passes; other recurrent-free checks
    # (chunked prefill needs the pool) are the reference's too
    EngineConfig(**dict(cfg, chunk=32)).validate(
        build_model(get_smoke_config(ARCH)))
    with pytest.raises(ValueError, match="enable paging"):
        EngineConfig(**dict(cfg, paged=False, chunk=16)).validate(
            build_model(get_smoke_config(ARCH)))


# ---------------------------------------------------------------------------
# The launchers
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def run_dir(tmp_path_factory, deployment):
    """A hybrid training run dir written by the REFERENCE's checkpoint
    code."""
    out = str(tmp_path_factory.mktemp("hybrid_run"))
    for k in range(2):
        jckpt.save_expert(out, k, 10, {"params": deployment[1][k]})
    jckpt.save_router(out, deployment[3], 10.0, 1)
    return out


def test_launcher_serves_hybrid_as_the_reference_launcher(run_dir, capsys,
                                                          monkeypatch):
    """``launch/serve.py --arch zamba2_2_7b`` on a hybrid run dir streams
    the reference launcher's tokens, paged + chunked (chunk 16, the scan
    length) and contiguous + monolithic."""
    base = ["--run", run_dir, "--arch", ARCH, "--requests", "3",
            "--prompt-len", "16", "--new-tokens", "5", "--slots", "2"]
    chunked = ["--paged", "--page-block", "8", "--chunked-prefill",
               "--prefill-chunk", "16"]
    monkeypatch.setattr("sys.argv", ["serve"] + base + chunked + ["--stream"])
    jax_launch_serve.main()
    want = {}
    for rid, toks in re.findall(r"rid=\s*(\d+) \+(\[[^\]]*\])",
                                capsys.readouterr().out):
        want.setdefault(int(rid), []).extend(eval(toks))
    report = launch_serve.main(base + chunked + ["--device", "cpu"])
    assert report["tokens"] == want and len(want) == 3
    assert report["finish_reasons"] == ["length"] * 3
    assert launch_serve.main(base + ["--device", "cpu"])["tokens"] == want


def test_profile_script_rehearses_hybrid_path_on_cpu():
    """``launch/profile_serve.py --arch zamba2_2_7b --smoke --device cpu``:
    the hybrid deployment, both windows of their kind, every step
    counted."""
    rep = profile_serve.main(["--smoke", "--device", "cpu", "--arch", ARCH])
    assert rep["config"] == "zamba2_smoke" and rep["requests"] == 16
    assert sum(rep["steps_by_kind"].values()) == rep["steps"]
    for kind in ("mixed", "decode"):
        assert rep["windows"][kind]["kinds"] == [kind] * profile_serve.WINDOW
    assert rep["run_busy_share_est"] == "not measured (CPU run)"
