"""The port's Eq. 27 mixture (``strategy="mixture"``) against the JAX
reference, dense family (the float32 ``qwen3_8b`` smoke config, 3 experts
carried across from the reference's pytrees by ``repro_torch.weights``,
``RouterConfig(top_k=2)``, as ``tests/test_paged.py`` and
``tests/test_chunked.py`` serve the reference's ``MixtureSlotServer``).

The whole slice: the mixture server emits exactly the reference's greedy
tokens and finish reasons in paged + chunked, paged + monolithic and
contiguous + monolithic serving; its mixed next-token probabilities after a
monolithic prefill, a contiguous decode step, each prefill chunk and a
paged decode step are within rtol = 1e-4, atol = 1e-9 of the reference's
(float32 on both sides: the logits differ by summation order, which a
softmax carries into each probability relative to itself; measured 2.3e-6
relative here and 1.3e-5 on the hybrid family, whose deeper recurrent
sums round more; the smallest probability is ~1e-4, so the atol only
keeps a zero from failing a relative test). The port's own invariants: paged ≡ contiguous and chunked ≡
monolithic under the mixture, one-hot router weights (top_k = 1) ≡ the
top-1 deployment, and each expert's logits from a stacked step ≡ that
expert's own single-model step. Units: ``mix_expert_logits``, the
``from_probs`` greedy epilogue and first-token pick (ties below
``PROB_FLOOR``), the expert stack's layout, the batched chunk-prefill
plain version against ``jax.vmap`` of the Pallas kernel in interpret mode,
and the router kernel's launch rule; the profiler's ``--mixture``
rehearsal. (The launcher twin's ``--strategy mixture`` is held against the
reference launcher in ``test_torch_serve.py``.) The hybrid family's
mixture is in ``test_torch_mixture_hybrid.py``.
"""
from dataclasses import dataclass, field
from typing import Any, List

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_smoke_config as jax_smoke  # noqa: E402
from repro.core import ensemble as jens  # noqa: E402
from repro.core.router import CentroidRouter as JaxRouter  # noqa: E402
from repro.core.router import RouterConfig as JaxRouterConfig  # noqa: E402
from repro.kernels.decode_attention import (  # noqa: E402
    chunk_prefill_attention as pallas_chunk)
from repro.models import build_model as jax_build  # noqa: E402
from repro.serve import api as japi  # noqa: E402
from repro.serve import fused as jfused  # noqa: E402
from repro.serve.scheduler import make_engine as jax_make_engine  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import ensemble  # noqa: E402
from repro_torch.core.router import CentroidRouter, RouterConfig  # noqa: E402
from repro_torch.kernels import decode_attention as dk  # noqa: E402
from repro_torch.kernels import router_scores as rk  # noqa: E402
from repro_torch.launch import profile_serve  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serve import fused  # noqa: E402
from repro_torch.serve.api import EngineConfig, SamplingParams  # noqa: E402
from repro_torch.serve.scheduler import make_engine  # noqa: E402
from repro_torch.weights import from_tree  # noqa: E402

ARCH = "qwen3_8b"
N_EXPERTS, FEAT_DIM, CACHE_LEN, BLOCK = 3, 16, 40, 8
# prompts straddle chunks and blocks; 30 + 12 runs past cache_len
# (truncated); request 5's whole budget is its prefill token; the last
# prompt fills the context
LENS = [5, 13, 19, 8, 30, 3, 16, CACHE_LEN]
PROB_TOL = dict(rtol=1e-4, atol=1e-9)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module, restored after it: with
    parallel test workers each starting a thread per core, the threads
    contend and these smoke-size steps run many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def configs(chunk):
    """The three serving configurations the top-1 path serves."""
    return {"paged-chunked": dict(paged=True, page_block=BLOCK,
                                  chunked_prefill=True, chunk=chunk),
            "paged-monolithic": dict(paged=True, page_block=BLOCK),
            "contiguous-monolithic": {}}


@dataclass
class Deployment:
    arch: str
    jm: Any
    jexperts: List[Any]
    texperts: List[Any]
    cent: np.ndarray
    prompts: List[np.ndarray]
    feats: np.ndarray


def build_deployment(arch):
    jm = jax_build(jax_smoke(arch))
    jexperts = [jm.init(jax.random.PRNGKey(k)) for k in range(N_EXPERTS)]
    rng = np.random.default_rng(1)
    cent = rng.normal(size=(N_EXPERTS, FEAT_DIM)).astype(np.float32)
    prompts = [rng.integers(0, 512, n).astype(np.int32) for n in LENS]
    feats = rng.normal(size=(len(LENS), FEAT_DIM)).astype(np.float32)
    texperts = [from_tree(jax.tree.map(np.asarray, p)) for p in jexperts]
    return Deployment(arch, jm, jexperts, texperts, cent, prompts, feats)


def sampling(i, sampled):
    """Seeded sampling for the even requests of a sampled run (top_k 0
    and 40); the odd ones, which carry the stop ids, stay greedy."""
    return dict(temperature=0.8, top_k=40 * (i % 4 == 2), seed=57 + i) \
        if sampled and i % 2 == 0 else {}


def drive(engine, sp_cls, dep, stops, sampled=False):
    for i, p in enumerate(dep.prompts):
        engine.add_request(p, sp_cls(max_new=1 if i == 5 else 12,
                                     stop_token_ids=stops.get(i, ()),
                                     **sampling(i, sampled)),
                           features=dep.feats[i], rid=i)
    res = {}
    while engine.has_unfinished():
        for o in engine.step():
            if o.finished:
                res[o.rid] = (o.token_ids, o.finish_reason)
    return res


def port_engine(dep, top_k=2, strategy="mixture", **ecfg):
    return make_engine(
        build_model(get_smoke_config(dep.arch)), experts=dep.texperts,
        router=CentroidRouter(torch.as_tensor(dep.cent),
                              RouterConfig(top_k=top_k)),
        config=EngineConfig(n_slots=2, cache_len=CACHE_LEN,
                            strategy=strategy, **ecfg), device="cpu")


def reference_engine(dep, **ecfg):
    return jax_make_engine(
        dep.jm, experts=dep.jexperts,
        router=JaxRouter(jnp.asarray(dep.cent), JaxRouterConfig(top_k=2)),
        config=japi.EngineConfig(n_slots=2, cache_len=CACHE_LEN,
                                 strategy="mixture", **ecfg))


def find_stops(dep, chunked):
    """Stop ids that requests 1 and 3 generate mid-stream (found by a free
    run), so both retire on "stop"."""
    free = drive(port_engine(dep, **chunked), SamplingParams, dep, {})
    return {1: (free[1][0][4],), 3: (free[3][0][2],)}


def check_slice_against_reference(dep, stops, kind, chunk):
    """``kind``: one of ``configs``, or one with ``-sampled`` appended (the
    even requests sample)."""
    sampled = kind.endswith("-sampled")
    ecfg = configs(chunk)[kind.removesuffix("-sampled")]
    got = drive(port_engine(dep, **ecfg), SamplingParams, dep, stops,
                sampled)
    want = drive(reference_engine(dep, **ecfg), japi.SamplingParams, dep,
                 stops, sampled)
    assert got == want
    assert {r for _, r in got.values()} == {"stop", "length", "truncated"}
    last = len(LENS) - 1                          # fills the context
    assert got[last][1] == "truncated" and len(got[last][0]) == 1


def check_invariants(dep, stops, chunk):
    """chunked ≡ monolithic and paged ≡ contiguous under the mixture, and
    one-hot weights (top_k = 1) ≡ the top-1 deployment."""
    runs = [drive(port_engine(dep, **ecfg), SamplingParams, dep, stops)
            for ecfg in configs(chunk).values()]
    assert runs[0] == runs[1] == runs[2]
    chunked = configs(chunk)["paged-chunked"]
    one_hot = drive(port_engine(dep, top_k=1, **chunked), SamplingParams,
                    dep, stops)
    top1 = drive(port_engine(dep, strategy="top1", **chunked),
                 SamplingParams, dep, stops)
    assert one_hot == top1
    assert one_hot != runs[0]          # the second expert's weight matters


def _i32(*xs):
    return [jnp.asarray(x, jnp.int32) for x in xs]


def mixture_probs(dep, chunk):
    """Mixed probabilities (1, V) of the reference and the port, each from
    its own stacked experts, under one weight row: after a monolithic
    prefill, a contiguous decode step, each prefill chunk, and a paged
    decode step after the chunks. Returns (the reference's list, the
    port's list, the port's stacked logits of those steps with what
    replays them one expert at a time)."""
    jm, K = dep.jm, N_EXPERTS
    prompt, width = dep.prompts[2], len(dep.prompts[2])       # 19 tokens
    padded = np.concatenate([prompt, np.zeros(-width % chunk, np.int32)])
    nb = CACHE_LEN // BLOCK
    w = np.array([[0.625, 0.0, 0.375]], np.float32)
    # the reference: vmapped steps over its stack
    stacked, axes, prefill_all, mix_decode = jens.make_stacked_serving(
        jm, dep.jexperts, CACHE_LEN)
    _, _, _, mix_paged = jens.make_stacked_serving(
        jm, dep.jexperts, CACHE_LEN, paged=True)
    prep_all, chunk_all = jens.make_stacked_chunk_fns(
        jm, stacked, axes, CACHE_LEN, chunk)
    jw = jnp.asarray(w)
    logits, caches = prefill_all(stacked, {"tokens": jnp.asarray(
        prompt[None], jnp.int32)})
    want = [jens.mix_expert_logits(logits[:, :, -1], jw)]
    tok = int(np.argmax(np.asarray(want[0])[0]))
    tok_j, pos_j = _i32([tok], [width])
    want.append(mix_decode(stacked, caches, tok_j, pos_j, jw)[0])
    pool = jax.tree.map(
        lambda s: jnp.zeros(s.shape[:1] + (K,) + s.shape[1:], s.dtype),
        jm.paged_cache_shapes(1, nb + 1, BLOCK, CACHE_LEN))
    table = jnp.arange(1, nb + 1, dtype=jnp.int32)
    x, carry = prep_all(stacked, {"tokens": jnp.asarray(padded[None],
                                                        jnp.int32)})
    for start in range(0, width, chunk):
        probs, carry, pool = chunk_all(
            stacked, pool, carry, x[:, :, start:start + chunk],
            *_i32(start, min(chunk, width - start)), table, jw)
        want.append(probs)
    pool = jm.cache_spec(BLOCK).shifted(1).insert_direct(pool, carry, 0)
    want.append(mix_paged(stacked, pool, tok_j, pos_j, jw, table[None])[0])
    # the port: the model's serving paths on its stack
    model = build_model(get_smoke_config(dep.arch))
    st = ensemble.stack_experts_for_decode(dep.texperts)
    tw = torch.as_tensor(w)
    r = Replay(model, prompt, padded, chunk, torch.tensor([tok], dtype=torch.int32),
               torch.tensor([width], dtype=torch.int32),
               torch.arange(1, nb + 1, dtype=torch.int32))
    tlogits, row = model.prefill(st, r.batch(prompt), CACHE_LEN)
    got = [ensemble.mix_expert_logits(tlogits[:, :, -1], tw)]
    r.logits.append(model.decode_step(st, row, r.tok, r.pos)[0])
    pool = model.init_paged_cache(1, nb + 1, BLOCK, CACHE_LEN, device="cpu",
                                  experts=K)
    x = model.embed_prompt(st, r.batch(padded))
    carry = model.init_chunk_carry(st, r.batch(padded), CACHE_LEN)
    for start in r.starts():
        c_logits, carry, pool = model.prefill_chunk(
            st, pool, carry, x[:, start:start + chunk], start,
            min(chunk, width - start), r.table)
        r.logits.append(c_logits)
    pool = model.cache_spec(BLOCK).shifted(1).insert_direct(pool, carry, 0)
    r.logits.append(model.decode_step_paged(st, pool, r.tok, r.pos,
                                            r.table[None])[0])
    got += [ensemble.mix_expert_logits(lg, tw) for lg in r.logits]
    return want, got, r


@dataclass
class Replay:
    """The port's stacked steps of ``mixture_probs``: (K, ...) logits of the
    contiguous decode step, each chunk step and the paged decode step."""
    model: Any
    prompt: np.ndarray
    padded: np.ndarray
    chunk: int
    tok: Any
    pos: Any
    table: Any
    logits: List[Any] = field(default_factory=list)

    @staticmethod
    def batch(tokens):
        return {"tokens": torch.as_tensor(tokens[None].astype(np.int64))}

    def starts(self):
        return range(0, len(self.prompt), self.chunk)


def check_probs_against_reference(dep, chunk):
    want, got, _ = mixture_probs(dep, chunk)
    assert len(got) == len(want) == 3 + -(-len(dep.prompts[2]) // chunk)
    for g, w in zip(got, want):
        assert g.shape == (1, 512)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **PROB_TOL)
        assert abs(float(g.sum()) - 1.0) < 1e-5


def check_stacked_steps_match_each_expert(dep, chunk):
    """Each expert's logits from the stacked contiguous decode step, every
    stacked chunk step and the stacked paged decode step equal that
    expert's own single-model steps on the same inputs, within 1e-5 (the
    stack's batched products and folded kernel launches are the single
    model's arithmetic up to the products' blocking)."""
    _, _, r = mixture_probs(dep, chunk)
    model, width, nb = r.model, len(r.prompt), CACHE_LEN // BLOCK
    for k, params in enumerate(dep.texperts):
        one = [model.decode_step(params, model.prefill(
            params, r.batch(r.prompt), CACHE_LEN)[1], r.tok, r.pos)[0]]
        pool = model.init_paged_cache(1, nb + 1, BLOCK, CACHE_LEN,
                                      device="cpu")
        x = model.embed_prompt(params, r.batch(r.padded))
        carry = model.init_chunk_carry(params, r.batch(r.padded), CACHE_LEN)
        for start in r.starts():
            logits, carry, pool = model.prefill_chunk(
                params, pool, carry, x[:, start:start + r.chunk], start,
                min(r.chunk, width - start), r.table)
            one.append(logits)
        pool = model.cache_spec(BLOCK).insert_direct(pool, carry, 0)
        one.append(model.decode_step_paged(params, pool, r.tok, r.pos,
                                           r.table[None])[0])
        assert len(one) == len(r.logits)
        for single, stacked in zip(one, r.logits):
            torch.testing.assert_close(single, stacked[k], rtol=1e-5,
                                       atol=1e-5)


# ---------------------------------------------------------------------------
# The whole slice, dense family
# ---------------------------------------------------------------------------

CHUNK = 8


@pytest.fixture(scope="module")
def deployment():
    return build_deployment(ARCH)


@pytest.fixture(scope="module")
def stops(deployment):
    return find_stops(deployment, configs(CHUNK)["paged-chunked"])


@pytest.mark.parametrize("kind", list(configs(CHUNK))
                         + ["contiguous-monolithic-sampled"])
def test_mixture_matches_reference_token_for_token(deployment, stops, kind):
    check_slice_against_reference(deployment, stops, kind, CHUNK)


def test_mixture_invariants(deployment, stops):
    check_invariants(deployment, stops, CHUNK)


def test_mixed_probabilities_match_reference(deployment):
    check_probs_against_reference(deployment, CHUNK)


def test_stacked_steps_match_each_expert(deployment):
    check_stacked_steps_match_each_expert(deployment, CHUNK)


def test_expert_stack_layout_matches_reference(deployment):
    """``blocks`` leaves (L, K, ...), the others (K, ...), leaf for leaf
    the reference's stack."""
    got = ensemble.stack_experts_for_decode(deployment.texperts)
    want, axes = jens.stack_experts_for_decode(deployment.jexperts)
    assert axes["blocks"]["ln1"] == 1 and axes["final_norm"] == 0
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    for path, leaf in flat:
        node = got
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape, path
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))


def test_speculation_under_the_mixture_is_refused(deployment):
    """Speculation under the mixture is served on the paged pool (its
    parity is ``test_torch_mixture_speculative.py``); without the pool
    the port refuses it as the reference does, with its message."""
    eng = port_engine(deployment, speculative="expert",
                      **configs(CHUNK)["paged-chunked"])
    assert eng.core._can_spec and eng.core._ngram is None
    for drafter in ("ngram", "expert"):
        with pytest.raises(ValueError) as want:
            reference_engine(deployment, speculative=drafter)
        with pytest.raises(ValueError) as got:
            port_engine(deployment, speculative=drafter)
        assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# Units: the mixture, the probability epilogue, the batched kernel, the
# router's launch rule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("log_space", [False, True])
def test_mix_expert_logits_matches_reference(log_space):
    rng = np.random.default_rng(3)
    logits = (rng.normal(size=(3, 4, 50)) * 4).astype(np.float32)
    w = rng.dirichlet(np.ones(3), size=4).astype(np.float32)
    w[1] = [1.0, 0.0, 0.0]                      # one-hot row
    got = ensemble.mix_expert_logits(torch.as_tensor(logits),
                                     torch.as_tensor(w), log_space=log_space)
    want = jens.mix_expert_logits(jnp.asarray(logits), jnp.asarray(w),
                                  log_space=log_space)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7 if not log_space else 1e-5)
    assert ensemble.PROB_FLOOR == jens.PROB_FLOOR


def test_from_probs_epilogue_matches_reference():
    """The greedy pick over mixture probabilities takes log(max(p,
    PROB_FLOOR)) first: rows whose largest values sit below the floor tie
    at the floor and resolve to the first index, as in the reference."""
    V = 12
    probs = np.full((4, V), 1e-40, np.float32)
    probs[0, 7] = 0.9                           # an ordinary row
    probs[1, 3], probs[1, 9] = 1e-32, 1e-31     # both below the floor
    probs[2, 5], probs[2, 2] = 0.5, 0.5         # an exact tie
    probs[3, 10] = 1e-29                        # just above the floor
    n = 4
    port_state = {"tok": torch.tensor([4, 4, 4, 4], dtype=torch.int32),
                  "pos": torch.tensor([3, 9, 38, 5], dtype=torch.int32),
                  "active": torch.tensor([True, True, True, False]),
                  "counts": torch.tensor([1, 6, 2, 0], dtype=torch.int32),
                  "max_new": torch.tensor([12, 7, 12, 12], dtype=torch.int32),
                  "stop_ids": torch.tensor([[7], [-1], [-1], [-1]],
                                           dtype=torch.int32)}
    jstate = {k: jnp.asarray(v.numpy()) for k, v in port_state.items()}
    jstate.update(temps=jnp.zeros(n, jnp.float32),
                  top_ks=jnp.zeros(n, jnp.int32),
                  seeds=jnp.zeros(n, jnp.uint32))
    st, nxt, done = fused.decode_epilogue(torch.as_tensor(probs), port_state,
                                          cache_len=40, from_probs=True)
    jst, jnxt, jdone = jfused.decode_epilogue(jnp.asarray(probs), jstate,
                                              cache_len=40, from_probs=True)
    assert nxt.tolist() == np.asarray(jnxt).tolist() == [7, 0, 2, 4]
    assert done.tolist() == np.asarray(jdone).tolist()
    for k in port_state:
        assert st[k].tolist() == np.asarray(jst[k]).tolist(), k
    for row in probs:
        got = fused.pick_first(torch.as_tensor(row[None]), from_probs=True)
        want = jfused.pick_first(jnp.asarray(row[None]), jnp.zeros(1),
                                 jnp.zeros(1, jnp.int32),
                                 jnp.zeros(1, jnp.uint32), from_probs=True)
        assert got.tolist() == np.asarray(want).tolist()


@pytest.mark.parametrize("B,C,NB,block,H,KV,dh,start", [
    (2, 4, 4, 8, 4, 2, 16, 9),       # GQA, the chunk straddles a block
    (3, 3, 2, 8, 2, 2, 16, 0),       # MHA, the first chunk
])
def test_batched_chunk_prefill_plain_matches_vmapped_pallas(
        B, C, NB, block, H, KV, dh, start):
    """The batched plain version (B chunks at one start, table row b for
    chunk b) against ``jax.vmap`` of the Pallas kernel over the batch (the
    reference's expert-stacked chunk step) in interpret mode, and against
    the unbatched plain version row by row."""
    rng = np.random.default_rng(B)
    P = B * NB + 1
    q = rng.normal(size=(B, C, H, dh)).astype(np.float32)
    kp = rng.normal(size=(P, block, KV, dh)).astype(np.float32)
    vp = rng.normal(size=(P, block, KV, dh)).astype(np.float32)
    bt = rng.permutation(np.arange(1, P))[:B * NB].reshape(B, NB) \
        .astype(np.int32)
    bt[:, (start + C - 1) // block + 1:] = 0       # past the horizon
    t = [torch.as_tensor(a) for a in (q, kp, vp, bt)]
    got = dk.chunk_prefill_attention_ref(t[0], t[1], t[2], start, t[3])
    want = jax.vmap(lambda qb, tb: pallas_chunk(
        qb, jnp.asarray(kp), jnp.asarray(vp), jnp.int32(start), tb,
        interpret=True))(jnp.asarray(q), jnp.asarray(bt))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    for b in range(B):
        torch.testing.assert_close(
            got[b], dk.chunk_prefill_attention_ref(t[0][b], t[1], t[2],
                                                   start, t[3][b]),
            rtol=0, atol=0)


@pytest.mark.parametrize("B,D,K,itemsize,aligned,plan", [
    (1, 32, 2, 4, True, (1, 8, 32, 4)),      # the path: one warp, 16 B loads
    (16, 32, 2, 4, True, (4, 8, 32, 4)),     # 4 rows a warp, 4 warps
    (65536, 32, 2, 4, True, (8, 8, 32, 4)),  # 32 rows a block
    (100, 64, 6, 4, True, (8, 16, 64, 4)),   # 2 rows a warp
    (8, 64, 6, 2, True, (2, 8, 64, 8)),      # bf16: 8 a load
    (3, 33, 2, 4, True, (3, 32, 33, 1)),     # D not a multiple: scalar
    (5, 32, 2, 4, False, (5, 32, 32, 1)),    # unaligned: scalar
    (8, 8192, 8, 4, True, (8, 32, 1524, 4)),  # K·D past 48 KB: slabs of D
    (1, 100000, 2, 2, True, (1, 32, 6136, 8)),
    (1, 4, 3, 4, True, (1, 1, 4, 4)),        # one piece: a lane a row
])
def test_router_launch_rule(B, D, K, itemsize, aligned, plan):
    """The router kernel's launch from the shapes alone: ``span`` lanes a
    row (the least power of two giving each 16-byte piece of D a lane, at
    most 32), at most ``ROUTER_MAX_WARPS`` warps a block and as few as B
    needs, the centroids staged in slabs of D within
    ``ROUTER_SMEM_BYTES``, 16-byte loads where D and the alignment
    allow."""
    warps, span, slab, vec = rk.router_plan(B, D, K, itemsize, aligned)
    assert (warps, span, slab, vec) == plan
    assert slab % vec == 0 and D % vec == 0
    pieces = -(-D // vec)
    assert span == 32 or span // 2 < pieces <= span
    rows = warps * (32 // span)
    assert rows >= min(B, rk.ROUTER_MAX_WARPS * (32 // span))
    assert warps == 1 or rows - (32 // span) < B

    def smem(slab):
        return 4 * (K * slab + K + rows * K)
    assert smem(slab) <= rk.ROUTER_SMEM_BYTES
    if slab < D:            # the widest slab that fits
        assert smem(slab + vec) > rk.ROUTER_SMEM_BYTES


def test_router_launch_rule_refuses_what_cannot_fit():
    with pytest.raises(ValueError, match="no room for a slab"):
        rk.router_plan(8, 64, 2000, 4)


# ---------------------------------------------------------------------------
# The profiler
# ---------------------------------------------------------------------------

def test_profile_script_rehearses_mixture_on_cpu():
    """``launch/profile_serve.py --mixture --smoke --device cpu``: the
    main path's deployment under the Eq. 27 mixture, both windows of
    their kind, every step counted."""
    rep = profile_serve.main(["--smoke", "--device", "cpu", "--mixture"])
    assert rep["strategy"] == "mixture"
    assert sum(rep["steps_by_kind"].values()) == rep["steps"]
    for kind in ("mixed", "decode"):
        assert rep["windows"][kind]["kinds"] == [kind] * profile_serve.WINDOW
