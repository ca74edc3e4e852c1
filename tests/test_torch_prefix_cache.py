"""The port's radix prefix cache against the JAX reference.

* ``block_keys`` equals the reference's bit for bit (the extras digest of
  a vlm request's float32 patches at the root, the image prefix's
  positions carrying no token ids), and the port's ``PrefixCache`` over
  its ``BlockAllocator`` answers a scripted sequence of matches, inserts,
  pins, releases and evictions exactly as the reference's does; the
  reference's own unit cases run on the port's copy.
* Serving: a queue whose requests share a 19-token prefix (it splits a
  page block of 8), one exact repeat among them, is served by the
  ``DecentralizedSlotServer`` with ``prefix_cache=True`` token for token
  and finish reason for finish reason as without the cache and as the
  reference's engine with it, for the dense (``qwen3_8b``) and vlm
  (``internvl2_2b``: every request with the same patches but one, which
  must miss) smoke configs, top-1 and under the Eq. 27 mixture (one cache
  for the K stacked experts); ``occupancy()`` — every pod's ``stats()``,
  the prefix keys included — equals the reference's; and at the end each
  pod's free list holds every block but the cached ones.
* Pool pressure: admission evicts the LRU unreferenced cached blocks
  before it waits, never the run it is about to map, with the
  reference's tokens and counters.
* The hybrid family (``zamba2_2_7b``) keeps its recurrent state outside
  the pool: asked for the cache, it takes the uncached path
  (``prefix is None``) with the same tokens.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_smoke_config as jax_smoke  # noqa: E402
from repro.core.router import CentroidRouter as JaxRouter  # noqa: E402
from repro.core.router import RouterConfig as JaxRouterConfig  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.serve import api as japi  # noqa: E402
from repro.serve import prefix_cache as jpc  # noqa: E402
from repro.serve import scheduler as jsched  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.router import CentroidRouter, RouterConfig  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serve import prefix_cache as pc  # noqa: E402
from repro_torch.serve import scheduler as sched  # noqa: E402
from repro_torch.serve.api import EngineConfig, SamplingParams  # noqa: E402
from repro_torch.weights import from_tree  # noqa: E402

K, FEAT, BLOCK, CHUNK, NEW = 2, 16, 8, 8, 5
SHARED, SUFFIXES = 19, (6, 9, 6)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dep(arch):
    jm = jax_build(jax_smoke(arch))
    cfg = jm.cfg
    jexperts = [jm.init(jax.random.PRNGKey(k)) for k in range(K)]
    texperts = [from_tree(jax.tree.map(np.asarray, p)) for p in jexperts]
    rng = np.random.default_rng(21)
    cent = rng.normal(size=(K, FEAT)).astype(np.float32)
    shared = rng.integers(0, cfg.vocab, SHARED).astype(np.int32)
    sufs = [rng.integers(0, cfg.vocab, n).astype(np.int32)
            for n in SUFFIXES]
    prompts = [np.concatenate([shared, s]) for s in sufs] + \
        [np.concatenate([shared, sufs[0]])]      # an exact repeat of 0
    extras = [{} for _ in prompts]
    if cfg.family == "vlm":
        img = rng.normal(size=(cfg.n_patches, cfg.vision_dim)) \
            .astype(np.float32)
        extras = [{"patches": img} for _ in prompts]
        # request 0's tokens under other patches: the digest must miss
        prompts.append(prompts[0].copy())
        extras.append({"patches": rng.normal(
            size=(cfg.n_patches, cfg.vision_dim)).astype(np.float32)})
    # the shared-prefix requests all route to pod 0, a last one anywhere
    feats = np.repeat(cent[:1], len(prompts), 0)
    prompts.append(rng.integers(0, cfg.vocab, 11).astype(np.int32))
    extras.append(dict(extras[0]))
    feats = np.concatenate([feats, rng.normal(size=(1, FEAT))
                            .astype(np.float32)])
    cache_len = 48 + (cfg.n_patches if cfg.family == "vlm" else 0)
    return dict(jm=jm, jexperts=jexperts, texperts=texperts, cent=cent,
                prompts=prompts, extras=extras, feats=feats,
                cache_len=cache_len, cfg=cfg, arch=arch)


@pytest.fixture(scope="module")
def dense():
    return _dep("qwen3_8b")


@pytest.fixture(scope="module")
def vlm():
    return _dep("internvl2_2b")


def drive(engine, sp_cls, dep, rids=None):
    for i in range(len(dep["prompts"])) if rids is None else rids:
        engine.add_request(dep["prompts"][i], sp_cls(max_new=NEW),
                           dep["extras"][i] or None,
                           features=dep["feats"][i], rid=i)
    res = {}
    while engine.has_unfinished():
        for o in engine.step():
            if o.finished:
                res[o.rid] = (o.token_ids, o.finish_reason)
    return res


def ecfg(dep, **over):
    return dict(dict(n_slots=2, cache_len=dep["cache_len"], paged=True,
                     page_block=BLOCK, chunked_prefill=True, chunk=CHUNK),
                **over)


def port_engine(dep, strategy="top1", **over):
    model = build_model(get_smoke_config(dep["arch"]))
    return sched.make_engine(
        model, experts=dep["texperts"],
        router=CentroidRouter(torch.as_tensor(dep["cent"]),
                              RouterConfig(top_k=K if strategy == "mixture"
                                           else 1)),
        config=EngineConfig(**ecfg(dep, strategy=strategy, **over)),
        device="cpu")


def ref_engine(dep, strategy="top1", **over):
    return jsched.make_engine(
        dep["jm"], experts=dep["jexperts"],
        router=JaxRouter(jnp.asarray(dep["cent"]), JaxRouterConfig(
            top_k=K if strategy == "mixture" else 1)),
        config=japi.EngineConfig(**ecfg(dep, strategy=strategy, **over)))


# ---------------------------------------------------------------------------
# Keys and the cache against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bs,n_prefix,with_patches",
                         [(8, 0, False), (4, 0, True), (8, 16, True),
                          (16, 6, True), (8, 19, False)])
def test_block_keys_equal_reference(bs, n_prefix, with_patches):
    rng = np.random.default_rng(bs + n_prefix)
    toks = rng.integers(0, 151936, 37).astype(np.int32)
    extras = {"patches": rng.normal(size=(16, 64)).astype(np.float32)} \
        if with_patches else {}
    n = (len(toks) + n_prefix) // bs
    got = pc.block_keys(toks, extras, bs, n, n_prefix=n_prefix)
    assert got == jpc.block_keys(toks, extras, bs, n, n_prefix=n_prefix)
    assert len(got) == n


def _script(mod, alloc_cls):
    """One scripted life of a cache over a 10-block pool; returns every
    answer it gives."""
    def keys(toks, bs=2):
        return mod.block_keys(np.asarray(toks, np.int32), {}, bs,
                              len(toks) // bs)
    alloc = alloc_cls(10)
    cache = mod.PrefixCache(alloc, 2)
    log = []
    a = alloc.alloc(3)
    log.append(cache.insert(keys([1, 2, 3, 4, 5, 6]), a))
    b = alloc.alloc(2)
    log.append(cache.insert(keys([1, 2, 7, 8]), [a[0], b[0]]))
    log.append(cache.insert(keys([9, 9, 8, 8]), b))
    for toks, width in (([1, 2, 3, 4, 5, 6], 6), ([1, 2, 3, 4, 5, 6], 7),
                        ([1, 2, 7, 8], 5), ([9, 9, 8, 8, 1, 1], 7),
                        ([5, 5], 3)):
        log.append(cache.match(keys(toks), width))
    for blk in a + [b[0], b[1]]:
        log.append(cache.release(blk))
    log.append(cache.release(alloc.alloc(1)[0]))    # untracked
    cache.acquire([a[0], a[1]])
    log.append(cache.evict(2))
    log.append(cache.evict(5))
    cache.release(a[0])
    cache.release(a[1])
    log.append(cache.evict(1))
    cache.record(13, 8)
    log += [dict(cache.refcounts), list(cache.evictable_blocks),
            cache.stats(), alloc.n_free, sorted(alloc._free)]
    return log


def test_prefix_cache_sequence_equals_reference():
    assert _script(pc, sched.BlockAllocator) == \
        _script(jpc, jsched.BlockAllocator)


def test_radix_match_insert_and_refcounts():
    """The reference's unit case on the port's copy."""
    alloc = sched.BlockAllocator(10)
    cache = pc.PrefixCache(alloc, 4)
    toks = list(range(12))
    keys = pc.block_keys(np.asarray(toks, np.int32), {}, 4, 3)
    assert cache.match(keys, 12) == []
    blocks = alloc.alloc(3)
    assert cache.insert(keys, blocks) == 3
    assert cache.match(keys, 12) == blocks[:2]     # capped: >= 1 re-prefilled
    assert cache.match(keys, 13) == blocks[:3]
    for b in blocks:
        assert cache.release(b)
    assert cache.n_evictable == 3 and cache.n_cached == 3
    assert not cache.release(alloc.alloc(1)[0])
    cache.acquire(blocks[:2])
    assert cache.n_evictable == 1


def test_radix_eviction_is_lru_and_leaves_first():
    """The reference's unit case on the port's copy."""
    def keys(t):
        return pc.block_keys(np.asarray(t, np.int32), {}, 2, 2)
    alloc = sched.BlockAllocator(8)
    cache = pc.PrefixCache(alloc, 2)
    a = alloc.alloc(2)
    cache.insert(keys([1, 2, 3, 4]), a)
    b = alloc.alloc(2)
    cache.insert(keys([5, 6, 7, 8]), b)
    for blk in a + b:
        cache.release(blk)
    assert cache.evict(1) == 1 and a[1] not in cache._by_block
    assert cache.match(keys([1, 2, 3, 4]), 5) == [a[0]]
    cache.acquire([a[0]])
    cache.release(a[0])
    assert cache.evict(2) == 2
    assert cache.n_cached == 1 and alloc.n_free == 6


# ---------------------------------------------------------------------------
# Serving: cached ≡ uncached ≡ the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", ["dense", "vlm"])
@pytest.mark.parametrize("strategy", ["top1", "mixture"])
def test_cached_matches_uncached_and_reference(request, family, strategy):
    dep = request.getfixturevalue(family)
    eng = port_engine(dep, strategy, prefix_cache=True)
    got = drive(eng, SamplingParams, dep)
    assert got == drive(port_engine(dep, strategy), SamplingParams, dep)
    jeng = ref_engine(dep, strategy, prefix_cache=True)
    assert got == drive(jeng, japi.SamplingParams, dep)
    assert {r for _, r in got.values()} == {"length"}
    occ = eng.occupancy()
    assert occ == jeng.occupancy()
    # requests 0 and 1 prefill side by side (both miss); 2 and the repeat
    # of 0 each skip at least the full shared blocks (the vlm's 16 image
    # rows add 2 blocks to each hit)
    shared_blocks = (SHARED + (dep["cfg"].n_patches if family == "vlm"
                               else 0)) // BLOCK
    assert sum(p["prefix_skipped_tokens"] for p in occ) >= \
        2 * shared_blocks * BLOCK
    for pod in eng.pods:
        assert pod.prefix is not None
        assert pod.allocator.n_free == \
            pod.allocator.n_blocks - 1 - pod.prefix.n_cached


def test_pool_pressure_evicts_lru_not_the_matched_run(dense):
    """A pool of 5 blocks: request 1 (8 tokens) evicts what request 0's
    chain left, request 2 shares request 0's first two blocks again; the
    matched run is pinned before the eviction runs. Tokens, finish
    reasons and counters equal the reference's."""
    rng = np.random.default_rng(14)
    cfg = dense["cfg"]
    a = rng.integers(0, cfg.vocab, 16).astype(np.int32)
    x = rng.integers(0, cfg.vocab, 8).astype(np.int32)
    b = np.concatenate([a, rng.integers(0, cfg.vocab, 10).astype(np.int32)])
    dep = dict(dense, prompts=[a, x, b], extras=[{}] * 3,
               feats=np.repeat(dense["cent"][:1], 3, 0))
    over = dict(n_slots=1, pool_blocks=5)
    got, want = [], []
    for eng, sp, out in ((port_engine, SamplingParams, got),
                         (ref_engine, japi.SamplingParams, want)):
        e = eng(dep, prefix_cache=True, **over)
        for rid in range(3):             # one at a time: each retires
            out.append(drive(e, sp, dep, rids=[rid]))
        out.append(e.occupancy())
    assert got == want
    pod = got[-1][0]
    assert pod["prefix_evicted_blocks"] >= 1
    assert pod["prefix_skipped_tokens"] == 16


def test_hybrid_family_degrades_to_uncached():
    """Zamba2's recurrent state is not in the pool: asked for the cache,
    every pod takes the uncached path with the same tokens."""
    jm = jax_build(jax_smoke("zamba2_2_7b"))
    experts = [from_tree(jax.tree.map(np.asarray, jm.init(
        jax.random.PRNGKey(k)))) for k in range(K)]
    rng = np.random.default_rng(5)
    shared = rng.integers(0, jm.cfg.vocab, 17).astype(np.int32)
    dep = dict(texperts=experts, cent=rng.normal(size=(K, FEAT))
               .astype(np.float32), cache_len=48, cfg=jm.cfg,
               arch="zamba2_2_7b",
               prompts=[np.concatenate([shared, s]) for s in (
                   rng.integers(0, jm.cfg.vocab, (3, 5)).astype(np.int32))],
               extras=[{}] * 3)
    dep["feats"] = np.repeat(dep["cent"][:1], 3, 0)
    over = dict(chunk=16)
    eng = port_engine(dep, prefix_cache=True, **over)
    assert all(pod.prefix is None for pod in eng.pods)
    got = drive(eng, SamplingParams, dep)
    assert got == drive(port_engine(dep, **over), SamplingParams, dep)
    assert "prefix_lookups" not in eng.occupancy()[0]
