"""The moe family served by the port against the JAX reference's engines,
top-1: the float32 ``deepseek_moe_16b`` smoke config (4 routed experts,
top-2, one shared expert), 2 decentralized experts carried across from the
reference's pytrees by ``repro_torch.weights``.

Each configuration runs at the smoke config's capacity factor 8.0 and at
1.0, where pairs are dropped. A row's capacity is set by its width at the
call site (``moe.py``), so at 1.0 the reference's own chunked prefill and
monolithic prefill give different tokens, which the test asserts: the
port matches the reference there because it drops the same pairs at each
site, not because the sites agree. At 8.0 nothing is dropped and the two
prefills agree, as the reference's chunked ≡ monolithic test holds.

Token for token, finish reason for finish reason and, where speculating,
spec counter for spec counter, the ``DecentralizedSlotServer`` in paged +
chunked, paged + monolithic and contiguous + monolithic serving and with
n-gram speculation; request 1 is sampled, seeded, in every run. The
Eq. 27 mixture, expert-0 drafting and the prefix cache are
``test_torch_moe_mixture.py``'s, which imports the helpers here (the two
modules each stay near a minute alone: the reference compiles its engine
anew for every run).
"""
from dataclasses import replace

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
from repro.serve.scheduler import make_engine as jax_make_engine  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.router import CentroidRouter, RouterConfig  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serve.api import EngineConfig, SamplingParams  # noqa: E402
from repro_torch.serve.scheduler import make_engine  # noqa: E402
from repro_torch.weights import from_tree  # noqa: E402

ARCH = "deepseek_moe_16b"
K, FEAT, CACHE_LEN, BLOCK, CHUNK, SPEC_LEN = 2, 16, 40, 8, 8, 4
LENS = [7, 11, 5, 19, 30]             # 30 + 12 runs past the context
SHARED, SUFFIXES = 19, (6, 9, 6)      # the prefix-cache traffic
CFS = [8.0, 1.0]
CHUNKED = dict(paged=True, page_block=BLOCK, chunked_prefill=True,
               chunk=CHUNK)
CONFIGS = {
    "paged-chunked": ("top1", CHUNKED),
    "paged-monolithic": ("top1", dict(paged=True, page_block=BLOCK)),
    "contiguous-monolithic": ("top1", {}),
    "paged-chunked-ngram": ("top1", dict(CHUNKED, speculative="ngram",
                                         spec_len=SPEC_LEN)),
    "mixture-paged-chunked": ("mixture", CHUNKED),
    "mixture-paged-chunked-expert": ("mixture", dict(
        CHUNKED, speculative="expert", spec_len=SPEC_LEN)),
    "paged-chunked-prefix": ("top1", dict(CHUNKED, prefix_cache=True)),
}
TOP1_KINDS = ["paged-chunked", "paged-monolithic", "contiguous-monolithic",
              "paged-chunked-ngram"]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def with_cf(cfg, cf):
    return replace(cfg, moe=replace(cfg.moe, capacity_factor=cf))


@pytest.fixture(scope="module")
def dep():
    jm = jax_build(jax_smoke(ARCH))
    jexperts = [jm.init(jax.random.PRNGKey(k)) for k in range(K)]
    rng = np.random.default_rng(25)
    vocab = jm.cfg.vocab
    cent = rng.normal(size=(K, FEAT)).astype(np.float32)
    shared = rng.integers(0, vocab, SHARED).astype(np.int32)
    prefixed = [np.concatenate([shared, rng.integers(0, vocab, n)
                                .astype(np.int32)]) for n in SUFFIXES]
    return dict(
        jexperts=jexperts,
        texperts=[from_tree(jax.tree.map(np.asarray, p)) for p in jexperts],
        cent=cent,
        prompts=[rng.integers(0, vocab, n).astype(np.int32) for n in LENS],
        prefixed=prefixed + [prefixed[0]],        # an exact repeat of 0
        feats=rng.normal(size=(len(LENS), FEAT)).astype(np.float32))


def params(i, sp_cls):
    samp = dict(temperature=0.7, top_k=40, seed=90) if i == 1 else {}
    return sp_cls(max_new=12, **samp)


def drive(engine, sp_cls, dep, kind):
    prompts = dep["prefixed"] if kind.endswith("prefix") else dep["prompts"]
    # the prefix traffic all routes to one pod: the first centroid
    feats = np.repeat(dep["cent"][:1], len(prompts), 0) \
        if kind.endswith("prefix") else dep["feats"]
    for i, p in enumerate(prompts):
        engine.add_request(p, params(i, sp_cls), features=feats[i], rid=i)
    res = {}
    while engine.has_unfinished():
        for o in engine.step():
            if o.finished:
                res[o.rid] = (o.token_ids, o.finish_reason)
    pods = engine.occupancy()
    spec = tuple(sum(p.get(n, 0) for p in pods)
                 for n in ("spec_steps", "spec_tokens"))
    hits = sum(p.get("prefix_skipped_tokens", 0) for p in pods)
    return res, spec, hits


def run(dep, kind, cf, port):
    strategy, over = CONFIGS[kind]
    ecfg = dict(n_slots=2, cache_len=CACHE_LEN, strategy=strategy, **over)
    top_k = K if strategy == "mixture" else 1
    if port:
        return drive(make_engine(
            build_model(with_cf(get_smoke_config(ARCH), cf)),
            experts=dep["texperts"], device="cpu",
            router=CentroidRouter(torch.as_tensor(dep["cent"]),
                                  RouterConfig(top_k=top_k)),
            config=EngineConfig(**ecfg)), SamplingParams, dep, kind)
    return drive(jax_make_engine(
        jax_build(with_cf(jax_smoke(ARCH), cf)), experts=dep["jexperts"],
        router=JaxRouter(jnp.asarray(dep["cent"]),
                         JaxRouterConfig(top_k=top_k)),
        config=japi.EngineConfig(**ecfg)), japi.SamplingParams, dep, kind)


@pytest.fixture(scope="module")
def reference(dep):
    """The reference's runs, each made once for the module."""
    memo = {}

    def get(kind, cf):
        if (kind, cf) not in memo:
            memo[kind, cf] = run(dep, kind, cf, port=False)
        return memo[kind, cf]
    return get


def check_serving(dep, reference, kind, cf):
    want = reference(kind, cf)
    got = run(dep, kind, cf, port=True)
    assert got == want
    res, (spec_steps, spec_tokens), hits = got
    if "speculative" in CONFIGS[kind][1]:
        assert spec_steps > 0 and spec_tokens >= spec_steps
    if kind.endswith("prefix"):
        assert hits > 0
    else:
        assert "truncated" in {r for _, r in res.values()}


@pytest.mark.parametrize("cf", CFS)
@pytest.mark.parametrize("kind", TOP1_KINDS)
def test_moe_serves_as_the_reference(dep, reference, kind, cf):
    check_serving(dep, reference, kind, cf)


@pytest.mark.parametrize("cf", CFS)
def test_reference_drops_per_site(reference, cf):
    """At cf 1.0 the reference's chunked and monolithic prefills give
    different tokens (rows of other widths drop other pairs); at 8.0 none
    is dropped and they agree. The port matches both (above)."""
    chunked = reference("paged-chunked", cf)[0]
    mono = reference("paged-monolithic", cf)[0]
    assert (chunked == mono) == (cf == 8.0)
    assert mono == reference("contiguous-monolithic", cf)[0]
