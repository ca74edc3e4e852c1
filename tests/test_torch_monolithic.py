"""The monolithic-admission slice against the JAX reference: the top-1
deployment over 2 expert pods with monolithic prefill at admission, on
contiguous per-slot caches and on the paged pool, plus a sliding-window
(ring) model on both, must emit exactly the reference's greedy tokens,
finish reasons and per-request routing on the same weights, greedy and
(the ``-sampled`` cases) with seeded sampling on every other request.
Inside the port, paged ≡ contiguous and chunked ≡ monolithic hold
exactly.
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
from repro.serve.scheduler import make_engine as jax_make_engine  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.router import CentroidRouter  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serve.api import EngineConfig, SamplingParams  # noqa: E402
from repro_torch.serve.scheduler import make_engine  # noqa: E402
from repro_torch.weights import from_tree  # noqa: E402

CACHE_LEN = 40
# the last prompt fills the context: it retires at admission with its one
# prefill token ("truncated"); 30 + 12 runs past cache_len → truncated
LENS = [5, 13, 19, 8, 30, 3, 16, CACHE_LEN]
WINDOW = 8             # tests/test_paged.py's ring config: most prompts are
#                        longer, so prefill rolls the ring and decode wraps
MONOLITHIC = dict(n_slots=2, cache_len=CACHE_LEN, chunked_prefill=False)
PAGED = dict(paged=True, page_block=8)


@pytest.fixture(scope="module")
def deployment():
    jm = jax_build(jax_smoke("qwen3_8b"))
    jexperts = [jm.init(jax.random.PRNGKey(k)) for k in (0, 1)]
    rng = np.random.default_rng(11)
    cent = rng.normal(size=(2, 32)).astype(np.float32)
    prompts = [rng.integers(0, 512, n).astype(np.int32) for n in LENS]
    feats = rng.normal(size=(len(LENS), 32)).astype(np.float32)
    texperts = [from_tree(jax.tree.map(np.asarray, p)) for p in jexperts]
    return jexperts, texperts, cent, prompts, feats


def _drive(engine, sp_cls, prompts, feats, sampled=False):
    # request 5's whole budget is its prefill token: it retires from its
    # slot at admission ("length"); sampled, odd requests draw at
    # temperature 0.9 (top_k 0 and 50)
    for i, p in enumerate(prompts):
        samp = dict(temperature=0.9, top_k=50 * (i % 4 == 3),
                    seed=31 * i) if sampled and i % 2 else {}
        engine.add_request(p, sp_cls(max_new=1 if i == 5 else 12, **samp),
                           features=feats[i], rid=i)
    routing = [[r.rid for r in pod.waiting] for pod in engine.pods]
    res = {}
    while engine.has_unfinished():
        for o in engine.step():
            if o.finished:
                res[o.rid] = (o.token_ids, o.finish_reason)
    return res, routing


def _port(deployment, window=0, sampled=False, **ecfg):
    _, texperts, cent, prompts, feats = deployment
    model = build_model(get_smoke_config("qwen3_8b")
                        .reduced(sliding_window=window))
    return _drive(make_engine(model, experts=texperts,
                              router=CentroidRouter(torch.as_tensor(cent)),
                              config=EngineConfig(**ecfg), device="cpu"),
                  SamplingParams, prompts, feats, sampled)


@pytest.mark.parametrize("window,paged,sampled", [
    (0, False, False), (0, True, False), (WINDOW, False, False),
    (WINDOW, True, False), (0, False, True), (0, True, True)],
    ids=["contiguous", "paged", "ring-contiguous", "ring-paged",
         "contiguous-sampled", "paged-sampled"])
def test_monolithic_slice_matches_reference_token_for_token(deployment,
                                                            window, paged,
                                                            sampled):
    jexperts, _, cent, prompts, feats = deployment
    ecfg = dict(MONOLITHIC, **(PAGED if paged else {}))
    got, got_route = _port(deployment, window, sampled, **ecfg)
    jm = jax_build(jax_smoke("qwen3_8b").reduced(sliding_window=window))
    jeng = jax_make_engine(
        jm, experts=jexperts,
        router=JaxRouter(jnp.asarray(cent), JaxRouterConfig()),
        config=japi.EngineConfig(**ecfg))
    want, want_route = _drive(jeng, japi.SamplingParams, prompts, feats,
                              sampled)
    assert got_route == want_route and all(got_route)
    assert got == want
    assert {r for _, r in got.values()} == {"length", "truncated"}
    assert got[len(LENS) - 1][1] == "truncated" \
        and len(got[len(LENS) - 1][0]) == 1       # retired at admission
    assert got[5][1] == "length" and len(got[5][0]) == 1


def test_paged_and_chunked_match_contiguous_monolithic(deployment):
    """The port's own invariants: the paged pool serves the contiguous
    cache's tokens, and chunked prefill serves monolithic prefill's, with
    the same finish reasons and routing."""
    base = _port(deployment, **MONOLITHIC)
    assert _port(deployment, **MONOLITHIC, **PAGED) == base
    assert _port(deployment, **dict(MONOLITHIC, chunked_prefill=True,
                                    chunk=8), **PAGED) == base
