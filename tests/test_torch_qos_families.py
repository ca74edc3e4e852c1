"""Preemption on the port's other served shapes against the JAX reference:
the Eq. 27 mixture (``qwen3_8b`` smoke, 2 experts stacked, one pool
carrying both experts' segments), the vlm family (``internvl2_2b`` smoke,
16 image-prefix rows ahead of every prompt) and the hybrid family
(``zamba2_2_7b`` smoke: its Mamba2 state and conv window are the slot's
direct cache leaves, its shared attention pages through the pool).

In each, two low-priority requests outgrow a small pool while decoding
and a high-priority one waits behind them, so the engine parks one
(greedy and seeded-sampled requests side by side). With
``preemption="swap"`` (the payload: every private block's rows of all
experts' segments, the slot's direct leaves and, under the mixture, its
router-weight row) and ``"recompute"`` (the resume re-prefills prompt
and output through chunked prefill), the port's ``serve()`` emits the
reference's tokens and finish reasons, preempts the same requests as
often and ends with the reference's ``stats()``; and the same tokens as
an unpressured run without preemption. Weights are carried across from
the reference's pytrees by ``repro_torch.weights``.
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
from repro.serve import scheduler as jsched  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.router import CentroidRouter, RouterConfig  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serve import scheduler as sched  # noqa: E402
from repro_torch.serve.api import EngineConfig, SamplingParams  # noqa: E402
from repro_torch.weights import from_tree  # noqa: E402

K, FEAT = 2, 8
# family → (arch, n_experts served, text lens, budgets, engine knobs)
CASES = {
    "mixture": ("qwen3_8b", K, (8, 8, 8), (6, 6, 4),
                dict(cache_len=32, page_block=4, pool_blocks=7, chunk=8,
                     strategy="mixture")),
    "vlm": ("internvl2_2b", 1, (4, 4, 4), (10, 10, 4),
            dict(cache_len=40, page_block=4, pool_blocks=13, chunk=8)),
    "hybrid": ("zamba2_2_7b", 1, (8, 8, 8), (6, 6, 4),
               dict(cache_len=32, page_block=4, pool_blocks=7, chunk=16)),
}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=list(CASES))
def dep(request):
    arch, k, lens, budgets, knobs = CASES[request.param]
    jm = jax_build(jax_smoke(arch))
    jexperts = [jm.init(jax.random.PRNGKey(i)) for i in range(k)]
    cfg = jm.cfg
    rng = np.random.default_rng(5)
    patches = [rng.normal(size=(cfg.n_patches, cfg.vision_dim))
               .astype(np.float32) for _ in lens] \
        if cfg.family == "vlm" else None
    return dict(
        name=request.param, arch=arch, jm=jm, jexperts=jexperts,
        texperts=[from_tree(jax.tree.map(np.asarray, p)) for p in jexperts],
        tm=build_model(get_smoke_config(arch)), vocab=cfg.vocab, lens=lens,
        budgets=budgets, knobs=knobs, patches=patches,
        cent=rng.normal(size=(K, FEAT)).astype(np.float32))


def queue(dep, port):
    """The reference's parity queue: two priority-0 requests, then a
    priority-2 one; odd ids sampled, seeded."""
    mod, sp_cls = (sched, SamplingParams) if port \
        else (jsched, japi.SamplingParams)
    rng = np.random.default_rng(3)
    reqs = []
    for i, (n, m, p) in enumerate(zip(dep["lens"], dep["budgets"],
                                      (0, 0, 2))):
        sp = sp_cls(max_new=m, temperature=0.8 * (i % 2), seed=100 + i,
                    priority=p)
        reqs.append(mod.Request(
            i, rng.integers(0, dep["vocab"], n).astype(np.int32), m,
            params=sp,
            features=np.linspace(-1.0, 1.0, FEAT).astype(np.float32)
            * (i + 1),
            extras={"patches": dep["patches"][i]} if dep["patches"]
            else {}))
    return reqs


def served(dep, port, **over):
    cfg = dict(n_slots=2, paged=True, chunked_prefill=True,
               **dict(dep["knobs"], **over))
    mixture = cfg.get("strategy") == "mixture"
    if port:
        model, ecls = dep["tm"], EngineConfig
        kw = dict(experts=dep["texperts"], router=CentroidRouter(
            torch.as_tensor(dep["cent"]), RouterConfig(top_k=K))) \
            if mixture else dict(params=dep["texperts"][0])
        eng = sched.make_engine(model, config=ecls(**cfg), device="cpu",
                                **kw)
    else:
        kw = dict(experts=dep["jexperts"], router=JaxRouter(
            jnp.asarray(dep["cent"]), JaxRouterConfig(top_k=K))) \
            if mixture else dict(params=dep["jexperts"][0])
        eng = jsched.make_engine(dep["jm"], config=japi.EngineConfig(**cfg),
                                 **kw)
    q = queue(dep, port)
    out = eng.serve(q)
    return (out, {r.rid: r.finish_reason for r in q},
            {r.rid: r.preemptions for r in q},
            [p.stats() for p in eng._engines()] if port
            else eng.occupancy() if mixture else [eng.stats()])


@pytest.mark.parametrize("mode", ["swap", "recompute"])
def test_preempt_resume_matches_reference(dep, mode):
    got = served(dep, True, preemption=mode)
    assert got == served(dep, False, preemption=mode)
    assert sum(got[2].values()) > 0, "no preemption: the check is vacuous"
    assert got[3][0]["parked"] == 0
    assert set(got[1].values()) == {"length"}
    free = served(dep, True, pool_blocks=0)
    assert got[0] == free[0]
