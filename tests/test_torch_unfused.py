"""The port's unfused step (``fused_step=False``: the forward returns the
scores, the host epilogue picks the tokens and checks stop ids, budgets
and the context bound) against the JAX reference's own unfused step, on
the float32 smoke configs with the reference's weights carried across by
``repro_torch.weights``.

Each run serves 2 experts' deployment, with requests that straddle
chunks and blocks, one whose whole budget is its prefill token, one that
runs past the context (truncated), one that retires on a stop id and one
sampled request (temperature 0.8, seeded), so every finish reason and
both pickers (``argmax_tokens`` for an all-greedy step, the seeded
sampler otherwise) are exercised:

* dense (``qwen3_8b``) in every paged × chunked combination the
  reference serves (contiguous + chunked is refused by both, with one
  message), top-1 and the K = 2 mixture (top_k 2);
* hybrid (``zamba2_2_7b``), vlm (``internvl2_2b``, 16 patch rows a
  request) and moe (``deepseek_moe_16b``) paged + chunked, top-1.

Each port run emits exactly the reference's unfused tokens and finish
reasons, and exactly the port's own fused step's; so do swap and
recompute preemption under the PoolSanitizer. The registry's
``dispatch`` / ``device_get`` split is recorded on the unfused step, one
observation a step, as on the fused one.
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
from repro_torch.core.router import CentroidRouter, RouterConfig  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serve.api import EngineConfig, SamplingParams  # noqa: E402
from repro_torch.serve.scheduler import make_engine  # noqa: E402
from repro_torch.weights import from_tree  # noqa: E402

CACHE_LEN, FEAT = 32, 16
LENS = [5, 13, 19, 3, 26, 13]       # request 4 runs past the context
PAGED_CHUNKED = dict(paged=True, page_block=8, chunked_prefill=True,
                     chunk=16)
DENSE_CONFIGS = {"paged-chunked": PAGED_CHUNKED,
                 "paged-monolithic": dict(paged=True, page_block=8),
                 "contiguous-monolithic": {}}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module, restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_DEPLOYMENTS = {}


def deployment(arch):
    """2 experts of ``arch``'s smoke config, in both packages, with the
    prompts, vlm patches and routing features of the runs (built once)."""
    if arch not in _DEPLOYMENTS:
        jm = jax_build(jax_smoke(arch))
        jexperts = [jm.init(jax.random.PRNGKey(k)) for k in (0, 1)]
        cfg = jm.cfg
        rng = np.random.default_rng(31)
        extras = [{"patches": rng.normal(size=(cfg.n_patches,
                                               cfg.vision_dim))
                   .astype(np.float32)} if cfg.family == "vlm" else {}
                  for _ in LENS]
        _DEPLOYMENTS[arch] = dict(
            jm=jm, jexperts=jexperts,
            # the vlm family's image prefix counts in the context
            cache_len=CACHE_LEN + (cfg.n_patches if extras[0] else 0),
            texperts=[from_tree(jax.tree.map(np.asarray, p))
                      for p in jexperts],
            cent=rng.normal(size=(2, FEAT)).astype(np.float32),
            prompts=[rng.integers(0, cfg.vocab, n).astype(np.int32)
                     for n in LENS],
            extras=extras,
            feats=rng.normal(size=(len(LENS), FEAT)).astype(np.float32))
    return _DEPLOYMENTS[arch]


def _drive(engine, sp_cls, dep, stop=None):
    """Request 3's whole budget is its prefill token; request 2 retires on
    ``stop`` (a token it emits); request 0 samples at temperature 0.8."""
    for i, p in enumerate(dep["prompts"]):
        kw = dict(max_new=1 if i == 3 else 8)
        if i == 0:
            kw.update(temperature=0.8, top_k=40, seed=5)
        if i == 2 and stop is not None:
            kw["stop_token_ids"] = (stop,)
        engine.add_request(p, sp_cls(**kw), dep["extras"][i],
                           features=dep["feats"][i], rid=i)
    res = {}
    while engine.has_unfinished():
        for o in engine.step():
            if o.finished:
                res[o.rid] = (o.token_ids, o.finish_reason)
    return res


def _ecfg(strategy, fused, ecfg, cache_len=CACHE_LEN):
    return dict(n_slots=2, cache_len=cache_len, strategy=strategy,
                fused_step=fused, **ecfg)


def _port(dep, arch, strategy, fused, ecfg, **extra):
    router = CentroidRouter(torch.as_tensor(dep["cent"]), RouterConfig(
        top_k=2 if strategy == "mixture" else 1))
    return make_engine(build_model(get_smoke_config(arch)),
                       experts=dep["texperts"], router=router,
                       config=EngineConfig(**_ecfg(strategy, fused, ecfg,
                                                   dep["cache_len"]),
                                           **extra), device="cpu")


def check_unfused(arch, strategy, ecfg):
    dep = deployment(arch)
    stops = dep.setdefault("stops", {})
    if strategy not in stops:       # request 2's second token, unstopped
        free = _drive(_port(dep, arch, strategy, True, ecfg), SamplingParams,
                      dep)
        stops[strategy] = free[2][0][1]
    stop = stops[strategy]
    fused = _drive(_port(dep, arch, strategy, True, ecfg), SamplingParams,
                   dep, stop)
    unfused = _drive(_port(dep, arch, strategy, False, ecfg),
                     SamplingParams, dep, stop)
    router = JaxRouter(jnp.asarray(dep["cent"]), JaxRouterConfig(
        top_k=2 if strategy == "mixture" else 1))
    jeng = jax_make_engine(dep["jm"], experts=dep["jexperts"], router=router,
                           config=japi.EngineConfig(
                               **_ecfg(strategy, False, ecfg,
                                       dep["cache_len"])))
    want = _drive(jeng, japi.SamplingParams, dep, stop)
    assert unfused == want
    assert fused == unfused
    assert {r for _, r in want.values()} == {"stop", "length", "truncated"}
    assert len(want[3][0]) == 1


@pytest.mark.parametrize("strategy", ["top1", "mixture"])
@pytest.mark.parametrize("config", list(DENSE_CONFIGS))
def test_dense_unfused_matches_reference_and_fused(config, strategy):
    check_unfused("qwen3_8b", strategy, DENSE_CONFIGS[config])


def test_contiguous_chunked_is_refused_as_the_reference_refuses():
    cfg = _ecfg("top1", False, dict(chunked_prefill=True, chunk=16))
    with pytest.raises(ValueError) as want:
        japi.EngineConfig(**cfg).validate(jax_build(jax_smoke("qwen3_8b")))
    with pytest.raises(ValueError) as got:
        EngineConfig(**cfg).validate(build_model(get_smoke_config(
            "qwen3_8b")))
    assert str(got.value) == str(want.value)
    assert "enable paging" in str(got.value)


@pytest.mark.parametrize("arch", ["zamba2_2_7b", "internvl2_2b",
                                  "deepseek_moe_16b"])
def test_family_unfused_matches_reference_and_fused(arch):
    check_unfused(arch, "top1", PAGED_CHUNKED)


@pytest.mark.parametrize("strategy", ["top1", "mixture"])
def test_unfused_step_records_the_dispatch_device_get_split(strategy):
    """Every engine step that runs the device records one dispatch and one
    device_get observation in the registry (the step kinds' spans with
    tracing on), unfused as fused."""
    dep = deployment("qwen3_8b")
    for fused in (False, True):
        eng = _port(dep, "qwen3_8b", strategy, fused, PAGED_CHUNKED,
                    trace=True)
        _drive(eng, SamplingParams, dep)
        names = {m["name"] for m in eng.export_metrics()["metrics"]}
        assert {"serve_step_dispatch_seconds",
                "serve_step_device_get_seconds"} <= names
        for pod in eng.pods:
            obs = pod.obs
            assert obs.dispatch_s.count == obs.readback_s.count > 0
        spans = {e["name"] for e in eng.export_trace()["traceEvents"]}
        assert {"dispatch", "device_get", "step:decode", "step:chunk",
                "step:decode+chunk"} <= spans


@pytest.mark.parametrize("preemption", ["swap", "recompute"])
def test_unfused_preemption_under_the_sanitizer_matches_reference(
        preemption):
    """The unfused step parks and resumes like the reference's: a pool of 9
    blocks for 3 slots, alternating priorities, the PoolSanitizer on;
    tokens and finish reasons equal, and a request was parked."""
    dep = deployment("qwen3_8b")
    cfg = dict(n_slots=3, cache_len=48, paged=True, page_block=8,
               pool_blocks=9, chunked_prefill=True, chunk=8,
               fused_step=False, preemption=preemption, sanitize=True)

    def drive(engine, sp_cls):
        for i, p in enumerate(dep["prompts"]):
            engine.add_request(p, sp_cls(max_new=10, priority=i % 2),
                               features=dep["feats"][i], rid=i)
        res = {}
        while engine.has_unfinished():
            for o in engine.step():
                if o.finished:
                    res[o.rid] = (o.token_ids, o.finish_reason)
        return res

    port = make_engine(build_model(get_smoke_config("qwen3_8b")),
                       experts=dep["texperts"],
                       router=CentroidRouter(torch.as_tensor(dep["cent"])),
                       config=EngineConfig(**cfg), device="cpu")
    got = drive(port, SamplingParams)
    want = drive(jax_make_engine(
        dep["jm"], experts=dep["jexperts"],
        router=JaxRouter(jnp.asarray(dep["cent"]), JaxRouterConfig()),
        config=japi.EngineConfig(**cfg)), japi.SamplingParams)
    assert got == want
    assert sum(t["preemptions"] for p in port.pods
               for t in p.stats()["tenants"].values()) > 0
    assert all(p.stats()["sanitize_violations"] == 0 for p in port.pods)
