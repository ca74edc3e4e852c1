"""The port's serving slice against the JAX reference: the top-1
decentralized deployment over 2 expert pods with the paged pool, chunked
prefill and the fused decode step must emit exactly the reference's greedy
tokens, finish reasons and per-request routing on the same weights. Plus
the router, checkpoints, the default engine, the launcher twin, the
reference's dependency errors and the options the port refuses, and the
launcher twin under ``--strategy mixture`` against the reference
launcher. (The
monolithic paths are held against the reference in
``test_torch_monolithic.py``.)
"""
import dataclasses
import json
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
from repro.launch import serve as jax_launch_serve  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.serve import api as japi  # noqa: E402
from repro.serve.scheduler import make_engine as jax_make_engine  # noqa: E402
from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.router import CentroidRouter, RouterConfig  # noqa: E402
from repro_torch.launch import profile_serve  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serve.api import EngineConfig, SamplingParams  # noqa: E402
from repro_torch.serve.scheduler import BlockAllocator, make_engine  # noqa: E402
from repro_torch.weights import from_npz, from_tree, to_tensor  # noqa: E402

ECFG = dict(n_slots=2, cache_len=40, paged=True, page_block=8,
            chunked_prefill=True, chunk=8, fused_step=True)
LENS = [5, 13, 19, 8, 30, 3, 16]        # straddle chunks and blocks; 30 + 12
#                                        # runs past cache_len → truncated


@pytest.fixture(scope="module")
def deployment():
    jm = jax_build(jax_smoke("qwen3_8b"))
    jexperts = [jm.init(jax.random.PRNGKey(k)) for k in (0, 1)]
    rng = np.random.default_rng(0)
    cent = rng.normal(size=(2, 32)).astype(np.float32)
    prompts = [rng.integers(0, 512, n).astype(np.int32) for n in LENS]
    feats = rng.normal(size=(len(LENS), 32)).astype(np.float32)
    texperts = [from_tree(jax.tree.map(np.asarray, p)) for p in jexperts]
    return jm, jexperts, texperts, cent, prompts, feats


def _drive(engine, sp_cls, prompts, feats, stops):
    for i, p in enumerate(prompts):
        engine.add_request(p, sp_cls(max_new=12,
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
    _, _, texperts, cent, _, _ = deployment
    return make_engine(build_model(get_smoke_config("qwen3_8b")),
                       experts=texperts,
                       router=CentroidRouter(torch.as_tensor(cent)),
                       config=EngineConfig(**dict(ECFG, **over)),
                       device="cpu")


def test_top1_slice_matches_reference_token_for_token(deployment):
    jm, jexperts, _, cent, prompts, feats = deployment
    # stop ids: a token request 1 generates mid-stream, so it retires on
    # "stop" (the reference must agree on where)
    free, _ = _drive(_port_engine(deployment), SamplingParams, prompts,
                     feats, {})
    stops = {1: (free[1][0][4],), 3: (free[3][0][0],)}
    got, got_route = _drive(_port_engine(deployment), SamplingParams,
                            prompts, feats, stops)
    jeng = jax_make_engine(
        jm, experts=jexperts,
        router=JaxRouter(jnp.asarray(cent), JaxRouterConfig()),
        config=japi.EngineConfig(**ECFG, use_kernel=False))
    want, want_route = _drive(jeng, japi.SamplingParams, prompts, feats,
                              stops)
    assert got_route == want_route
    assert all(got_route)                # both pods serve traffic
    assert got == want
    reasons = {r for _, r in got.values()}
    assert {"stop", "length", "truncated"} <= reasons


@pytest.mark.parametrize("arch", ["qwen3_8b", "internvl2_2b",
                                  "deepseek_moe_16b", "zamba2_2_7b",
                                  "xlstm_125m", "whisper_small"])
def test_validate_refuses_unported_options(arch):
    """No family is refused any more: ``validate`` accepts each of the six
    families' smoke configs (dense, vlm, moe, hybrid, ssm, audio) in the
    paged + chunked config, as the reference's does (the recurrent
    families' chunk a multiple of their scan's)."""
    cfg = get_smoke_config(arch)
    ecfg = dict(ECFG, chunk=16) if cfg.family in ("hybrid", "ssm") else ECFG
    japi.EngineConfig(**ecfg).validate(jax_build(jax_smoke(arch)))
    EngineConfig(**ecfg).validate(build_model(cfg))


# each override takes the package's QoSConfig; window is the model's
# sliding window (0: none)
HOST_LAYER_OPTIONS = {
    "qos": (lambda Q: dict(qos=Q(tenant_weights=(("a", 2.0),),
                                 max_waiting=4)), 0),
    "preemption swap": (lambda Q: dict(preemption="swap"), 0),
    "preemption recompute": (lambda Q: dict(preemption="recompute"), 0),
    "prefix_cache": (lambda Q: dict(prefix_cache=True), 0),
    "sanitize": (lambda Q: dict(sanitize=True), 0),
    "trace": (lambda Q: dict(trace=True, trace_ring=8), 0),
    "metrics": (lambda Q: dict(metrics=True), 0),
    "prefix cache without paging": (
        lambda Q: dict(paged=False, chunked_prefill=False,
                       prefix_cache=True), 0),
    "prefix cache without chunked prefill": (
        lambda Q: dict(chunked_prefill=False, prefix_cache=True), 0),
    "recompute without chunked prefill": (
        lambda Q: dict(chunked_prefill=False, preemption="recompute"), 0),
    "swap without paging": (
        lambda Q: dict(paged=False, chunked_prefill=False,
                       preemption="swap"), 0),
    "sanitize without paging": (
        lambda Q: dict(paged=False, chunked_prefill=False, sanitize=True),
        0),
    "max_predicted_ttft_s without chunked prefill": (
        lambda Q: dict(chunked_prefill=False,
                       qos=Q(max_predicted_ttft_s=1.0)), 0),
    "max_waiting without chunked prefill": (
        lambda Q: dict(paged=False, chunked_prefill=False,
                       qos=Q(max_waiting=2)), 0),
    "trace_ring=0": (lambda Q: dict(trace=True, trace_ring=0), 0),
    "preemption on a sliding-window model": (
        lambda Q: dict(chunked_prefill=False, preemption="swap"), 8),
}


@pytest.mark.parametrize("option", list(HOST_LAYER_OPTIONS))
def test_validate_host_layer_options_as_reference(option):
    """The serving host layer's options: the port's ``validate`` accepts
    each where the reference's does and raises the reference's message
    where it raises (model-dependent checks included)."""
    from repro.serve.qos import QoSConfig as JaxQoS
    from repro_torch.serve.qos import QoSConfig
    over, window = HOST_LAYER_OPTIONS[option]
    jcfg = japi.EngineConfig(**dict(ECFG, **over(JaxQoS)))
    cfg = EngineConfig(**dict(ECFG, **over(QoSConfig)))
    jmodel = jax_build(jax_smoke("qwen3_8b").reduced(sliding_window=window))
    model = build_model(get_smoke_config("qwen3_8b").reduced(
        sliding_window=window))
    try:
        jcfg.validate(jmodel)
    except ValueError as want:
        with pytest.raises(ValueError) as got:
            cfg.validate(model)
        assert str(got.value) == str(want)
    else:
        cfg.validate(model)


@pytest.mark.parametrize("override,window", [
    (dict(paged=False), 0),                      # chunked prefill, no pool
    (dict(paged=False, chunked_prefill=False, pool_blocks=4), 0),
    (dict(chunked_prefill=False, token_budget=8), 0),
    (dict(), 8),                                 # chunked prefill, ring
])
def test_validate_dependency_errors_match_reference(override, window):
    """Combinations the reference refuses raise the reference's own
    message (model-dependent checks included)."""
    cfg = get_smoke_config("qwen3_8b").reduced(sliding_window=window)
    jcfg = jax_smoke("qwen3_8b").reduced(sliding_window=window)
    with pytest.raises(ValueError) as want:
        japi.EngineConfig(**dict(ECFG, **override)).validate(
            jax_build(jcfg))
    with pytest.raises(ValueError) as got:
        EngineConfig(**dict(ECFG, **override)).validate(build_model(cfg))
    assert str(got.value) == str(want.value)


def test_validate_refuses_other_families_and_sampling():
    """``build_model`` builds the audio family (``whisper_small``'s smoke
    config), hybrid training is still refused; seeded sampling is served,
    and the sampling controls the reference refuses (a negative top_k)
    are refused with its message."""
    model = build_model(get_smoke_config("whisper_small"))
    assert model.audio and model.speculative_capable \
        and model.prefix_cacheable
    hybrid = build_model(get_smoke_config("zamba2_2_7b"))
    params = hybrid.init(torch.Generator().manual_seed(0))
    for leaf in params["final_norm"], params["embed"]["embedding"]:
        leaf.requires_grad_()
    with pytest.raises(ValueError, match="training family 'hybrid' is not "
                                         "ported"):
        hybrid.forward(params, {"tokens": torch.zeros((1, 4),
                                                      dtype=torch.long)})
    sp = SamplingParams(temperature=0.7, top_k=5, seed=-3)
    assert (sp.temperature, sp.top_k, sp.seed) == (0.7, 5, -3)
    with pytest.raises(ValueError) as want:
        japi.SamplingParams(temperature=0.7, top_k=-1)
    with pytest.raises(ValueError) as got:
        SamplingParams(temperature=0.7, top_k=-1)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="cache_len must be >= 2"):
        EngineConfig(**dict(ECFG, cache_len=1)).validate()


def test_card_is_the_default_and_its_absence_raises(deployment):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        make_engine(build_model(get_smoke_config("qwen3_8b")),
                    experts=deployment[2],
                    router=CentroidRouter(torch.as_tensor(deployment[3])),
                    config=EngineConfig(**ECFG))


def test_single_model_engine_matches_its_pod(deployment):
    """make_engine(model, params) — one SlotServer — serves the requests
    the router sends to pod 0 exactly as pod 0 of the deployment does."""
    _, _, texperts, _, prompts, feats = deployment
    dec = _port_engine(deployment)
    res, routing = _drive(dec, SamplingParams, prompts, feats, {})
    single = make_engine(build_model(get_smoke_config("qwen3_8b")),
                         texperts[0], config=EngineConfig(**ECFG),
                         device="cpu")
    for rid in routing[0]:
        single.add_request(prompts[rid], SamplingParams(max_new=12), rid=rid)
    got = {}
    while single.has_unfinished():
        for o in single.step():
            if o.finished:
                got[o.rid] = (o.token_ids, o.finish_reason)
    assert got == {rid: res[rid] for rid in routing[0]}
    assert dec.occupancy()[0]["pool_free_blocks"] == \
        single.stats()["pool_free_blocks"]


def test_default_engine_config_is_the_ported_path(deployment):
    """EngineConfig() has the reference's defaults, and make_engine(model,
    params) without a config serves the reference's default path —
    contiguous caches, monolithic prefill, the fused step — token for
    token as the reference's make_engine(model, params) does."""
    jm, jexperts, texperts, _, prompts, _ = deployment
    defaults = {f.name: f.default for f in dataclasses.fields(EngineConfig)}
    want_defaults = {f.name: f.default
                     for f in dataclasses.fields(japi.EngineConfig)}
    assert defaults == {k: v for k, v in want_defaults.items()
                        if k != "use_kernel"}
    EngineConfig().validate()
    eng = make_engine(build_model(get_smoke_config("qwen3_8b")),
                      texperts[0], device="cpu")
    assert eng.config == EngineConfig()
    assert not eng.paged and not eng.chunked
    jeng = jax_make_engine(jm, jexperts[0])
    res = []
    for e, sp in ((eng, SamplingParams), (jeng, japi.SamplingParams)):
        for rid in (1, 4):
            e.add_request(prompts[rid], sp(max_new=4), rid=rid)
        out = {}
        while e.has_unfinished():
            out.update({o.rid: (o.token_ids, o.finish_reason)
                        for o in e.step() if o.finished})
        res.append(out)
    assert res[0] == res[1]
    assert {r for _, r in res[0].values()} == {"length"}
    assert eng.n_chunks == 0


def test_profile_script_rehearses_main_path_on_cpu():
    """``launch/profile_serve.py --smoke --device cpu``: both windows hold
    only steps of their kind (mixed prefill + decode, decode only), and
    every step is counted."""
    rep = profile_serve.main(["--smoke", "--device", "cpu"])
    assert rep["requests"] == 16
    assert sum(rep["steps_by_kind"].values()) == rep["steps"]
    assert rep["steps_by_kind"]["chunk"] >= 1
    for kind in ("mixed", "decode"):
        assert rep["windows"][kind]["kinds"] == [kind] * profile_serve.WINDOW
        assert rep["windows"][kind]["unprofiled_wall_ms"] > 0
    assert rep["run_busy_share_est"] == "not measured (CPU run)"


def test_abort_and_features_required(deployment):
    eng = _port_engine(deployment)
    prompts, feats = deployment[4], deployment[5]
    with pytest.raises(ValueError, match="pass features="):
        eng.add_request(prompts[0], SamplingParams(max_new=3))
    for i in range(3):
        eng.add_request(prompts[i], SamplingParams(max_new=6),
                        features=feats[i], rid=i)
    eng.step()
    outs = [eng.abort(i) for i in range(3)]
    assert all(o.finish_reason == "aborted" for o in outs)
    assert eng.abort(0) is None and not eng.has_unfinished()
    for pod in eng.pods:                  # every block back on the free list
        assert pod.allocator.n_free == pod.allocator.n_blocks - 1


def test_block_allocator_guards():
    a = BlockAllocator(4)
    assert a.alloc(5) is None and a.n_free == 3
    got = a.alloc(2)
    assert got == [1, 2]
    a.free([1])
    with pytest.raises(ValueError, match="double free"):
        a.free([1])
    with pytest.raises(ValueError, match="outside the pool"):
        a.free([0])
    with pytest.raises(ValueError, match="use-after-free"):
        a.assert_live(1, 0)


@pytest.mark.parametrize("top_k", [1, 2])
def test_router_matches_reference(top_k):
    rng = np.random.default_rng(5)
    cent = rng.normal(size=(3, 16)).astype(np.float32)
    x = rng.normal(size=(7, 16)).astype(np.float32)
    r = CentroidRouter(torch.as_tensor(cent), RouterConfig(10.0, top_k))
    jr = JaxRouter(jnp.asarray(cent), JaxRouterConfig(10.0, top_k))
    tx, jx = torch.as_tensor(x), jnp.asarray(x)
    np.testing.assert_allclose(r.cluster_probs(tx).numpy(),
                               np.asarray(jr.cluster_probs(jx)),
                               rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(r.route(tx).numpy(), np.asarray(jr.route(jx)),
                               rtol=2e-5, atol=2e-6)
    np.testing.assert_array_equal(r.top1(tx).numpy(), np.asarray(jr.top1(jx)))


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory, deployment):
    """A training run dir written by the REFERENCE's checkpoint code."""
    out = str(tmp_path_factory.mktemp("run"))
    for k in range(2):
        jckpt.save_expert(out, k, 10, {"params": deployment[1][k]})
    jckpt.save_router(out, deployment[3], 10.0, 1)
    return out


def test_checkpoints_written_by_reference_load(run_dir, deployment):
    state, step = ckpt.restore_expert(run_dir, 1)
    assert step == 10
    params = from_tree(state["params"])
    want = deployment[2][1]
    got_npz = from_npz(f"{run_dir}/expert_1/step_10.npz")
    for tree in (params, got_npz):
        assert torch.equal(tree["final_norm"], want["final_norm"])
        assert torch.equal(tree["blocks"]["attn"]["wq"],
                           want["blocks"]["attn"]["wq"])
    cent, tau, top_k = ckpt.load_router(run_dir)
    np.testing.assert_array_equal(cent, deployment[3])
    assert (tau, top_k) == (10.0, 1)
    assert ckpt.restore_expert(run_dir, 2) == (None, None)


def test_launcher_twin_serves_and_refuses(run_dir, capsys, monkeypatch):
    """Without --paged/--chunked-prefill the twin serves the contiguous,
    monolithic path, and the paged + chunked run gives the same tokens.
    With ``--strategy mixture --top-k 2`` it streams the reference
    launcher's tokens, paged + chunked and contiguous."""
    base = ["--run", run_dir, "--requests", "3", "--prompt-len", "10",
            "--new-tokens", "5", "--slots", "2", "--device", "cpu"]
    chunked = ["--paged", "--page-block", "8", "--chunked-prefill",
               "--prefill-chunk", "8"]
    report = launch_serve.main(base + chunked)
    assert report["finish_reasons"] == ["length"] * 3
    assert all(len(t) == 5 for t in report["tokens"].values())
    plain = launch_serve.main(base)
    assert "pool_blocks" not in plain["pods"][0]
    assert plain["tokens"] == report["tokens"]
    # the unfused step serves the same tokens; a flag combination the
    # reference refuses is refused with its message
    assert launch_serve.main(base + chunked + ["--no-fused-step"])[
        "tokens"] == report["tokens"]
    with pytest.raises(ValueError, match="enable paging"):
        launch_serve.main(base + ["--chunked-prefill", "--prefill-chunk",
                                  "8"])
    mixture = ["--strategy", "mixture", "--top-k", "2"]
    monkeypatch.setattr("sys.argv", ["serve"] + base[:-2] + chunked + mixture
                        + ["--stream"])
    jax_launch_serve.main()
    want = {}
    for rid, toks in re.findall(r"rid=\s*(\d+) \+(\[[^\]]*\])",
                                capsys.readouterr().out):
        want.setdefault(int(rid), []).extend(eval(toks))
    assert len(want) == 3
    mixed = launch_serve.main(base + chunked + mixture)
    assert mixed["tokens"] == want and len(mixed["pods"]) == 1   # one core
    assert launch_serve.main(base + mixture)["tokens"] == want


def test_launcher_twin_serves_the_host_layer(run_dir, tmp_path, capsys,
                                            monkeypatch):
    """The prefix cache, preemption under a small pool with two tenants
    and two priorities, the sanitizer and both exports: the twin gives the
    plain paged + chunked tokens, as the reference launcher does with the
    same flags, and writes a trace with one pid per pod and a metrics
    snapshot."""
    base = ["--run", run_dir, "--requests", "4", "--prompt-len", "10",
            "--new-tokens", "5", "--slots", "2", "--paged", "--page-block",
            "8", "--chunked-prefill", "--prefill-chunk", "8"]
    host = ["--prefix-cache", "--preemption", "swap", "--pool-blocks", "4",
            "--priorities", "0", "--priorities", "0", "--priorities", "1",
            "--priorities", "1", "--tenants", "2",
            "--tenant-weight", "tenant-1=3", "--sanitize"]
    trace, metrics = tmp_path / "trace.json", tmp_path / "metrics.json"
    plain = launch_serve.main(base + ["--device", "cpu"])
    got = launch_serve.main(base + host + [
        "--device", "cpu", "--trace-out", str(trace),
        "--metrics-out", str(metrics)])
    assert got["tokens"] == plain["tokens"]
    assert got["finish_reasons"] == ["length"] * 4
    assert sum(sum(t["preemptions"] for t in p["tenants"].values())
               for p in got["pods"]) > 0
    doc = json.loads(trace.read_text())
    assert {e["pid"] for e in doc["traceEvents"]} == {0, 1}
    names = {m["name"] for m in json.loads(metrics.read_text())["metrics"]}
    assert {"serve_step_dispatch_seconds", "serve_preemptions_total",
            "serve_prefix_lookups_total"} <= names
    capsys.readouterr()
    monkeypatch.setattr("sys.argv", ["serve"] + base + host + ["--stream"])
    jax_launch_serve.main()
    want = {}
    for rid, toks in re.findall(r"rid=\s*(\d+) \+(\[[^\]]*\])",
                                capsys.readouterr().out):
        want.setdefault(int(rid), []).extend(eval(toks))
    assert want == got["tokens"]


def test_bfloat16_weights_cross_bit_exactly():
    vals = [1.5, -2.25, 3.0e-3, 65280.0]
    t = to_tensor(np.asarray(jnp.asarray(vals, jnp.bfloat16)))
    assert t.dtype == torch.bfloat16
    assert torch.equal(t, torch.tensor(vals, dtype=torch.bfloat16))
