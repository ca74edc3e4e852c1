"""The port's whole-batch engines (``serve.engine.ServeEngine``,
``serve.ensemble_engine.DecentralizedServer``) and their key chain
against the JAX reference, on the float32 ``qwen3_8b`` smoke config with
the reference's weights carried across by ``repro_torch.weights``.

* ``core.prng``'s ``PRNGKey``, ``split`` and ``categorical`` bit for bit
  with ``jax.random`` (threefry, partitionable, as jax 0.9.0 runs it).
* ``ServeEngine.generate`` and ``DecentralizedServer``'s
  ``generate_top1`` and ``generate_mixture`` (3 experts, top_k 2): the
  reference's tokens exactly, greedy and sampled; ``mixture_next_probs``
  and ``ensemble_eval_nll`` within rtol 1e-4 (float32 summation order).
* The reference's two invariants, held on the port: greedy
  ``SlotServer.serve`` ≡ ``ServeEngine.generate(temperature=0)`` for
  every ported family, and the stacked mixture slot server ≡
  ``generate_mixture`` when every request fits in a slot.
* The launcher twin ``--engine batch``: the reference launcher's tokens,
  top-1 and mixture, greedy and sampled.
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
from repro.launch import serve as jax_launch_serve  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.serve import api as japi  # noqa: E402
from repro.serve.engine import ServeEngine as JaxServeEngine  # noqa: E402
from repro.serve.ensemble_engine import (  # noqa: E402
    DecentralizedServer as JaxDecentralizedServer)
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import ensemble, prng  # noqa: E402
from repro_torch.core.router import CentroidRouter, RouterConfig  # noqa: E402
from repro_torch.data.synthetic import (SyntheticConfig,  # noqa: E402
                                        SyntheticMultimodal)
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serve.api import EngineConfig, SamplingParams  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.serve.ensemble_engine import DecentralizedServer  # noqa: E402
from repro_torch.serve.scheduler import make_engine  # noqa: E402
from repro_torch.weights import from_tree  # noqa: E402

ARCH = "qwen3_8b"
K, FEAT, B, S, CACHE_LEN = 3, 16, 4, 10, 24
PROB_TOL = dict(rtol=1e-4, atol=1e-9)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module, restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _key(k):
    return [int(x) for x in np.asarray(k)]


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 5, -3])
def test_prng_key_split_and_categorical_match_jax(seed):
    """A chain of splits from ``PRNGKey(seed)``, each subkey drawing over
    logits of three shapes (the batch's rows share the key: the noise is
    drawn over the whole shape)."""
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    assert _key(jk) == [int(tk[0]), int(tk[1])]
    rng = np.random.default_rng(abs(seed) % 1000)
    for shape in ((3, 50), (1, 1000), (2, 3, 17)):
        jk, jsub = jax.random.split(jk)
        tk, tsub = prng.split(tk)
        assert _key(jk) == [int(tk[0]), int(tk[1])]
        assert _key(jsub) == [int(tsub[0]), int(tsub[1])]
        logits = rng.normal(size=shape).astype(np.float32) * 3
        want = jax.random.categorical(jsub, jnp.asarray(logits), axis=-1)
        got = prng.categorical(tsub, torch.as_tensor(logits))
        assert got.numpy().tolist() == np.asarray(want).tolist()
    three = prng.split(tk, 3)
    assert [[int(a), int(b)] for a, b in three] == \
        [_key(k) for k in jax.random.split(jk, 3)]


@pytest.fixture(scope="module")
def dep():
    jm = jax_build(jax_smoke(ARCH))
    jexperts = [jm.init(jax.random.PRNGKey(k)) for k in range(K)]
    rng = np.random.default_rng(1)
    cent = rng.normal(size=(K, FEAT)).astype(np.float32)
    toks = rng.integers(0, 512, (B, S)).astype(np.int32)
    feats = rng.normal(size=(B, FEAT)).astype(np.float32)
    labels = rng.integers(0, 512, (B, S)).astype(np.int32)
    jbatch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels),
              "features": jnp.asarray(feats)}
    tbatch = {"tokens": torch.as_tensor(toks),
              "labels": torch.as_tensor(labels),
              "features": torch.as_tensor(feats)}
    texperts = [from_tree(jax.tree.map(np.asarray, p)) for p in jexperts]
    jserver = JaxDecentralizedServer(
        jm, jexperts, JaxRouter(jnp.asarray(cent), JaxRouterConfig(top_k=2)),
        cache_len=CACHE_LEN)
    tserver = DecentralizedServer(
        build_model(get_smoke_config(ARCH)), texperts,
        CentroidRouter(torch.as_tensor(cent), RouterConfig(top_k=2)),
        cache_len=CACHE_LEN)
    return dict(jm=jm, jexperts=jexperts, texperts=texperts, cent=cent,
                toks=toks, feats=feats, jbatch=jbatch, tbatch=tbatch,
                jserver=jserver, tserver=tserver)


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_serve_engine_generate_matches_reference(dep, temperature):
    sp = dict(max_new=7, temperature=temperature, seed=11)
    want = JaxServeEngine(dep["jm"], CACHE_LEN).generate(
        dep["jexperts"][1], {"tokens": dep["jbatch"]["tokens"]},
        japi.SamplingParams(**sp))
    got = ServeEngine(build_model(get_smoke_config(ARCH)), CACHE_LEN) \
        .generate(dep["texperts"][1], {"tokens": dep["tbatch"]["tokens"]},
                  SamplingParams(**sp))
    assert got.dtype == torch.int32
    assert got.numpy().tolist() == np.asarray(want).tolist()
    # the (n_new, key, temperature) form, with a key of the caller's
    want = JaxServeEngine(dep["jm"], CACHE_LEN).generate(
        dep["jexperts"][1], {"tokens": dep["jbatch"]["tokens"]}, 3,
        jax.random.PRNGKey(4), temperature)
    got = ServeEngine(build_model(get_smoke_config(ARCH)), CACHE_LEN) \
        .generate(dep["texperts"][1], {"tokens": dep["tbatch"]["tokens"]},
                  3, prng.PRNGKey(4), temperature)
    assert got.numpy().tolist() == np.asarray(want).tolist()


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_decentralized_server_generation_matches_reference(dep,
                                                           temperature):
    sp = dict(max_new=6, temperature=temperature, seed=3)
    for name in ("generate_top1", "generate_mixture"):
        want = getattr(dep["jserver"], name)(dep["jbatch"],
                                             japi.SamplingParams(**sp))
        got = getattr(dep["tserver"], name)(dep["tbatch"],
                                            SamplingParams(**sp))
        assert np.asarray(got).tolist() == np.asarray(want).tolist(), name
    routes = np.asarray(dep["jserver"].router.top1(dep["jbatch"]["features"]))
    assert len(set(routes.tolist())) > 1        # more than one group


def test_mixture_probs_and_eval_nll_match_reference(dep):
    np.testing.assert_allclose(
        dep["tserver"].mixture_next_probs(dep["tbatch"]).numpy(),
        np.asarray(dep["jserver"].mixture_next_probs(dep["jbatch"])),
        **PROB_TOL)
    np.testing.assert_allclose(
        float(dep["tserver"].ensemble_eval_nll(dep["tbatch"])),
        float(dep["jserver"].ensemble_eval_nll(dep["jbatch"])), rtol=1e-4)


def test_ensemble_helpers_match_reference(dep):
    """``ensemble_next_token_probs`` over the router, and the leading-K
    stack: ``select_expert_params`` takes expert k back out, and
    ``stacked_cache_axes`` puts the expert axis after the layer dim."""
    from repro.core import ensemble as jens
    rng = np.random.default_rng(2)
    logits = rng.normal(size=(K, B, 64)).astype(np.float32)
    router = dep["tserver"].router
    np.testing.assert_allclose(
        ensemble.ensemble_next_token_probs(
            router, dep["tbatch"]["features"], torch.as_tensor(logits))
        .numpy(),
        np.asarray(jens.ensemble_next_token_probs(
            dep["jserver"].router, dep["jbatch"]["features"],
            jnp.asarray(logits))), **PROB_TOL)
    stacked = ensemble.stack_expert_params(dep["texperts"])
    assert stacked["final_norm"].shape == (K, 128)
    one = ensemble.select_expert_params(stacked, 2)
    assert torch.equal(one["blocks"]["attn"]["wq"],
                       dep["texperts"][2]["blocks"]["attn"]["wq"])
    cache = build_model(get_smoke_config(ARCH)).init_cache(2, 8, "cpu")
    assert ensemble.stacked_cache_axes(cache) == \
        jens.stacked_cache_axes(dep["jm"].init_cache(2, 8)) == \
        {"k": 1, "v": 1}


@pytest.mark.parametrize("arch", ["qwen3_8b", "deepseek_moe_16b",
                                  "internvl2_2b", "xlstm_125m",
                                  "zamba2_2_7b"])
def test_slot_server_equals_serve_engine_greedy(arch):
    """The reference's family-parity invariant on the port: greedy
    ``SlotServer.serve`` (2 slots, 3 requests) ≡ ``ServeEngine.generate(
    temperature=0)`` of each request alone."""
    cfg = get_smoke_config(arch).reduced(vocab=256)
    model = build_model(cfg)
    params = from_tree(jax.tree.map(np.asarray, jax_build(
        jax_smoke(arch).reduced(vocab=256)).init(jax.random.PRNGKey(0))))
    rng = np.random.default_rng(42)
    reqs = []
    for n, m in zip((7, 11, 5), (4, 3, 5)):
        extras = {"patches": rng.normal(size=(cfg.n_patches, cfg.vision_dim))
                  .astype(np.float32)} if cfg.family == "vlm" else {}
        reqs.append((rng.integers(0, 256, n).astype(np.int32), m, extras))
    engine = ServeEngine(model, 40)
    want = {}
    for rid, (toks, m, extras) in enumerate(reqs):
        batch = {"tokens": torch.as_tensor(toks[None])}
        batch.update({k: torch.as_tensor(v[None]) for k, v in extras.items()})
        want[rid] = engine.generate(params, batch, m, prng.PRNGKey(1),
                                    temperature=0.0)[0].tolist()
    server = make_engine(model, params,
                         config=EngineConfig(n_slots=2, cache_len=40),
                         device="cpu")
    for rid, (toks, m, extras) in enumerate(reqs):
        server.add_request(toks, SamplingParams(max_new=m), extras, rid=rid)
    got = {}
    while server.has_unfinished():
        for o in server.step():
            if o.finished:
                got[o.rid] = o.token_ids
    assert got == want
    assert server.active == []


def test_mixture_slot_server_equals_generate_mixture(dep):
    """The reference's second invariant on the port: the stacked mixture
    slot server (every request in a slot) ≡ the whole-batch
    ``generate_mixture`` at temperature 0."""
    server = make_engine(
        build_model(get_smoke_config(ARCH)), experts=dep["texperts"],
        router=dep["tserver"].router,
        config=EngineConfig(n_slots=B, cache_len=CACHE_LEN,
                            strategy="mixture"), device="cpu")
    for i in range(B):
        server.add_request(dep["toks"][i], SamplingParams(max_new=5),
                           features=dep["feats"][i], rid=i)
    got = {}
    while server.has_unfinished():
        for o in server.step():
            if o.finished:
                got[o.rid] = o.token_ids
    want = dep["tserver"].generate_mixture(dep["tbatch"], 5,
                                           prng.PRNGKey(0), temperature=0.0)
    assert got == {i: want[i].tolist() for i in range(B)}


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory, dep):
    """A run dir written by the REFERENCE's checkpoint code, its router
    over the synthetic corpus's feature width."""
    out = str(tmp_path_factory.mktemp("batch_run"))
    for k in range(2):
        jckpt.save_expert(out, k, 10, {"params": dep["jexperts"][k]})
    dim = SyntheticMultimodal(SyntheticConfig(vocab=512, seq_len=8, seed=7)) \
        .sample_batch(2, step=0)["features"].shape[1]
    cent = np.random.default_rng(5).normal(size=(2, dim)).astype(np.float32)
    jckpt.save_router(out, cent, 10.0, 1)
    return out


@pytest.mark.parametrize("strategy,temperature", [
    ("top1", 0.0), ("top1", 0.7), ("mixture", 0.0), ("mixture", 0.7)])
def test_launcher_batch_engine_matches_reference_launcher(
        run_dir, capsys, monkeypatch, strategy, temperature):
    """``--engine batch``: the reference launcher prints each of the first
    four requests' whole generation (5 tokens); the twin's match."""
    args = ["--run", run_dir, "--engine", "batch", "--requests", "4",
            "--prompt-len", "8", "--new-tokens", "5", "--strategy", strategy,
            "--top-k", "2", "--temperature", str(temperature)]
    monkeypatch.setattr("sys.argv", ["serve"] + args)
    jax_launch_serve.main()
    want = {int(i): eval(g) for i, g in re.findall(
        r"req (\d+) → expert \d+: prompt=\[[^\]]*\]… gen=(\[[^\]]*\])…",
        capsys.readouterr().out)}
    report = launch_serve.main(args + ["--device", "cpu"])
    assert report["tokens"] == want and len(want) == 4
    assert report["engine"] == "batch" and report["pods"] is None
