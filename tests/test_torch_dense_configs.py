"""The dense family's other three configs against the JAX reference:
Granite-3-8B (its embedding table tied to the unembedding), Llama-3-405B
(rotary base 5e5) and Phi-3-medium-14B (dh 40), each as its float32
smoke config with 2 experts carried across from the reference's pytrees
by ``repro_torch.weights``.

Serving: the top-1 ``DecentralizedSlotServer``, paged + chunked, emits
exactly the reference's tokens and finish reasons (length and truncated
among them), one of the six requests sampled, seeded (the Eq. 27
mixture's twin is ``test_torch_dense_configs_mixture.py``, which imports
the helpers here). Training: ``Model.loss`` and its
gradient against ``jax.grad`` (``test_torch_vlm.check_loss_and_grads``:
the loss to 1e-5 relative, every leaf within 5e-4 of its largest element;
Llama's and Phi's smoke configs have no qk-norm, so their float32
gradients carry the summation order magnified as that module states,
measured up to 1.4e-4), then one ``make_train_step`` on the same batch,
whose loss and grad norm must be the reference's within 1e-5 and 1e-4
relative. Granite's tied table takes the sum of its two uses' gradients:
the tied gradient equals the embedding's plus the transposed
unembedding's of the same model untied, within 1e-6 of its largest
element (the same products summed in another order). ``rope_freqs`` at
Llama's base 5e5 equals the reference's in float32 to 1 ulp, and
``apply_rope`` there matches within rtol = atol = 2e-5 at positions up to
the vlm main path's 1344.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_vlm import (check_loss_and_grads,  # noqa: E402
                            port_loss_and_grads)

from repro.configs.base import get_smoke_config as jax_smoke  # noqa: E402
from repro.core.router import CentroidRouter as JaxRouter  # noqa: E402
from repro.core.router import RouterConfig as JaxRouterConfig  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.serve import api as japi  # noqa: E402
from repro.serve.scheduler import make_engine as jax_make_engine  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.router import CentroidRouter, RouterConfig  # noqa: E402
from repro_torch.models import build_model, layers  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.serve.api import EngineConfig, SamplingParams  # noqa: E402
from repro_torch.serve.scheduler import make_engine  # noqa: E402
from repro_torch.train import trainer  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402
from repro_torch.weights import from_tree  # noqa: E402

ARCHS = ["granite_3_8b", "llama3_405b", "phi3_medium_14b"]
K, FEAT, CACHE_LEN = 2, 16, 40
LENS = [5, 13, 19, 8, 30, 3]          # 30 + 12 runs past the context
ECFG = dict(n_slots=2, cache_len=CACHE_LEN, paged=True, page_block=8,
            chunked_prefill=True, chunk=8)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def build_dep(arch):
    jm = jax_build(jax_smoke(arch))
    jexperts = [jm.init(jax.random.PRNGKey(k)) for k in range(K)]
    rng = np.random.default_rng(21)
    return dict(
        arch=arch, jm=jm, jexperts=jexperts,
        texperts=[from_tree(jax.tree.map(np.asarray, p)) for p in jexperts],
        cent=rng.normal(size=(K, FEAT)).astype(np.float32),
        prompts=[rng.integers(0, 512, n).astype(np.int32) for n in LENS],
        feats=rng.normal(size=(len(LENS), FEAT)).astype(np.float32))


def drive(engine, sp_cls, dep):
    for i, p in enumerate(dep["prompts"]):
        samp = dict(temperature=0.7, top_k=40, seed=70) if i == 1 else {}
        engine.add_request(p, sp_cls(max_new=12, **samp),
                           features=dep["feats"][i], rid=i)
    res = {}
    while engine.has_unfinished():
        for o in engine.step():
            if o.finished:
                res[o.rid] = (o.token_ids, o.finish_reason)
    return res


def check_serving(dep, strategy):
    """Tokens and finish reasons of the port's paged + chunked engine of
    ``strategy`` against the reference's."""
    got = drive(make_engine(
        build_model(get_smoke_config(dep["arch"])), experts=dep["texperts"],
        router=CentroidRouter(torch.as_tensor(dep["cent"]),
                              RouterConfig(top_k=2)),
        config=EngineConfig(strategy=strategy, **ECFG), device="cpu"),
        SamplingParams, dep)
    want = drive(jax_make_engine(
        dep["jm"], experts=dep["jexperts"],
        router=JaxRouter(jnp.asarray(dep["cent"]), JaxRouterConfig(top_k=2)),
        config=japi.EngineConfig(strategy=strategy, **ECFG)),
        japi.SamplingParams, dep)
    assert got == want
    assert {r for _, r in got.values()} == {"length", "truncated"}


@pytest.fixture(scope="module", params=ARCHS)
def dep(request):
    return build_dep(request.param)


def test_config_serves_as_the_reference(dep):
    check_serving(dep, "top1")


def test_config_trains_as_the_reference(dep):
    jm, jp, tp = dep["jm"], dep["jexperts"][0], dep["texperts"][0]
    model = build_model(get_smoke_config(dep["arch"]))
    toks = np.random.default_rng(5).integers(0, 512, (2, 16)) \
        .astype(np.int32)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)}
    tb = {"tokens": torch.as_tensor(toks), "labels": torch.as_tensor(toks)}
    loss, grads, want = check_loss_and_grads(jm, jp, model, tp, jb, tb)
    if model.cfg.tie_embeddings:
        assert "unembed" not in tp["embed"]
        untied = build_model(model.cfg.reduced(tie_embeddings=False))
        two = {**tp, "embed": {
            "embedding": tp["embed"]["embedding"],
            "unembed": tp["embed"]["embedding"].T.contiguous()}}
        _, g2 = port_loss_and_grads(untied, two, tb)
        tied = grads["embed/embedding"]
        np.testing.assert_allclose(
            tied, g2["embed/embedding"] + g2["embed/unembed"].T, rtol=0,
            atol=1e-6 * np.abs(tied).max())
        assert np.abs(g2["embed/unembed"]).max() > 0
    copy = tree_map(torch.clone, tp)      # the step updates in place
    state = {"params": copy, "opt": adamw.init_state(copy)}
    _, met = trainer.make_train_step(model, trainer.TrainConfig())(state, tb)
    norm = np.sqrt(sum(float((w.astype(np.float64) ** 2).sum())
                       for w in want.values()))
    assert float(met["loss"]) == pytest.approx(float(loss), rel=1e-5)
    assert float(met["grad_norm"]) == pytest.approx(norm, rel=1e-4)


@pytest.mark.parametrize("head_dim", [64, 128])
def test_rope_at_llama_base_matches_reference(head_dim):
    theta = get_smoke_config("llama3_405b").rope_theta
    assert theta == 500_000.0
    got = layers.rope_freqs(head_dim, theta).numpy()
    want = np.asarray(jlayers.rope_freqs(head_dim, theta))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_max_ulp(got, want, maxulp=1)
    rng = np.random.default_rng(head_dim)
    x = rng.normal(size=(2, 7, 4, head_dim)).astype(np.float32)
    pos = np.array([[0, 1, 255, 256, 700, 1343, 1344]] * 2, np.int32)
    np.testing.assert_allclose(
        layers.apply_rope(torch.as_tensor(x), torch.as_tensor(pos),
                          theta).numpy(),
        np.asarray(jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                      theta)), rtol=2e-5, atol=2e-5)
