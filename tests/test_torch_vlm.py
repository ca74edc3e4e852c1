"""The port's vlm family against the JAX reference: the float32
``internvl2_2b`` smoke config (the dense decoder behind a 16-row image
prefix projected from (16, 64) patches), 2 experts carried across from the
reference's pytrees by ``repro_torch.weights``.

The model: ``_embed_inputs`` within rtol = atol = 2e-5 of the
reference's; ``forward`` logits within rtol 2e-5 and ``LOGIT_ATOL`` =
1e-4 of their largest magnitude (float32 on both sides, differing by
summation order. This config has no qk-norm, so its random attention
logits are large, q·k/√dh ~ 60, and the softmax magnifies that order:
the two sides measured 5.0e-5 apart on logits of magnitude up to 4.1,
and each 1.2e-4 and 1.1e-4 from a float64 forward); ``loss`` to 1e-5
relative and every gradient leaf, the projector's included, within
``GRAD_ATOL`` = 5e-4 of its largest element of ``jax.grad``'s (the same
magnification: measured 4.6e-5 here and up to 1.4e-4 on the dense
configs without qk-norm, each side up to 2.0e-4 from a float64
gradient); the projector's leaves cross with the weights bit for bit.

The prefill width: admission counts the image prefix beside the prompt,
so a prompt whose text fits the pool or the context but whose text plus
patches does not is refused with the reference's message, and a prompt
that fits reserves the reference's blocks.

The whole slice, top-1: the ``DecentralizedSlotServer`` emits exactly the
reference's tokens, finish reasons (stop, length and truncated among
them) and speculation counters in paged + chunked (chunk 8: the prefix
fills the first two chunks and the text starts a chunk of its own), paged
+ monolithic and contiguous + monolithic serving, and paged + chunked
with n-gram speculation; two of the six requests are sampled, seeded, in
every run. (The Eq. 27 mixture's vlm slice and its stacked prefill are
in ``test_torch_vlm_mixture.py``, which imports the helpers here, as
``test_torch_dense_configs.py`` imports ``check_loss_and_grads``.) The
serving launcher refuses ``--arch internvl2_2b`` where the reference
launcher fails: it has no patches to send.
"""
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
from repro.launch import train as jax_launch_train  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.serve import api as japi  # noqa: E402
from repro.serve.scheduler import make_engine as jax_make_engine  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.router import CentroidRouter, RouterConfig  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serve.api import EngineConfig, SamplingParams  # noqa: E402
from repro_torch.serve.scheduler import make_engine  # noqa: E402
from repro_torch.tree import tree_from_leaves, tree_leaves  # noqa: E402
from repro_torch.weights import from_tree  # noqa: E402

ARCH = "internvl2_2b"
K, FEAT, CACHE_LEN, BLOCK, CHUNK, SPEC_LEN = 2, 16, 40, 8, 8, 4
# text tokens; each prompt is 16 prefix rows longer. 19 + 16 + 8 runs past
# the context (truncated); request 4's whole budget is its prefill token;
# the last prompt fills the context
LENS = [7, 11, 5, 19, 3, 24]
SAMPLED = {1: 0, 3: 40}          # rid → top_k; the others are greedy
LOGIT_ATOL = 1e-4                # of the largest logit magnitude
GRAD_ATOL = 5e-4                 # of each leaf's largest element
CHUNKED = dict(paged=True, page_block=BLOCK, chunked_prefill=True,
               chunk=CHUNK)
CONFIGS = {
    "paged-chunked": CHUNKED,
    "paged-monolithic": dict(paged=True, page_block=BLOCK),
    "contiguous-monolithic": {},
    "paged-chunked-ngram": dict(CHUNKED, speculative="ngram",
                                spec_len=SPEC_LEN),
    "paged-chunked-expert": dict(CHUNKED, speculative="expert",
                                 spec_len=SPEC_LEN),
}
TOP1_KINDS = [k for k in CONFIGS if not k.endswith("expert")]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module, restored after it: with
    parallel test workers each starting a thread per core, the threads
    contend and these smoke-size steps run many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def build_dep():
    jm = jax_build(jax_smoke(ARCH))
    jexperts = [jm.init(jax.random.PRNGKey(k)) for k in range(K)]
    texperts = [from_tree(jax.tree.map(np.asarray, p)) for p in jexperts]
    cfg = jm.cfg
    rng = np.random.default_rng(11)
    cent = rng.normal(size=(K, FEAT)).astype(np.float32)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in LENS]
    patches = [rng.normal(size=(cfg.n_patches, cfg.vision_dim))
               .astype(np.float32) for _ in LENS]
    feats = rng.normal(size=(len(LENS), FEAT)).astype(np.float32)
    return dict(jm=jm, jexperts=jexperts, texperts=texperts, cent=cent,
                prompts=prompts, patches=patches, feats=feats)


def sampling_params(i, sp_cls, stops):
    samp = dict(temperature=0.7, top_k=SAMPLED[i], seed=300 + i) \
        if i in SAMPLED else {}
    return sp_cls(max_new=1 if i == 4 else 8,
                  stop_token_ids=stops.get(i, ()), **samp)


def drive(engine, sp_cls, dep, stops):
    for i, p in enumerate(dep["prompts"]):
        engine.add_request(p, sampling_params(i, sp_cls, stops),
                           {"patches": dep["patches"][i]},
                           features=dep["feats"][i], rid=i)
    res = {}
    while engine.has_unfinished():
        for o in engine.step():
            if o.finished:
                res[o.rid] = (o.token_ids, o.finish_reason)
    st = engine.occupancy()
    return res, (sum(p.get("spec_steps", 0) for p in st),
                 sum(p.get("spec_tokens", 0) for p in st))


def port_engine(dep, strategy, kind):
    return make_engine(
        build_model(get_smoke_config(ARCH)), experts=dep["texperts"],
        router=CentroidRouter(torch.as_tensor(dep["cent"]),
                              RouterConfig(top_k=2)),
        config=EngineConfig(n_slots=2, cache_len=CACHE_LEN,
                            strategy=strategy, **CONFIGS[kind]),
        device="cpu")


def reference_engine(dep, strategy, kind):
    return jax_make_engine(
        dep["jm"], experts=dep["jexperts"],
        router=JaxRouter(jnp.asarray(dep["cent"]), JaxRouterConfig(top_k=2)),
        config=japi.EngineConfig(n_slots=2, cache_len=CACHE_LEN,
                                 strategy=strategy, **CONFIGS[kind]))


def find_stops(dep):
    """Stop ids that requests 0 (greedy) and 1 (sampled) generate
    mid-stream in a free top-1 run, so both retire on "stop"."""
    free, _ = drive(port_engine(dep, "top1", "paged-chunked"),
                    SamplingParams, dep, {})
    return {0: (free[0][0][3],), 1: (free[1][0][5],)}


def check_slice(dep, stops, strategy, kind):
    """Tokens, finish reasons and spec counters of the port's engine
    against the reference's, ``strategy`` in ``CONFIGS[kind]``."""
    got = drive(port_engine(dep, strategy, kind), SamplingParams, dep, stops)
    want = drive(reference_engine(dep, strategy, kind), japi.SamplingParams,
                 dep, stops)
    assert got == want
    res, (spec_steps, spec_tokens) = got
    assert {r for _, r in res.values()} == {"stop", "length", "truncated"}
    assert len(res[4][0]) == 1 and len(res[5][0]) == 1
    assert res[5][1] == "truncated"                  # fills the context
    if "speculative" in CONFIGS[kind]:
        assert spec_steps > 0 and spec_tokens >= spec_steps


def leaves_of(tree):
    """{"/"-joined path: numpy leaf} of a reference pytree."""
    return {"/".join(str(k.key) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def port_loss_and_grads(model, params, batch):
    paths, leaves = zip(*tree_leaves(params))
    live = [p.detach().requires_grad_() for p in leaves]
    loss, _ = model.loss(tree_from_leaves(paths, live), batch)
    return loss.detach(), dict(zip(paths, (
        g.numpy() for g in torch.autograd.grad(loss, live))))


def check_loss_and_grads(jm, jp, model, tp, jb, tb):
    """``model.loss`` and its gradient on ``tp`` against the reference's
    ``jax.grad`` of ``jm.loss`` on ``jp``: the loss to 1e-5 relative,
    every leaf within ``GRAD_ATOL`` of its largest element. Returns the
    port's (loss, grads) and the reference's grads."""
    (jl, _), jg = jax.value_and_grad(jm.loss, has_aux=True)(jp, jb)
    loss, grads = port_loss_and_grads(model, tp, tb)
    assert float(loss) == pytest.approx(float(jl), rel=1e-5)
    want = leaves_of(jg)
    assert sorted(grads) == sorted(want)
    for path, w in want.items():
        np.testing.assert_allclose(grads[path], w, rtol=0,
                                   atol=GRAD_ATOL * np.abs(w).max(),
                                   err_msg=path)
    return loss, grads, want


@pytest.fixture(scope="module")
def dep():
    return build_dep()


@pytest.fixture(scope="module")
def stops(dep):
    return find_stops(dep)


# ---------------------------------------------------------------------------
# The model against the reference
# ---------------------------------------------------------------------------

def _batches(dep, B=2, T=12):
    rng = np.random.default_rng(5)
    cfg = dep["jm"].cfg
    toks = rng.integers(0, cfg.vocab, (B, T)).astype(np.int32)
    patches = rng.normal(size=(B, cfg.n_patches, cfg.vision_dim)) \
        .astype(np.float32)
    j = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks),
         "patches": jnp.asarray(patches)}
    t = {"tokens": torch.as_tensor(toks), "labels": torch.as_tensor(toks),
         "patches": torch.as_tensor(patches)}
    return j, t


def test_projector_crosses_with_the_weights(dep):
    """The port's parameter tree is the reference's, projector included:
    the same paths and shapes from ``param_specs``, and the converted
    leaves equal the reference's bit for bit."""
    model = build_model(get_smoke_config(ARCH))
    jp, tp = dep["jexperts"][0], dep["texperts"][0]
    want = leaves_of(jp)
    got = dict(tree_leaves(tp))
    assert sorted(got) == sorted(want)
    specs = dict(tree_leaves(model.param_specs()))
    assert sorted(specs) == sorted(want)
    for path, leaf in want.items():
        assert tuple(specs[path].shape) == leaf.shape, path
        np.testing.assert_array_equal(got[path].numpy(), leaf)
    assert got["projector/w1"].shape == (64, 128)
    assert got["projector/w2"].shape == (128, 128)


def test_embed_inputs_and_forward_match_reference(dep):
    jb, tb = _batches(dep)
    jm, jp, tp = dep["jm"], dep["jexperts"][0], dep["texperts"][0]
    model = build_model(get_smoke_config(ARCH))
    x = model._embed_inputs(tp, tb)
    assert x.shape == (2, 16 + 12, 128)
    np.testing.assert_allclose(x.numpy(), np.asarray(jm._embed_inputs(jp, jb)),
                               rtol=2e-5, atol=2e-5)
    want = np.asarray(jm.forward(jp, jb))
    np.testing.assert_allclose(model.forward(tp, tb).numpy(), want,
                               rtol=2e-5,
                               atol=LOGIT_ATOL * np.abs(want).max())
    with pytest.raises(ValueError, match="no 'patches'"):
        model.forward(tp, {"tokens": tb["tokens"]})


def test_loss_and_gradients_match_reference(dep):
    """``Model.loss`` drops the image prefix's logits; the loss and every
    gradient leaf, the projector's included, against ``jax.grad``."""
    jb, tb = _batches(dep)
    _, _, want = check_loss_and_grads(
        dep["jm"], dep["jexperts"][0], build_model(get_smoke_config(ARCH)),
        dep["texperts"][0], jb, tb)
    assert np.abs(want["projector/w1"]).max() > 0


# ---------------------------------------------------------------------------
# The prefill width: the image prefix is part of every reservation
# ---------------------------------------------------------------------------

def _single(dep, port, **ecfg):
    if port:
        return make_engine(build_model(get_smoke_config(ARCH)),
                           dep["texperts"][0], device="cpu",
                           config=EngineConfig(n_slots=2, **ecfg))
    return jax_make_engine(dep["jm"], dep["jexperts"][0],
                           config=japi.EngineConfig(n_slots=2, **ecfg))


def _refusal(engine, toks, patches):
    with pytest.raises(ValueError) as err:
        engine.add_request(toks, None, {"patches": patches}, rid=0)
    return str(err.value)


@pytest.mark.parametrize("ecfg", [
    dict(cache_len=CACHE_LEN, paged=True, page_block=BLOCK, pool_blocks=4,
         chunked_prefill=True, chunk=CHUNK),
    dict(cache_len=CACHE_LEN, paged=True, page_block=BLOCK, pool_blocks=4),
], ids=["chunked", "monolithic"])
def test_prefill_width_counts_the_image_prefix(dep, ecfg):
    """A 10-token prompt fits 3 usable blocks of 8 and the 40-position
    context; with its 16 patch rows it needs 4 blocks: both engines refuse
    it at submission, for the pool. A 30-token prompt fits the context,
    its 46 positions do not: both refuse it for the context, with the same
    message. A 5-token prompt (21 positions) reserves the reference's
    blocks at admission, and its prefill width (chunked) or first decode
    position (monolithic) is 21 on both."""
    patches = dep["patches"][0]
    toks = dep["prompts"][3]
    port, ref = _single(dep, True, **ecfg), _single(dep, False, **ecfg)
    got, want = _refusal(port, toks[:10], patches), \
        _refusal(ref, toks[:10], patches)
    assert "needs 4 KV blocks but the pool has only 3 usable" in got
    assert want.startswith(got)
    big = np.concatenate([toks, toks])[:30]
    assert _refusal(port, big, patches) == _refusal(ref, big, patches) == (
        "request 0: prompt needs 46 positions but the serving context is "
        "cache_len=40 — reject the request or raise cache_len")
    for eng in (port, ref):
        eng.add_request(toks[:5], None, {"patches": patches}, rid=1)
        eng._admit_waiting()
    assert port.n_alloc.tolist() == ref.n_alloc.tolist() == [3, 0]
    np.testing.assert_array_equal(port.block_tables, ref.block_tables)
    if ecfg.get("chunked_prefill"):
        assert int(port.prefill_width[0]) == int(ref.prefill_width[0]) == 21
    else:
        assert int(port.pos[0]) == int(ref.pos[0]) == 21


# ---------------------------------------------------------------------------
# The whole slice against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", TOP1_KINDS)
def test_vlm_top1_slice_matches_reference_token_for_token(dep, stops, kind):
    check_slice(dep, stops, "top1", kind)


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------

def test_launcher_refuses_vlm_where_the_reference_fails(dep, tmp_path,
                                                        monkeypatch):
    """Neither launcher has an image frontend: the reference's sends no
    patches. Where text plus prefix overflows the context, both refuse
    the first request at submission with the same message; where it fits,
    the reference fails at the first admission (its batch has no
    ``patches``) and the port raises its clear error there."""
    run = str(tmp_path)
    for k in range(K):
        jckpt.save_expert(run, k, 1, {"params": dep["jexperts"][k]})
    # the launchers' synthetic requests carry 32 features
    cent = np.random.default_rng(2).normal(size=(K, 32)).astype(np.float32)
    jckpt.save_router(run, cent, 10.0, 1)
    short = ["--run", run, "--arch", ARCH, "--requests", "2",
             "--prompt-len", "8", "--new-tokens", "4", "--slots", "2"]
    roomy = short[:-4] + ["--new-tokens", "20"] + short[-2:]
    monkeypatch.setattr("sys.argv", ["serve"] + short)
    with pytest.raises(ValueError) as want:
        jax_launch_serve.main()
    with pytest.raises(ValueError) as got:
        launch_serve.main(short + ["--device", "cpu"])
    assert str(got.value) == str(want.value)
    assert "prompt needs 24 positions" in str(got.value)
    monkeypatch.setattr("sys.argv", ["serve"] + roomy)
    with pytest.raises(KeyError, match="patches"):
        jax_launch_serve.main()
    with pytest.raises(ValueError, match="the batch has no 'patches'"):
        launch_serve.main(roomy + ["--device", "cpu"])


def test_train_launcher_fails_vlm_where_the_reference_fails(tmp_path,
                                                            monkeypatch):
    """The synthetic corpus has no images: both training launchers fail
    at the first step, the reference's batch without ``patches``, the
    port with its clear error."""
    flags = ["--arch", ARCH, "--mode", "dense", "--steps", "1", "--seq-len",
             "8", "--batch", "2", "--samples", "16"]
    monkeypatch.setattr("sys.argv", ["train"] + flags
                        + ["--out", str(tmp_path / "ref")])
    with pytest.raises(KeyError, match="patches"):
        jax_launch_train.main()
    with pytest.raises(ValueError, match="the batch has no 'patches'"):
        launch_train.main(flags + ["--out", str(tmp_path / "port"),
                                   "--device", "cpu"])
