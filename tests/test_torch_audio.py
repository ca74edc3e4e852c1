"""The port's audio family against the JAX reference: the float32
``whisper_small`` smoke config (2 decoder and 2 encoder layers, D = 128,
4/4 heads of 32, 32 frames of 128 a request), 2 experts carried across
from the reference's pytrees by ``repro_torch.weights``, the encoder tree
included.

The model: ``_encode_audio``, one layer's ``encode_kv`` and
``cross_attention``, and ``forward``'s logits within rtol 2e-5 and
``ATOL`` = 5e-4 of each one's largest magnitude; ``loss`` to 1e-5
relative and every gradient leaf, the encoder's and the cross-attention's
among them, within ``GRAD_ATOL`` = 4e-3 of its largest element of
``jax.grad``'s, and no farther from the reference's x64 gradient (its
forward at float64 params and compute dtype; its norms, RoPE and softmax
stay float32) than twice the reference's own float32 gradient is; then
one ``make_train_step`` on a loader batch that holds frames
(``trainer.to_batch`` keeps them). Float32 on both sides differs by
summation order, and this random config magnifies that order more than
the vlm one (no qk-norm, and the decoder's queries cross-attend to 32
encoder rows): the logits measured 2.3e-4 of their largest magnitude
apart, each side 1.8e-4 (port) and 2.0e-4 (reference) from the x64
forward; the gradients up to 1.9e-3 of a leaf's largest element apart,
the port up to 1.4e-3 and the reference up to 3.0e-3 from the x64
gradient.

The whole slice, top-1: the ``DecentralizedSlotServer`` emits exactly the
reference's tokens, finish reasons (stop, length and truncated among
them) and speculation counters in paged + chunked (chunk 8), paged +
monolithic and contiguous + monolithic serving; two of the six requests
are sampled, seeded, in every run. ``validate`` accepts and refuses what
the reference's does, with its messages. (n-gram speculation, the unfused
step and the serving host layer are in ``test_torch_audio_serve.py``; the mixture's audio slice, the stacked
encoder, the batch engines and the launchers in
``test_torch_audio_mixture.py``; both import the helpers here.)
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_smoke_config as jax_smoke  # noqa: E402
from repro.core.router import CentroidRouter as JaxRouter  # noqa: E402
from repro.core.router import RouterConfig as JaxRouterConfig  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.serve import api as japi  # noqa: E402
from repro.serve import scheduler as jsched  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.router import CentroidRouter, RouterConfig  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.serve import scheduler as sched  # noqa: E402
from repro_torch.serve.api import EngineConfig, SamplingParams  # noqa: E402
from repro_torch.train import trainer  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402
from repro_torch.weights import from_tree  # noqa: E402

from test_torch_vlm import leaves_of, port_loss_and_grads  # noqa: E402

ARCH = "whisper_small"
K, FEAT, CACHE_LEN, BLOCK, CHUNK, SPEC_LEN = 2, 16, 40, 8, 8, 4
# prompt tokens: 35 + 8 runs past the context (truncated); request 4's
# whole budget is its prefill token; the last prompt fills the context
LENS = [7, 11, 5, 35, 3, 40]
SAMPLED = {1: 0, 3: 40}          # rid → top_k; the others are greedy
ATOL = 5e-4                      # of the largest magnitude
GRAD_ATOL = 4e-3                 # of each leaf's largest element
CHUNKED = dict(paged=True, page_block=BLOCK, chunked_prefill=True,
               chunk=CHUNK)
CONFIGS = {
    "paged-chunked": CHUNKED,
    "paged-monolithic": dict(paged=True, page_block=BLOCK),
    "contiguous-monolithic": {},
    "paged-chunked-ngram": dict(CHUNKED, speculative="ngram",
                                spec_len=SPEC_LEN),
    "paged-chunked-unfused": dict(CHUNKED, fused_step=False),
    "contiguous-unfused": dict(fused_step=False),
    "paged-chunked-expert": dict(CHUNKED, speculative="expert",
                                 spec_len=SPEC_LEN),
}
TOP1_KINDS = [k for k in CONFIGS if not k.endswith("expert")]
# the three paged × chunked combinations the reference serves (the n-gram
# and unfused runs are in test_torch_audio_serve.py)
BASE_KINDS = ["paged-chunked", "paged-monolithic", "contiguous-monolithic"]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module, restored after it: with
    parallel test workers each starting a thread per core, the threads
    contend and these smoke-size steps run many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def frames_of(cfg, rng):
    return rng.normal(size=(cfg.n_audio_frames, cfg.audio_dim)) \
        .astype(np.float32)


def build_dep():
    jm = jax_build(jax_smoke(ARCH))
    jexperts = [jm.init(jax.random.PRNGKey(k)) for k in range(K)]
    texperts = [from_tree(jax.tree.map(np.asarray, p)) for p in jexperts]
    cfg = jm.cfg
    rng = np.random.default_rng(11)
    cent = rng.normal(size=(K, FEAT)).astype(np.float32)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in LENS]
    frames = [frames_of(cfg, rng) for _ in LENS]
    feats = rng.normal(size=(len(LENS), FEAT)).astype(np.float32)
    return dict(jm=jm, jexperts=jexperts, texperts=texperts, cent=cent,
                prompts=prompts, frames=frames, feats=feats)


def sampling_params(i, sp_cls, stops):
    samp = dict(temperature=0.7, top_k=SAMPLED[i], seed=300 + i) \
        if i in SAMPLED else {}
    return sp_cls(max_new=1 if i == 4 else 8,
                  stop_token_ids=stops.get(i, ()), **samp)


def drive(engine, sp_cls, dep, stops):
    for i, p in enumerate(dep["prompts"]):
        engine.add_request(p, sampling_params(i, sp_cls, stops),
                           {"frames": dep["frames"][i]},
                           features=dep["feats"][i], rid=i)
    res = {}
    while engine.has_unfinished():
        for o in engine.step():
            if o.finished:
                res[o.rid] = (o.token_ids, o.finish_reason)
    st = engine.occupancy()
    return res, (sum(p.get("spec_steps", 0) for p in st),
                 sum(p.get("spec_tokens", 0) for p in st))


def port_engine(dep, strategy, kind, **over):
    return sched.make_engine(
        build_model(get_smoke_config(ARCH)), experts=dep["texperts"],
        router=CentroidRouter(torch.as_tensor(dep["cent"]),
                              RouterConfig(top_k=2)),
        config=EngineConfig(n_slots=2, cache_len=CACHE_LEN,
                            strategy=strategy, **CONFIGS[kind], **over),
        device="cpu")


def reference_engine(dep, strategy, kind, **over):
    return jsched.make_engine(
        dep["jm"], experts=dep["jexperts"],
        router=JaxRouter(jnp.asarray(dep["cent"]), JaxRouterConfig(top_k=2)),
        config=japi.EngineConfig(n_slots=2, cache_len=CACHE_LEN,
                                 strategy=strategy, **CONFIGS[kind],
                                 **over))


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


def batches(cfg, B=2, T=12, seed=5):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, T)).astype(np.int32)
    frames = rng.normal(size=(B, cfg.n_audio_frames, cfg.audio_dim)) \
        .astype(np.float32)
    j = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks),
         "frames": jnp.asarray(frames)}
    t = {"tokens": torch.as_tensor(toks), "labels": torch.as_tensor(toks),
         "frames": torch.as_tensor(frames)}
    return j, t


@pytest.fixture(scope="module")
def dep():
    return build_dep()


@pytest.fixture(scope="module")
def stops(dep):
    return find_stops(dep)


def near(got, want, what):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=2e-5,
                               atol=ATOL * np.abs(want).max(), err_msg=what)


# ---------------------------------------------------------------------------
# The model against the reference
# ---------------------------------------------------------------------------

def test_encoder_tree_crosses_with_the_weights(dep):
    """The port's parameter tree is the reference's, the encoder's and the
    decoder's cross-attention included: the same paths and shapes from
    ``param_specs``, and the converted leaves equal bit for bit."""
    model = build_model(get_smoke_config(ARCH))
    want = leaves_of(dep["jexperts"][0])
    got = dict(tree_leaves(dep["texperts"][0]))
    specs = dict(tree_leaves(model.param_specs()))
    assert sorted(got) == sorted(want) == sorted(specs)
    for path, leaf in want.items():
        assert tuple(specs[path].shape) == leaf.shape, path
        np.testing.assert_array_equal(got[path].numpy(), leaf)
    assert got["encoder/in_proj"].shape == (128, 128)
    assert got["encoder/blocks/attn/wq"].shape == (2, 128, 4, 32)
    assert got["blocks/cross_attn/wk"].shape == (2, 128, 4, 32)
    assert "blocks/ln3" in got


def test_encoder_cross_attention_and_logits_match_reference(dep):
    jm, jp, tp = dep["jm"], dep["jexperts"][0], dep["texperts"][0]
    model = build_model(get_smoke_config(ARCH))
    jb, tb = batches(jm.cfg)
    enc = model._encode_audio(tp, tb)
    assert enc.shape == (2, 32, 128)
    jenc = jm._encode_audio(jp, jb["frames"])
    near(enc, jenc, "encoder")
    cfg = model.cfg
    layer = tree_map(lambda t: t[1], tp["blocks"])
    jlayer = jax.tree.map(lambda a: a[1], jp["blocks"])
    kv = attn.encode_kv(layer["cross_attn"], enc, cfg)
    jkv = jattn.encode_kv(jlayer["cross_attn"], jenc, jm.cfg)
    for got, want in zip(kv, jkv):
        assert got.shape == (2, 32, 4, 32)
        near(got, want, "encode_kv")
    x = torch.as_tensor(np.random.default_rng(1).normal(
        size=(2, 5, 128)).astype(np.float32))
    near(attn.cross_attention(layer["cross_attn"], x, kv, cfg),
         jattn.cross_attention(jlayer["cross_attn"], jnp.asarray(x.numpy()),
                               jkv, jm.cfg), "cross_attention")
    near(model.forward(tp, tb), jm.forward(jp, jb), "logits")
    with pytest.raises(ValueError, match="the batch has no 'frames'"):
        model.forward(tp, {"tokens": tb["tokens"]})


def test_loss_gradients_and_a_train_step_match_reference(dep):
    """``Model.loss`` and every gradient leaf against ``jax.grad`` and
    the reference's x64 gradient; the encoder's and the cross-attention's
    gradients are nonzero; then one ``make_train_step`` on a loader batch
    with frames."""
    jm, jp = dep["jm"], dep["jexperts"][0]
    jb, tb = batches(jm.cfg)
    model = build_model(get_smoke_config(ARCH))
    (jl, _), jg = jax.value_and_grad(jm.loss, has_aux=True)(jp, jb)
    loss, grads = port_loss_and_grads(model, dep["texperts"][0], tb)
    assert float(loss) == pytest.approx(float(jl), rel=1e-5)
    jm64 = jax_build(jm.cfg.reduced(param_dtype="float64",
                                    compute_dtype="float64"))
    g64 = leaves_of(jax.grad(lambda p: jm64.loss(p, dict(
        jb, frames=jb["frames"].astype(jnp.float64)))[0])(
            jax.tree.map(lambda a: a.astype(jnp.float64), jp)))
    want = leaves_of(jg)
    assert sorted(grads) == sorted(want) == sorted(g64)
    for path, w in want.items():
        scale = np.abs(w).max()
        np.testing.assert_allclose(grads[path], w, rtol=0,
                                   atol=GRAD_ATOL * scale, err_msg=path)
        ref_err = np.abs(w - g64[path]).max()
        assert np.abs(grads[path] - g64[path]).max() <= 2 * ref_err, path
    for path in ("encoder/in_proj", "encoder/blocks/attn/wq",
                 "encoder/blocks/ffn/w_down", "encoder/norm",
                 "blocks/cross_attn/wq", "blocks/cross_attn/wk",
                 "blocks/cross_attn/wv", "blocks/cross_attn/wo",
                 "blocks/ln2", "blocks/ln3"):
        assert np.abs(grads[path]).max() > 0, path
    loader_batch = {k: np.array(v) for k, v in jb.items()}
    loader_batch["features"] = np.zeros((2, 4), np.float32)
    tb2 = trainer.to_batch(loader_batch, "cpu")
    assert sorted(tb2) == ["frames", "labels", "tokens"]
    copy = tree_map(torch.clone, dep["texperts"][0])
    state = {"params": copy, "opt": adamw.init_state(copy)}
    _, met = trainer.make_train_step(model, trainer.TrainConfig())(state,
                                                                    tb2)
    def norm(g):
        return np.sqrt(sum(float((w.astype(np.float64) ** 2).sum())
                           for w in g.values()))
    assert float(met["loss"]) == pytest.approx(float(loss), rel=1e-5)
    assert float(met["grad_norm"]) == pytest.approx(norm(grads), rel=1e-5)
    assert float(met["grad_norm"]) == pytest.approx(norm(want), rel=1e-3)
    assert not torch.equal(copy["encoder"]["in_proj"],
                           dep["texperts"][0]["encoder"]["in_proj"])


# ---------------------------------------------------------------------------
# The whole slice against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", BASE_KINDS)
def test_audio_top1_slice_matches_reference_token_for_token(dep, stops,
                                                            kind):
    check_slice(dep, stops, "top1", kind)


# ---------------------------------------------------------------------------
# validate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("chunked", [False, True])
@pytest.mark.parametrize("preemption", ["off", "swap", "recompute"])
def test_validate_matches_reference(paged, chunked, preemption):
    """Audio has a pool: chunked prefill and preemption are allowed when
    paged; each combination is accepted or refused as the reference's
    ``validate`` does, with its message."""
    knobs = dict(paged=paged, chunked_prefill=chunked, preemption=preemption)
    try:
        japi.EngineConfig(**knobs).validate(jax_build(jax_smoke(ARCH)))
        want = None
    except ValueError as e:
        want = str(e)
    try:
        EngineConfig(**knobs).validate(build_model(get_smoke_config(ARCH)))
        got = None
    except ValueError as e:
        got = str(e)
    assert got == want
    assert (got is None) == ((paged or (not chunked and preemption == "off"))
                             and not (preemption == "recompute"
                                      and not chunked))
