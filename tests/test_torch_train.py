"""The port's training slice against the JAX reference: the flash-attention
backward (plain version against the Pallas kernel pair in interpret mode
and against autograd), its ``autograd.Function``, the model's loss and
gradients, AdamW, the train step, the decentralized loop, the partition
and loaders, checkpoints both ways, and the training launcher twin.

Weights cross from the reference's pytree (``repro_torch.weights``), never
re-initialised; inputs are made with numpy from a seed. x64 is on for the
session (``tests/conftest.py``), so the JAX side pins int32 and float32.

Tolerances, all float32 and stated where they are used:
* backward: 2e-4 (the reference's own ``test_flash_vjp.py`` tolerance);
* loss 1e-5 relative; gradients 2e-5 of each leaf's largest element (both
  sides run the same float32 arithmetic in another summation order:
  measured 2e-6);
* AdamW on the same gradients: lr, grad_norm, m, v and masters 1e-5
  relative;
* the train step, whose gradients differ by summation order: loss,
  grad_norm and lr 1e-5 relative; m and v 1e-4 of each leaf's largest
  element (v is quadratic in the gradient: a small element's relative
  error grows as its size falls, measured 1.2e-9 where the largest is
  9.5e-5); params 0.1·lr of the peak lr after 3 steps — Adam's normalised
  step moves an element by up to ~lr whatever its gradient's size, so an
  element whose gradient is near zero turns summation-order noise into
  up to ~lr of movement (measured 0.045·lr at lr 1e-2).
"""
import json
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.utils.checkpoint import checkpoint  # noqa: E402

from repro.checkpoint import ckpt as jckpt  # noqa: E402
from repro.configs.base import get_smoke_config as jax_smoke  # noqa: E402
from repro.core import clustering as jclust  # noqa: E402
from repro.data.partition import partition_dataset as jpartition  # noqa: E402
from repro.data.pipeline import expert_loaders as jloaders  # noqa: E402
from repro.data.synthetic import SyntheticConfig  # noqa: E402
from repro.data.synthetic import SyntheticMultimodal  # noqa: E402
from repro.kernels.flash_attention import \
    flash_attention_with_lse as jflash  # noqa: E402
from repro.kernels.flash_attention_bwd import \
    flash_attention_bwd as jflash_bwd  # noqa: E402
from repro.launch import serve as jax_launch_serve  # noqa: E402
from repro.launch import train as jax_launch_train  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.train import trainer as jtrainer  # noqa: E402
from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import clustering  # noqa: E402
from repro_torch.core.router import router_from_clustering  # noqa: E402
from repro_torch.data.partition import partition_dataset  # noqa: E402
from repro_torch.data.pipeline import expert_loaders  # noqa: E402
from repro_torch.data.synthetic import SyntheticConfig as TSyntheticConfig  # noqa: E402,E501
from repro_torch.data.synthetic import SyntheticMultimodal as TSynthetic  # noqa: E402,E501
from repro_torch.kernels import flash_attention as fk  # noqa: E402
from repro_torch.kernels import flash_attention_bwd as fbk  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.launch import train_path  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train import trainer  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402
from repro_torch.weights import from_tree, to_tensor  # noqa: E402

BWD_TOL = dict(rtol=2e-4, atol=2e-4)
VOCAB, SEQ = 64, 32


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module, restored after it: with
    parallel test workers each starting a thread per core, the threads
    contend and these small training steps ran about 20x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def f32(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def attn_inputs(seed, B, S, H, KV, dh):
    rng = np.random.default_rng(seed)
    return (f32(rng, B, S, H, dh), f32(rng, B, S, KV, dh),
            f32(rng, B, S, KV, dh), f32(rng, B, S, H, dh))


def tensors(*arrays, grad=False):
    return [torch.as_tensor(np.asarray(a)).requires_grad_(grad)
            for a in arrays]


def jax_leaves(tree):
    """{"/"-joined path: numpy leaf} of a reference pytree."""
    return {"/".join(str(k.key) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def port_leaves(tree):
    return {p: t.detach().float().numpy() for p, t in tree_leaves(tree)}


def close_leaves(got, want, atol_of=lambda w: 0.0, rtol=0.0):
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w.astype(np.float32),
                                   rtol=rtol, atol=atol_of(w),
                                   err_msg=path)


# ---------------------------------------------------------------------------
# The flash-attention backward
# ---------------------------------------------------------------------------

VJP_SHAPES = [(1, 128, 4, 2, 32, True, 0), (2, 64, 4, 4, 32, False, 0),
              (1, 128, 4, 1, 32, True, 32)]      # test_flash_vjp.py's


@pytest.mark.parametrize("B,S,H,KV,dh,causal,window", VJP_SHAPES)
def test_plain_backward_matches_pallas_kernel(B, S, H, KV, dh, causal,
                                              window):
    """The plain backward against the Pallas pair (interpret mode, blocks
    of 32) on the same q, k, v, do and the Pallas forward's out and lse."""
    q, k, v, do = attn_inputs(0, B, S, H, KV, dh)
    out, lse = jflash(*map(jnp.asarray, (q, k, v)), causal=causal,
                      window=window, block_q=32, block_k=32, interpret=True)
    want = jflash_bwd(*map(jnp.asarray, (q, k, v)), out, lse,
                      jnp.asarray(do), causal=causal, window=window,
                      block_q=32, block_k=32, interpret=True)
    got = fbk.flash_attention_bwd_ref(*tensors(q, k, v, out, lse, do),
                                      causal=causal, window=window)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **BWD_TOL)


@pytest.mark.parametrize("B,S,H,KV,dh,causal,window", VJP_SHAPES + [
    (1, 77, 8, 2, 16, True, 0),                  # ragged S
    (2, 1, 4, 2, 16, True, 0),                   # one position
    (1, 77, 4, 2, 16, True, 20)])                # ragged, windowed
def test_plain_backward_matches_autograd(B, S, H, KV, dh, causal, window):
    """The plain backward from the saved lse against autograd through the
    plain forward (``flash_attention_ref``, the reference's oracle)."""
    q, k, v, do = attn_inputs(1, B, S, H, KV, dh)
    tq, tk, tv = tensors(q, k, v, grad=True)
    out = fk.flash_attention_ref(tq, tk, tv, causal=causal, window=window)
    want = torch.autograd.grad(out, (tq, tk, tv), torch.as_tensor(do))
    with torch.no_grad():
        o, lse = fk.flash_attention_with_lse_ref(tq, tk, tv, causal=causal,
                                                 window=window)
    got = fbk.flash_attention_bwd_ref(tq.detach(), tk.detach(), tv.detach(),
                                      o, lse, torch.as_tensor(do),
                                      causal=causal, window=window)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **BWD_TOL)


@pytest.mark.parametrize("remat", [False, True])
def test_flash_function_matches_plain_autograd(remat):
    """``ops.flash_attention`` under autograd runs ``FlashAttention`` (plain
    sides on the CPU): its gradients equal autograd through the plain
    forward, also when the call sits inside non-reentrant checkpointing
    (the forward runs again in the backward)."""
    q, k, v, do = attn_inputs(2, 2, 40, 4, 2, 16)

    def run(fn):
        tq, tk, tv = tensors(q, k, v, grad=True)

        def f(a, b, c):
            return fn(a * 1.0, b, c, causal=True, window=24)
        out = checkpoint(f, tq, tk, tv, use_reentrant=False) if remat \
            else f(tq, tk, tv)
        return out, torch.autograd.grad((out * torch.as_tensor(do)).sum(),
                                        (tq, tk, tv))

    out, got = run(ops.flash_attention)
    ref_out, want = run(fk.flash_attention_ref)
    assert out.grad_fn is not None
    torch.testing.assert_close(out, ref_out, rtol=0, atol=0)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **BWD_TOL)
    with torch.no_grad():        # serving: the forward-only call
        tq, tk, tv = tensors(q, k, v, grad=True)
        assert ops.flash_attention(tq, tk, tv).grad_fn is None


@pytest.mark.parametrize("entry", ["decode_attention",
                                   "paged_decode_attention",
                                   "paged_verify_attention",
                                   "chunk_prefill_attention",
                                   "router_scores", "chunk_scan"])
def test_kernels_without_backward_refuse_grad(entry):
    """A kernel with no backward raises when autograd records and an input
    requires grad (a CUDA kernel's output would be invisible to autograd
    and cut the gradient silently); under no_grad it runs."""
    x = torch.zeros((2, 4, 8), requires_grad=True)
    i32 = torch.zeros((2,), dtype=torch.int32)
    args = {"decode_attention": (x, x[:, None], x[:, None], i32),
            "paged_decode_attention": (x, x[:, None], x[:, None], i32,
                                       i32[:, None]),
            "paged_verify_attention": (x[:, None], x[:, None], x[:, None],
                                       i32, i32[:, None]),
            "chunk_prefill_attention": (x, x[:, None], x[:, None], 0,
                                        i32[:1]),
            "router_scores": (x[0], x[1], 1.0),
            "chunk_scan": (x[:, None, :, None], x[:, None, :, None],
                           x[:, None, :, None], x[:, None, :, :1])}[entry]
    with pytest.raises(RuntimeError, match="has no backward kernel"):
        getattr(ops, entry)(*args)
    with torch.no_grad():
        getattr(ops, entry)(*args)


# ---------------------------------------------------------------------------
# The model's loss and gradients
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=[0, 8], ids=["full", "window8"])
def dense(request):
    """(reference model, its params, port model, converted params, batch)
    for the float32 qwen3_8b smoke config, and a sliding-window variant."""
    window = request.param
    jm = jax_build(jax_smoke("qwen3_8b").reduced(sliding_window=window))
    jp = jm.init(jax.random.PRNGKey(4))
    tm = build_model(get_smoke_config("qwen3_8b").reduced(
        sliding_window=window))
    toks = np.random.default_rng(5).integers(0, 512, (2, 24)) \
        .astype(np.int32)
    return jm, jp, tm, from_tree(jax.tree.map(np.asarray, jp)), toks


def port_loss_and_grads(tm, params, batch):
    paths, leaves = zip(*tree_leaves(params))
    live = [p.detach().requires_grad_() for p in leaves]
    from repro_torch.tree import tree_from_leaves
    loss, _ = tm.loss(tree_from_leaves(paths, live), batch)
    grads = torch.autograd.grad(loss, live)
    return loss.detach(), dict(zip(paths, (g.numpy() for g in grads)))


def test_loss_and_gradients_match_reference(dense):
    """``Model.loss`` and its gradient (remat="full": each layer recomputed
    in the backward) against the reference's ``jax.grad`` of
    ``Model.loss``: loss to 1e-5, every leaf to 2e-5 of its largest
    element; a loss mask too."""
    jm, jp, tm, tp, toks = dense
    mask = (np.arange(24) % 3 != 0).astype(np.float32)[None].repeat(2, 0)
    for extra in ({}, {"loss_mask": mask}):
        jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks),
              **{k: jnp.asarray(v) for k, v in extra.items()}}
        (jl, _), jg = jax.value_and_grad(jm.loss, has_aux=True)(jp, jb)
        tb = {"tokens": torch.as_tensor(toks), "labels": torch.as_tensor(toks),
              **{k: torch.as_tensor(v) for k, v in extra.items()}}
        loss, grads = port_loss_and_grads(tm, tp, tb)
        assert float(loss) == pytest.approx(float(jl), rel=1e-5)
        close_leaves(grads, jax_leaves(jg),
                     atol_of=lambda w: 2e-5 * np.abs(w).max())
    logits = tm.forward(tp, {"tokens": torch.as_tensor(toks)})
    np.testing.assert_allclose(
        logits.detach().numpy(),
        np.asarray(jm.forward(jp, {"tokens": jnp.asarray(toks)})),
        rtol=2e-5, atol=2e-5)


def test_remat_none_gives_the_same_gradients(dense):
    """remat="none" keeps every activation instead of recomputing: the same
    loss and gradients, bit for bit."""
    _, _, tm, tp, toks = dense
    batch = {"tokens": torch.as_tensor(toks), "labels": torch.as_tensor(toks)}
    loss, grads = port_loss_and_grads(tm, tp, batch)
    plain = build_model(tm.cfg.reduced(remat="none"))
    loss2, grads2 = port_loss_and_grads(plain, tp, batch)
    assert float(loss) == float(loss2)
    for path in grads:
        np.testing.assert_array_equal(grads[path], grads2[path])


def test_training_refuses_unported_options():
    """Under grad, remat="dots" and the hybrid family raise the port's
    single "not ported" error; the hybrid forward without grad runs and
    matches the reference's ``Model.forward``."""
    cfg = get_smoke_config("qwen3_8b").reduced(remat="dots")
    state = trainer.init_train_state(build_model(cfg),
                                     torch.Generator().manual_seed(0),
                                     adamw.AdamWConfig())
    toks = torch.zeros((1, 8), dtype=torch.int64)
    batch = {"tokens": toks, "labels": toks}
    step = trainer.make_train_step(build_model(cfg), trainer.TrainConfig())
    with pytest.raises(ValueError, match="remat='dots' is not ported to "
                                         "repro_torch yet"):
        step(state, batch)
    hcfg = get_smoke_config("zamba2_2_7b")
    hm = build_model(hcfg)
    hstate = trainer.init_train_state(hm, torch.Generator().manual_seed(0),
                                      adamw.AdamWConfig())
    with pytest.raises(ValueError, match="training family 'hybrid' is not "
                                         "ported to repro_torch yet"):
        trainer.make_train_step(hm, trainer.TrainConfig())(hstate, batch)
    jm = jax_build(jax_smoke("zamba2_2_7b"))
    jp = jm.init(jax.random.PRNGKey(1))
    htoks = np.random.default_rng(2).integers(0, hcfg.vocab, (1, 32)) \
        .astype(np.int32)
    got = hm.forward(from_tree(jax.tree.map(np.asarray, jp)),
                     {"tokens": torch.as_tensor(htoks)})
    want = np.asarray(jm.forward(jp, {"tokens": jnp.asarray(htoks)}))
    # test_torch_hybrid.py's rule for its model-level tensors: rtol 2e-5
    # and 2e-5 of the largest magnitude (measured 1.6e-5 of 4.2)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5,
                               atol=2e-5 * np.abs(want).max())


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_adamw_matches_reference(schedule):
    """Three ``apply_updates`` on float32 and bf16 leaves (the bf16 ones
    keep float32 masters), with clipping active, against the reference:
    lr and grad_norm to 1e-5, m, v and masters to 1e-5 relative, params
    bit for bit in their dtype or within one ulp of it."""
    cfg = dict(lr=0.05, warmup_steps=2, total_steps=5, clip_norm=0.5,
               schedule=schedule)
    rng = np.random.default_rng(6)
    p0 = {"w": f32(rng, 3, 4), "b": {"x": f32(rng, 5)}}
    gs = [{"w": 3 * f32(rng, 3, 4), "b": {"x": 3 * f32(rng, 5)}}
          for _ in range(3)]
    for dtype, jdtype in ((torch.float32, jnp.float32),
                          (torch.bfloat16, jnp.bfloat16)):
        jp = jax.tree.map(lambda a: jnp.asarray(a, jdtype), p0)
        js = jadamw.init_state(jp)
        tp = jax.tree.map(lambda a: torch.as_tensor(a).to(dtype), p0)
        ts = adamw.init_state(tp)
        assert ("master" in ts) == (dtype == torch.bfloat16) == \
            ("master" in js)
        for g in gs:
            jp, js, jm = jadamw.apply_updates(
                jp, jax.tree.map(lambda a: jnp.asarray(a, jdtype), g), js,
                jadamw.AdamWConfig(**cfg))
            tp, ts, tm = adamw.apply_updates(
                tp, jax.tree.map(lambda a: torch.as_tensor(a).to(dtype), g),
                ts, adamw.AdamWConfig(**cfg))
            for name in ("lr", "grad_norm"):
                assert float(tm[name]) == pytest.approx(float(jm[name]),
                                                        rel=1e-5)
        assert int(ts["count"]) == int(js["count"]) == 3
        for key in ("m", "v") + (("master",) if "master" in js else ()):
            close_leaves(port_leaves(ts[key]), jax_leaves(js[key]),
                         rtol=1e-5, atol_of=lambda w: 1e-6)
        tol = 0.0 if dtype == torch.float32 else 2 ** -7
        close_leaves(port_leaves(tp),
                     {k: v.astype(np.float32)
                      for k, v in jax_leaves(jp).items()},
                     rtol=max(tol, 1e-6), atol_of=lambda w: 1e-6)


def test_adamw_decreases_quadratic():
    cfg = adamw.AdamWConfig(lr=0.1, warmup_steps=0, total_steps=100,
                            weight_decay=0.0, clip_norm=0.0,
                            schedule="constant")
    params = {"w": torch.tensor([3.0, -2.0])}
    state = adamw.init_state(params)
    for _ in range(200):
        adamw.apply_updates(params, {"w": 2 * params["w"]}, state, cfg)
    assert float(params["w"].abs().max()) < 1e-2


def test_adamw_clip_and_schedule():
    cfg = adamw.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                            clip_norm=1.0)
    assert float(adamw.lr_at(cfg, torch.tensor(0))) == 0.0
    assert float(adamw.lr_at(cfg, torch.tensor(10))) == pytest.approx(1.0)
    assert float(adamw.lr_at(cfg, torch.tensor(100))) == pytest.approx(
        cfg.min_lr_ratio, rel=1e-5)
    params = {"w": torch.zeros(3)}
    state = adamw.init_state(params)
    _, _, m = adamw.apply_updates(params, {"w": torch.full((3,), 1e6)},
                                  state, cfg)
    assert float(m["grad_norm"]) > 1e6  # reported pre-clip


def test_adamw_master_weights_bf16():
    cfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=0, schedule="constant",
                            weight_decay=0.0, clip_norm=0.0)
    params = {"w": torch.ones(4, dtype=torch.bfloat16)}
    state = adamw.init_state(params)
    assert "master" in state and state["master"]["w"].dtype == torch.float32
    g = {"w": torch.full((4,), 1e-3, dtype=torch.bfloat16)}
    p1, s1, _ = adamw.apply_updates(params, g, state, cfg)
    # master accumulates sub-bf16 steps; params stay bf16
    assert p1["w"].dtype == torch.bfloat16
    assert float((s1["master"]["w"] - 1.0).abs().max()) > 0


# ---------------------------------------------------------------------------
# The train step and the decentralized loop
# ---------------------------------------------------------------------------

def test_train_step_matches_reference(dense):
    """``make_eval_step`` on the same params, then three ``make_train_step``
    steps from them on the same batches, against the reference's jitted
    steps: the eval loss; loss, grad_norm and lr each step; params, m and
    v after the third (tolerances in the module docstring)."""
    jm, jp, tm, tp, _ = dense
    peak = 1e-2
    opt = dict(lr=peak, warmup_steps=1, total_steps=3)
    jstate = {"params": jp, "opt": jadamw.init_state(jp)}
    jstep = jax.jit(jtrainer.make_train_step(
        jm, jtrainer.TrainConfig(opt=jadamw.AdamWConfig(**opt))))
    params = from_tree(jax.tree.map(np.asarray, jp))
    state = {"params": params, "opt": adamw.init_state(params)}
    step = trainer.make_train_step(
        tm, trainer.TrainConfig(opt=adamw.AdamWConfig(**opt)))
    rng = np.random.default_rng(7)
    toks = rng.integers(0, 512, (2, 16)).astype(np.int32)
    jeval = jtrainer.make_eval_step(jm)(jp, {"tokens": jnp.asarray(toks),
                                             "labels": jnp.asarray(toks)})
    teval = trainer.make_eval_step(tm)(params, {
        "tokens": torch.as_tensor(toks), "labels": torch.as_tensor(toks)})
    assert teval["loss"].grad_fn is None
    assert float(teval["loss"]) == pytest.approx(float(jeval["loss"]),
                                                  rel=1e-5)
    for _ in range(3):
        toks = rng.integers(0, 512, (2, 16)).astype(np.int32)
        jstate, jmet = jstep(jstate, {"tokens": jnp.asarray(toks),
                                      "labels": jnp.asarray(toks)})
        out, met = step(state, {"tokens": torch.as_tensor(toks),
                                "labels": torch.as_tensor(toks)})
        assert out is state
        for name in ("loss", "grad_norm", "lr"):
            assert float(met[name]) == pytest.approx(float(jmet[name]),
                                                     rel=1e-5), name
    close_leaves(port_leaves(state["params"]), jax_leaves(jstate["params"]),
                 atol_of=lambda w: 0.1 * peak)
    for key in ("m", "v"):
        close_leaves(port_leaves(state["opt"][key]),
                     jax_leaves(jstate["opt"][key]), rtol=1e-5,
                     atol_of=lambda w: 1e-4 * np.abs(w).max())


def _batches(corpus, K):
    return [{n: torch.as_tensor(corpus.sample_batch(4, step=k)[n])
             for n in ("tokens", "labels")} for k in range(K)]


def test_decentralized_step_equals_independent_steps():
    """The decentralized step over a stacked state must be EXACTLY K
    independent train steps — the mechanized form of 'experts never
    communicate' (``test_e2e.py``'s invariant)."""
    cfg = get_smoke_config("qwen3_8b").reduced(vocab=VOCAB)
    model = build_model(cfg)
    corpus = TSynthetic(TSyntheticConfig(vocab=VOCAB, seq_len=SEQ,
                                         n_samples=512, n_latent=2,
                                         cluster_sep=6.0, seed=0))
    opt = adamw.AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=10,
                            schedule="constant")
    tc = trainer.TrainConfig(opt=opt)
    K = 2
    states = [trainer.init_train_state(
        model, torch.Generator().manual_seed(k), opt) for k in range(K)]
    stacked = trainer.stack_expert_states(states)
    batches = _batches(corpus, K)
    single = trainer.make_train_step(model, tc)
    expected = [single(states[k], batches[k]) for k in range(K)]
    stacked_batch = {n: torch.stack([b[n] for b in batches])
                     for n in batches[0]}
    new, metrics = trainer.make_decentralized_train_step(model, tc)(
        stacked, stacked_batch)
    for k, state in enumerate(trainer.unstack_expert_states(new, K)):
        for (path, a), (_, b) in zip(tree_leaves(expected[k][0]),
                                     tree_leaves(state)):
            assert torch.equal(a, b), path
        assert float(metrics["loss"][k]) == float(expected[k][1]["loss"])


def test_train_loss_decreases():
    """``train_host_loop`` (``test_e2e.py``'s run): the loss falls by more
    than 0.2 over 40 steps and the grad norm stays finite."""
    cfg = get_smoke_config("qwen3_8b").reduced(vocab=VOCAB)
    model = build_model(cfg)
    corpus = TSynthetic(TSyntheticConfig(vocab=VOCAB, seq_len=SEQ,
                                         n_samples=512, n_latent=2,
                                         cluster_sep=6.0, seed=0))
    from repro_torch.data.pipeline import LoaderConfig, ShardLoader
    opt = adamw.AdamWConfig(lr=1e-3, warmup_steps=3, total_steps=40)
    state = trainer.init_train_state(model, torch.Generator().manual_seed(0),
                                     opt)
    state, hist = trainer.train_host_loop(
        model, state, ShardLoader(corpus, LoaderConfig(batch_size=8)), 40,
        trainer.TrainConfig(opt=opt), log_every=5)
    assert [h["step"] for h in hist] == [0, 5, 10, 15, 20, 25, 30, 35, 39]
    assert hist[-1]["loss"] < hist[0]["loss"] - 0.2
    assert np.isfinite(hist[-1]["grad_norm"])


# ---------------------------------------------------------------------------
# Partition and loaders
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("algorithm", ["balanced", "two_stage"])
def test_partition_and_loaders_match_reference(algorithm):
    """The same features and seed give the same assignment, centroids to
    1e-6, the same shards, router centroids and loader batches."""
    jc = SyntheticMultimodal(SyntheticConfig(vocab=32, seq_len=12,
                                             n_samples=300, seed=3))
    tc = TSynthetic(TSyntheticConfig(vocab=32, seq_len=12, n_samples=300,
                                     seed=3))
    feats = tc.all_features()
    np.testing.assert_array_equal(feats, jc.all_features())
    got = partition_dataset(feats, 3, algorithm=algorithm, seed=1)
    want = jpartition(feats, 3, algorithm=algorithm, seed=1)
    np.testing.assert_array_equal(got.clustering.assignment,
                                  want.clustering.assignment)
    np.testing.assert_allclose(got.clustering.centroids,
                               want.clustering.centroids, atol=1e-6)
    assert got.clustering.n_iter == want.clustering.n_iter
    for a, b in zip(got.shards, want.shards):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got.router.centroids.numpy(),
                                  np.asarray(want.router.centroids))
    for tl, jl in zip(expert_loaders(tc, got.shards, 4),
                      jloaders(jc, want.shards, 4)):
        for _ in range(2):
            b, w = next(tl), next(jl)
            assert sorted(b) == sorted(w)
            for n in b:
                np.testing.assert_array_equal(b[n], w[n])


def test_clustering_helpers_match_reference():
    rng = np.random.default_rng(8)
    x = rng.normal(size=(50, 6))
    np.testing.assert_allclose(clustering.l2_normalize(x),
                               np.asarray(jclust.l2_normalize(x)),
                               rtol=1e-12)
    sims = rng.normal(size=(50, 4))
    np.testing.assert_array_equal(clustering._balanced_assign(sims, 4),
                                  jclust._balanced_assign(sims, 4))
    np.testing.assert_array_equal(clustering.partition_text_only(11, 3, 2),
                                  jclust.partition_text_only(11, 3, 2))
    r = router_from_clustering(np.eye(3))
    assert r.centroids.dtype == torch.float32 and r.config.top_k == 1


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------

def _mixed_tree():
    """float32, bf16 and int leaves, nesting and empty containers."""
    rng = np.random.default_rng(9)
    return {"params": {"w": f32(rng, 3, 2),
                       "h": f32(rng, 4).astype(jnp.bfloat16)},
            "opt": {"count": np.asarray(5, np.int32), "extra": {},
                    "seq": (np.arange(3, dtype=np.int32), [])}}


def test_checkpoint_written_by_port_reads_in_reference(tmp_path):
    """The port's ``save`` writes the reference's npz entries, dtypes and
    bytes: the same keys in the same order, bf16 leaves as ``|V2`` raw
    bits, and the reference reads the non-bf16 leaves back."""
    tree = _mixed_tree()
    port_tree = {"params": {k: to_tensor(v)
                            for k, v in tree["params"].items()},
                 "opt": {"count": torch.tensor(5, dtype=torch.int32),
                         "extra": {}, "seq": (torch.arange(3,
                                                           dtype=torch.int32),
                                              [])}}
    ckpt.save_expert(str(tmp_path / "port"), 0, 3, port_tree)
    jckpt.save_expert(str(tmp_path / "ref"), 0, 3, jax.tree.map(
        jnp.asarray, tree))
    got = np.load(tmp_path / "port/expert_0/step_3.npz")
    want = np.load(tmp_path / "ref/expert_0/step_3.npz")
    assert got.files == want.files
    for name in want.files:
        assert got[name].dtype == want[name].dtype, name
        assert got[name].tobytes() == want[name].tobytes(), name
    assert got["params/h"].dtype.str == "|V2"
    # the reference reads back everything but a bf16 leaf, which its jnp
    # conversion refuses (|V2)
    ckpt.save(str(tmp_path / "port_nobf16.npz"),
              {"opt": port_tree["opt"]})
    back = jckpt.load(str(tmp_path / "port_nobf16.npz"))
    assert back["opt"]["extra"] == {} and back["opt"]["seq"][1] == []
    assert isinstance(back["opt"]["seq"], tuple)
    np.testing.assert_array_equal(np.asarray(back["opt"]["seq"][0]),
                                  np.arange(3))


def test_checkpoint_written_by_reference_reads_in_port(tmp_path):
    """The reference's ``save_expert``/``save_router`` files read in the
    port: bf16 leaves (``|V2`` on disk) come back as the same bf16
    tensors, empty containers keep their type, the step and the router
    round trip."""
    tree = _mixed_tree()
    base = str(tmp_path)
    jckpt.save_expert(base, 1, 40, jax.tree.map(jnp.asarray, tree))
    jckpt.save_router(base, np.eye(2), 10.0, 1)
    state, step = ckpt.restore_expert(base, 1)
    assert step == 40 and ckpt.latest_step(base, 0) is None
    params = from_tree(state["params"])
    assert params["h"].dtype == torch.bfloat16
    assert torch.equal(params["h"], to_tensor(tree["params"]["h"]))
    assert torch.equal(params["w"], torch.as_tensor(tree["params"]["w"]))
    assert state["opt"]["extra"] == {} and state["opt"]["seq"][1] == []
    assert isinstance(state["opt"]["seq"], tuple)
    c, tau, k = ckpt.load_router(base)
    assert tau == 10.0 and k == 1 and c.shape == (2, 2)
    # and the port's own round trip
    ckpt.save_expert(base, 2, 7, {"params": params})
    again, _ = ckpt.restore_expert(base, 2)
    assert torch.equal(from_tree(again["params"])["h"], params["h"])


# ---------------------------------------------------------------------------
# The launcher twin and the chip script's training deployment
# ---------------------------------------------------------------------------

def test_launcher_twin_trains_a_run_both_launchers_serve(tmp_path, capsys,
                                                         monkeypatch):
    """``repro_torch.launch.train --device cpu`` writes the reference's run
    layout; ``repro.launch.serve`` and ``repro_torch.launch.serve --device
    cpu`` serve its experts with identical tokens; its ``router.npz``
    equals the reference launcher's for the same flags."""
    flags = ["--steps", "2", "--seq-len", "16", "--batch", "4",
             "--samples", "256"]
    run, jrun = str(tmp_path / "port"), str(tmp_path / "ref")
    report = launch_train.main(flags + ["--out", run, "--device", "cpu"])
    assert [e["expert"] for e in report["experts"]] == [0, 1]
    assert all(np.isfinite(e["final_loss"]) for e in report["experts"])
    with open(f"{run}/train_summary.json") as f:
        assert json.load(f)["args"]["steps"] == 2
    monkeypatch.setattr("sys.argv", ["train"] + flags + ["--out", jrun])
    jax_launch_train.main()
    for name in ("centroids", "temperature", "top_k"):
        a, b = np.load(f"{run}/router.npz"), np.load(f"{jrun}/router.npz")
        assert a[name].dtype == b[name].dtype
        np.testing.assert_array_equal(a[name], b[name])
    capsys.readouterr()
    base = ["--run", run, "--requests", "3", "--prompt-len", "10",
            "--new-tokens", "5", "--slots", "2"]
    monkeypatch.setattr("sys.argv", ["serve"] + base + ["--stream"])
    jax_launch_serve.main()
    want = {}
    for rid, toks in re.findall(r"rid=\s*(\d+) \+(\[[^\]]*\])",
                                capsys.readouterr().out):
        want.setdefault(int(rid), []).extend(eval(toks))
    got = launch_serve.main(base + ["--device", "cpu"])["tokens"]
    assert got == want and len(want) == 3


def test_launcher_twin_dense_mode(tmp_path):
    """``--mode dense``: one model on the whole corpus, saved as expert 0
    with its optimizer state, which the port's reader restores."""
    hist = launch_train.main(["--mode", "dense", "--steps", "2",
                              "--seq-len", "16", "--batch", "2",
                              "--samples", "64", "--out", str(tmp_path),
                              "--device", "cpu"])["dense"]
    assert [h["step"] for h in hist] == [0, 1]
    state, step = ckpt.restore_expert(str(tmp_path), 0)
    assert step == 2 and int(state["opt"]["count"]) == 2
    assert sorted(state) == ["opt", "params"]


def test_launcher_twin_refuses_hybrid_training(tmp_path):
    with pytest.raises(ValueError, match="training family 'hybrid' is not "
                                         "ported to repro_torch yet"):
        launch_train.main(["--arch", "zamba2_2_7b", "--steps", "1",
                           "--seq-len", "16", "--batch", "2", "--samples",
                           "64", "--out", str(tmp_path), "--device", "cpu"])


def test_train_path_rehearses_on_cpu():
    """``launch/train_path.py`` at smoke size: the launcher's partition
    (two balanced shards), one sequence per expert step, and a few steps
    of each expert with finite losses and every gradient present."""
    tp = train_path.build("cpu", smoke=True)
    assert [len(s) for s in tp.partition.shards] == [1024, 1024]
    assert tp.tokens_per_step == train_path.SMOKE_SEQ_LEN
    for k in range(train_path.N_EXPERTS):
        state = tp.init_state(k)
        state, hist = trainer.train_host_loop(tp.model, state,
                                              tp.loaders[k], tp.steps,
                                              tp.config, log_every=1)
        assert len(hist) == tp.steps
        assert all(np.isfinite(h["loss"]) for h in hist)
        assert all(bool(m.abs().amax() > 0)
                   for _, m in tree_leaves(state["opt"]["m"]))


def test_profile_train_rehearses_on_cpu(capsys):
    """``launch/profile_train.py --smoke --device cpu``: the steps before,
    under and after the profiler run with finite losses, and no device
    number is reported from the CPU."""
    from repro_torch.launch import profile_train
    rep = profile_train.main(["--smoke", "--device", "cpu", "--steps", "1"])
    assert json.loads(capsys.readouterr().out) == rep
    assert rep["device"] == "cpu" and rep["layers"] == 2
    assert len(rep["losses"]) == 2 and all(np.isfinite(rep["losses"]))
    assert rep["device_busy_share"] == "not measured (CPU run)"
    assert "device_ms" not in rep


def test_training_entry_points_default_to_the_card(monkeypatch, tmp_path):
    """Without ``device="cpu"`` the training entry points ask for the card
    and raise where there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        train_path.build(smoke=True)
    with pytest.raises(RuntimeError, match="is_available"):
        launch_train.main(["--out", str(tmp_path)])
