"""The port's audio family under the Eq. 27 mixture and in the whole-batch
engines, against the JAX reference (the float32
``whisper_small`` smoke config and 2 experts of ``test_torch_audio.py``,
whose helpers this module imports, ``RouterConfig(top_k=2)``).

The whole slice: the ``MixtureSlotServer`` emits exactly the reference's
tokens and finish reasons (stop, length and truncated among them) in
paged + chunked (chunk 8), paged + monolithic and contiguous + monolithic
serving; two of the six requests are sampled, seeded, in every run (with
n-gram and expert-0 speculation in
``test_torch_audio_mixture_speculative.py``, with the launchers). The
stack: ``stack_experts_for_decode`` puts K after the layer dim of the
encoder's blocks too, (L_enc, K, ...), as the reference does,
and ``expert_slice`` gives each expert's tree back; the stacked encoder
encodes the frames repeated K times, so each expert's logits from the
stacked monolithic prefill and from every stacked chunk step equal its
own single-model steps within 1e-5. The whole-batch engines on a batch
that holds frames: ``ServeEngine.generate`` and ``DecentralizedServer``'s
``generate_top1`` and ``generate_mixture`` emit the reference's tokens,
greedy and sampled, and ``ensemble_eval_nll`` agrees within rtol 1e-4.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.router import CentroidRouter as JaxRouter  # noqa: E402
from repro.core.router import RouterConfig as JaxRouterConfig  # noqa: E402
from repro.serve import api as japi  # noqa: E402
from repro.serve.engine import ServeEngine as JaxServeEngine  # noqa: E402
from repro.serve.ensemble_engine import (  # noqa: E402
    DecentralizedServer as JaxDecentralizedServer)
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import ensemble  # noqa: E402
from repro_torch.core.router import CentroidRouter, RouterConfig  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serve.api import SamplingParams  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.serve.ensemble_engine import DecentralizedServer  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

from test_torch_audio import (ARCH, BASE_KINDS, BLOCK,  # noqa: E402
                              CACHE_LEN, CHUNK, K, build_dep, check_slice,
                              find_stops)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def dep():
    return build_dep()


@pytest.fixture(scope="module")
def stops(dep):
    return find_stops(dep)


@pytest.mark.parametrize("kind", BASE_KINDS)
def test_audio_mixture_slice_matches_reference_token_for_token(dep, stops,
                                                               kind):
    check_slice(dep, stops, "mixture", kind)


# ---------------------------------------------------------------------------
# The expert stack
# ---------------------------------------------------------------------------

def test_stack_puts_the_encoder_blocks_layer_major(dep):
    """Every leaf of ``encoder/blocks`` is (L_enc, K, ...) with layer i of
    expert k at [i, k], like ``blocks``; the encoder's ``in_proj`` and
    ``norm`` lead with K; ``expert_slice`` gives each expert's tree back
    exactly."""
    stacked = ensemble.stack_experts_for_decode(dep["texperts"])
    flat = dict(tree_leaves(stacked))
    for k, params in enumerate(dep["texperts"]):
        for path, leaf in tree_leaves(params):
            got = flat[path]
            if path.startswith(("blocks/", "encoder/blocks/")):
                assert got.shape == (leaf.shape[0], K) + leaf.shape[1:]
                for i in range(leaf.shape[0]):
                    assert torch.equal(got[i, k], leaf[i]), path
            else:
                assert got.shape == (K,) + leaf.shape, path
                assert torch.equal(got[k], leaf), path
        back = dict(tree_leaves(ensemble.expert_slice(stacked, k)))
        assert sorted(back) == sorted(dict(tree_leaves(params)))
        for path, leaf in tree_leaves(params):
            assert torch.equal(back[path], leaf), path


def test_stacked_audio_prefill_matches_each_expert(dep):
    """The frames are repeated K times, expert-major, before the stacked
    encoder; a 35-token prompt in five chunks of 8; the stacked cache's
    cross-attention K/V are each expert's."""
    model = build_model(get_smoke_config(ARCH))
    stacked = ensemble.stack_experts_for_decode(dep["texperts"])
    prompt, frames = dep["prompts"][3], dep["frames"][3]
    width = len(prompt)
    padded = np.concatenate([prompt, np.zeros(-width % CHUNK, np.int32)])

    def batch(toks):
        return {"tokens": torch.as_tensor(toks[None].astype(np.int64)),
                "frames": torch.as_tensor(frames[None])}

    nb = CACHE_LEN // BLOCK
    table = torch.arange(1, nb + 1, dtype=torch.int32)

    def steps(params, experts):
        logits, cache = model.prefill(params, batch(prompt), CACHE_LEN)
        out = [logits[..., -1, :], cache["xk"], cache["xv"]]
        pool = model.init_paged_cache(1, nb + 1, BLOCK, CACHE_LEN,
                                      device="cpu", experts=experts)
        x = model.embed_prompt(params, batch(padded))
        carry = model.init_chunk_carry(params, batch(padded), CACHE_LEN)
        for start in range(0, width, CHUNK):
            c_logits, carry, pool = model.prefill_chunk(
                params, pool, carry, x[:, start:start + CHUNK], start,
                min(CHUNK, width - start), table)
            out.append(c_logits)
        return out

    mixed = steps(stacked, K)
    assert mixed[0].shape == (K, 1, 512)
    assert mixed[1].shape == (2, K, 1, 32, 4, 32)
    for k, params in enumerate(dep["texperts"]):
        one = steps(params, 0)
        torch.testing.assert_close(one[1], mixed[1][:, k], rtol=1e-5,
                                   atol=1e-5)
        torch.testing.assert_close(one[2], mixed[2][:, k], rtol=1e-5,
                                   atol=1e-5)
        for a, b in zip(one[:1] + one[3:], mixed[:1] + mixed[3:]):
            torch.testing.assert_close(a, b[k], rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# The whole-batch engines
# ---------------------------------------------------------------------------

B, S, BATCH_CACHE_LEN = 4, 10, 24


@pytest.fixture(scope="module")
def engines(dep):
    rng = np.random.default_rng(1)
    cfg = dep["jm"].cfg
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    frames = rng.normal(size=(B, cfg.n_audio_frames, cfg.audio_dim)) \
        .astype(np.float32)
    feats = np.concatenate([dep["cent"], -dep["cent"]]) \
        + 0.1 * rng.normal(size=(B, dep["cent"].shape[1])).astype(np.float32)
    arrays = dict(tokens=toks, labels=labels, frames=frames,
                  features=feats.astype(np.float32))
    jbatch = {k: jnp.asarray(v) for k, v in arrays.items()}
    tbatch = {k: torch.as_tensor(v) for k, v in arrays.items()}
    jserver = JaxDecentralizedServer(
        dep["jm"], dep["jexperts"],
        JaxRouter(jnp.asarray(dep["cent"]), JaxRouterConfig(top_k=2)),
        cache_len=BATCH_CACHE_LEN)
    tserver = DecentralizedServer(
        build_model(get_smoke_config(ARCH)), dep["texperts"],
        CentroidRouter(torch.as_tensor(dep["cent"]), RouterConfig(top_k=2)),
        cache_len=BATCH_CACHE_LEN)
    return dict(jbatch=jbatch, tbatch=tbatch, jserver=jserver,
                tserver=tserver)


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_batch_engines_with_frames_match_reference(dep, engines,
                                                   temperature):
    sp = dict(max_new=6, temperature=temperature, seed=3)
    jb, tb = engines["jbatch"], engines["tbatch"]
    want = JaxServeEngine(dep["jm"], BATCH_CACHE_LEN).generate(
        dep["jexperts"][1], {k: jb[k] for k in ("tokens", "frames")},
        japi.SamplingParams(**sp))
    got = ServeEngine(build_model(get_smoke_config(ARCH)),
                      BATCH_CACHE_LEN).generate(
        dep["texperts"][1], {k: tb[k] for k in ("tokens", "frames")},
        SamplingParams(**sp))
    assert got.numpy().tolist() == np.asarray(want).tolist()
    for name in ("generate_top1", "generate_mixture"):
        want = getattr(engines["jserver"], name)(jb,
                                                 japi.SamplingParams(**sp))
        got = getattr(engines["tserver"], name)(tb, SamplingParams(**sp))
        assert np.asarray(got).tolist() == np.asarray(want).tolist(), name
    routes = engines["jserver"].router.top1(jb["features"])
    assert len(set(np.asarray(routes).tolist())) == K    # both groups


def test_eval_nll_with_frames_matches_reference(engines):
    np.testing.assert_allclose(
        float(engines["tserver"].ensemble_eval_nll(engines["tbatch"])),
        float(engines["jserver"].ensemble_eval_nll(engines["jbatch"])),
        rtol=1e-4)
