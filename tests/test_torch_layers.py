"""Port layers and paged attention paths against the JAX reference.

Inputs are made with numpy from a seed and fed to both packages as float32
(``tests/conftest.py`` turns on x64 for the whole run, so every array is cast
before it reaches JAX). Tolerance is rtol = atol = 2e-5 throughout: both
sides compute in float32 and differ only in summation order and in the
libm behind exp/rsqrt/sin, which moves float32 results by a few ulp.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import build_model, layers  # noqa: E402
from repro_torch.models.params import is_spec  # noqa: E402
from repro_torch.weights import from_tree  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-5)


def f32(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def test_rms_norm():
    rng = np.random.default_rng(0)
    x, s = f32(rng, 2, 5, 16), f32(rng, 16)
    close(layers.rms_norm(torch.as_tensor(x), torch.as_tensor(s), 1e-5),
          jlayers.rms_norm(jnp.asarray(x), jnp.asarray(s), 1e-5))


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_apply_rope(theta):
    rng = np.random.default_rng(1)
    x = f32(rng, 2, 5, 4, 32)
    pos = rng.integers(0, 64, size=(2, 5)).astype(np.int32)
    close(layers.apply_rope(torch.as_tensor(x), torch.as_tensor(pos), theta),
          jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))


def test_swiglu_and_embed():
    rng = np.random.default_rng(2)
    p = {"w_gate": f32(rng, 16, 24), "w_up": f32(rng, 16, 24),
         "w_down": f32(rng, 24, 16)}
    x = f32(rng, 3, 16)
    close(layers.swiglu(from_tree(p), torch.as_tensor(x)),
          jlayers.swiglu(jax.tree.map(jnp.asarray, p), jnp.asarray(x)))
    e = {"embedding": f32(rng, 10, 8)}
    toks = np.array([[1, 9, 0]], np.int32)
    close(layers.embed(from_tree(e), torch.as_tensor(toks).long(),
                       torch.float32),
          jlayers.embed({"embedding": jnp.asarray(e["embedding"])},
                        jnp.asarray(toks), jnp.float32))


@pytest.mark.parametrize("tie,true_vocab", [(False, 0), (False, 13),
                                            (True, 13)])
def test_unembed(tie, true_vocab):
    rng = np.random.default_rng(3)
    p = {"embedding": f32(rng, 16, 8), "unembed": f32(rng, 8, 16)}
    x = f32(rng, 2, 1, 8)
    got = layers.unembed(from_tree(p), torch.as_tensor(x), tie, true_vocab)
    want = jlayers.unembed(jax.tree.map(jnp.asarray, p), jnp.asarray(x), tie,
                           true_vocab)
    assert got.dtype == torch.float32
    close(got, want)


def test_gqa_sdpa():
    rng = np.random.default_rng(4)
    q, k, v = f32(rng, 2, 3, 8, 16), f32(rng, 2, 7, 2, 16), f32(rng, 2, 7, 2, 16)
    mask = rng.random((2, 3, 7)) < 0.7
    mask[..., 0] = True
    close(attn.gqa_sdpa(*(torch.as_tensor(a) for a in (q, k, v)),
                        torch.as_tensor(mask)),
          jattn.gqa_sdpa(*(jnp.asarray(a) for a in (q, k, v)),
                         jnp.asarray(mask)))


def test_param_specs_match_reference():
    """Same tree, shapes, logical axes and init rules as the reference."""
    got = build_model(get_smoke_config("qwen3_8b")).param_specs()
    want = jax_build(jax_smoke("qwen3_8b")).param_specs()

    def flat(tree, pre=""):
        if is_spec(tree) or not isinstance(tree, dict):
            return {pre: (tuple(tree.shape), tuple(tree.logical), tree.init,
                          tree.scale)}
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{pre}/{k}"))
        return out
    assert flat(got) == flat(want)


def test_init_shapes_and_scales():
    """Init parity is shape and scale only (jax.random draws cannot be
    reproduced): leaves match the reference's shapes and dtype, "ones"
    leaves are ones, and every random leaf's std is within 10% of the
    reference leaf's (the reference takes fan-in from a stacked leaf's
    leading dim, and so does the port)."""
    cfg = get_smoke_config("qwen3_8b")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    want = jax_build(jax_smoke("qwen3_8b")).init(jax.random.PRNGKey(0))
    jflat = {"/".join(str(getattr(k, "key", k)) for k in path): leaf
             for path, leaf in jax.tree_util.tree_flatten_with_path(want)[0]}

    def walk(tree, pre=""):
        for k, v in tree.items():
            key = f"{pre}/{k}" if pre else k
            if isinstance(v, dict):
                yield from walk(v, key)
            else:
                yield key, v
    got = dict(walk(params))
    assert got.keys() == jflat.keys()
    for key, t in got.items():
        assert tuple(t.shape) == jflat[key].shape and t.dtype == torch.float32
        ref_std = float(np.asarray(jflat[key]).std())
        if ref_std == 0.0:                          # "ones" leaves
            assert torch.equal(t, torch.ones_like(t)), key
        else:
            assert abs(t.std().item() / ref_std - 1.0) < 0.1, key


# ---------------------------------------------------------------------------
# paged attention paths (layer 0 of the smoke model, reference weights)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def layer0():
    jcfg = jax_smoke("qwen3_8b")
    params = jax_build(jcfg).init(jax.random.PRNGKey(0))
    jl = jax.tree.map(lambda a: a[0], params["blocks"]["attn"])
    return jcfg, get_smoke_config("qwen3_8b"), jl, \
        from_tree(jax.tree.map(np.asarray, jl))


def _pools(rng, P, block, cfg):
    shape = (P, block, cfg.n_kv_heads, cfg.head_dim)
    return f32(rng, *shape), f32(rng, *shape)


def _close_pool(got, want):
    """Compare pools outside scratch block 0: padded chunk rows and idle
    slots all write (block 0, offset 0), and which duplicate write wins is
    undefined in both frameworks."""
    np.testing.assert_allclose(got[1:].numpy(), np.asarray(want)[1:], **TOL)


@pytest.mark.parametrize("start,length", [(0, 8), (16, 5), (11, 8)])
def test_chunk_attention_matches_reference(layer0, start, length):
    jcfg, cfg, jl, tl = layer0
    rng = np.random.default_rng(start)
    block, NB = 8, 4
    kp, vp = _pools(rng, 7, block, cfg)
    table = np.array([3, 1, 6, 0], np.int32)       # last entry unallocated
    x = f32(rng, 1, 8, cfg.d_model)
    out, (k, v) = attn.chunk_attention(
        tl, torch.as_tensor(x), cfg, (torch.as_tensor(kp),
                                      torch.as_tensor(vp)),
        start, length, torch.as_tensor(table))
    jout, (jk, jv) = jattn.chunk_attention(
        jl, jnp.asarray(x), jcfg, (jnp.asarray(kp), jnp.asarray(vp)),
        jnp.int32(start), jnp.int32(length), jnp.asarray(table),
        use_kernel=False)
    close(out[:, :length], jout[:, :length])
    _close_pool(k, jk)
    _close_pool(v, jv)


def test_paged_decode_attention_matches_reference(layer0):
    jcfg, cfg, jl, tl = layer0
    rng = np.random.default_rng(7)
    block = 8
    kp, vp = _pools(rng, 9, block, cfg)
    tables = np.array([[2, 5, 0], [7, 1, 4], [0, 0, 0]], np.int32)
    pos = np.array([9, 23, 0], np.int32)           # slot 2 idle → scratch
    x = f32(rng, 3, 1, cfg.d_model)
    out, (k, v) = attn.paged_decode_attention(
        tl, torch.as_tensor(x), cfg, (torch.as_tensor(kp),
                                      torch.as_tensor(vp)),
        torch.as_tensor(pos), torch.as_tensor(tables))
    jout, (jk, jv) = jattn.paged_decode_attention(
        jl, jnp.asarray(x), jcfg, (jnp.asarray(kp), jnp.asarray(vp)),
        jnp.asarray(pos), jnp.asarray(tables), use_kernel=False)
    close(out[:2], jout[:2])
    _close_pool(k, jk)
    _close_pool(v, jv)


# ---------------------------------------------------------------------------
# full-sequence and contiguous-cache attention (layer 0, reference weights)
# ---------------------------------------------------------------------------

def _windowed(layer0, window):
    jcfg, cfg, jl, tl = layer0
    return jcfg.reduced(sliding_window=window), \
        cfg.reduced(sliding_window=window), jl, tl


def test_causal_mask_matches_reference():
    for window in (0, 3):
        np.testing.assert_array_equal(
            attn.causal_mask(7, window).numpy(),
            np.asarray(jattn.causal_mask(7, window)))


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 4)])
def test_full_attention_matches_reference(layer0, causal, window):
    jcfg, cfg, jl, tl = _windowed(layer0, window)
    x = f32(np.random.default_rng(8), 2, 11, cfg.d_model)
    close(attn.full_attention(tl, torch.as_tensor(x), cfg, causal=causal),
          jattn.full_attention(jl, jnp.asarray(x), jcfg, causal=causal))


@pytest.mark.parametrize("window", [0, 4])
def test_prefill_attention_matches_reference(layer0, window):
    """Output and the K/V right-padded to cache_len."""
    jcfg, cfg, jl, tl = _windowed(layer0, window)
    x = f32(np.random.default_rng(9), 1, 9, cfg.d_model)
    out, (k, v) = attn.prefill_attention(tl, torch.as_tensor(x), cfg, 16)
    jout, (jk, jv) = jattn.prefill_attention(jl, jnp.asarray(x), jcfg, 16)
    close(out, jout)
    close(k, jk)
    close(v, jv)
    assert k.shape[1] == 16 and not k[:, 9:].any()


@pytest.mark.parametrize("window,pos", [(0, (9, 0, 15)), (16, (3, 16, 40))])
def test_decode_attention_matches_reference(layer0, window, pos):
    """Per-slot positions over contiguous rows of 16 — with a window of 16
    the rows are rings (slot 1 writes wrapped to 0, slot 2 to 8, and both
    attend every key); slot 1 of the unwindowed case is idle at 0. The
    whole cache is compared: each row's write lands in its own row."""
    jcfg, cfg, jl, tl = _windowed(layer0, window)
    rng = np.random.default_rng(10)
    shape = (3, 16, cfg.n_kv_heads, cfg.head_dim)
    kc, vc = f32(rng, *shape), f32(rng, *shape)
    x = f32(rng, 3, 1, cfg.d_model)
    pos = np.asarray(pos, np.int32)
    out, (k, v) = attn.decode_attention(
        tl, torch.as_tensor(x), cfg, (torch.as_tensor(kc),
                                      torch.as_tensor(vc)),
        torch.as_tensor(pos))
    jout, (jk, jv) = jattn.decode_attention(
        jl, jnp.asarray(x), jcfg, (jnp.asarray(kc), jnp.asarray(vc)),
        jnp.asarray(pos), use_kernel=False)
    close(out, jout)
    close(k, jk)
    close(v, jv)
