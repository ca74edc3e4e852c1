"""The port's vlm family under the Eq. 27 mixture against the JAX
reference (the float32 ``internvl2_2b`` smoke config and 2 experts of
``test_torch_vlm.py``, whose helpers this module imports,
``RouterConfig(top_k=2)``).

The whole slice: the ``MixtureSlotServer`` emits exactly the reference's
tokens, finish reasons (stop, length and truncated among them) and
speculation counters in paged + chunked (chunk 8), paged + monolithic and
contiguous + monolithic serving, and paged + chunked with n-gram and with
expert-0 speculation; two of the six requests are sampled, seeded, in
every run. The stacked prefill: each expert's projector sees the
request's one set of patches, so each expert's logits from the stacked
monolithic prefill and from every stacked chunk step equal its own
single-model steps within 1e-5 (the stack's batched products are the
single model's arithmetic up to the products' blocking).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_vlm import (ARCH, BLOCK, CACHE_LEN, CHUNK,  # noqa: E402
                            CONFIGS, K, build_dep, check_slice, find_stops)

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import ensemble  # noqa: E402
from repro_torch.models import build_model  # noqa: E402


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


@pytest.mark.parametrize("kind", list(CONFIGS))
def test_vlm_mixture_slice_matches_reference_token_for_token(dep, stops,
                                                             kind):
    check_slice(dep, stops, "mixture", kind)


def test_stacked_vlm_prefill_matches_each_expert(dep):
    """The patches are repeated K times, expert-major, before the stacked
    projector's product; a 19-token prompt behind its 16 prefix rows, in
    five chunks of 8."""
    model = build_model(get_smoke_config(ARCH))
    stacked = ensemble.stack_experts_for_decode(dep["texperts"])
    prompt, patches = dep["prompts"][3], dep["patches"][3]
    width = 16 + len(prompt)
    padded = np.concatenate([prompt, np.zeros(-width % CHUNK, np.int32)])

    def batch(toks):
        return {"tokens": torch.as_tensor(toks[None].astype(np.int64)),
                "patches": torch.as_tensor(patches[None])}

    nb = CACHE_LEN // BLOCK
    table = torch.arange(1, nb + 1, dtype=torch.int32)

    def steps(params, experts):
        logits, _ = model.prefill(params, batch(prompt), CACHE_LEN)
        out = [logits[..., -1, :]]
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
    for k, params in enumerate(dep["texperts"]):
        for one, both in zip(steps(params, 0), mixed):
            torch.testing.assert_close(one, both[k], rtol=1e-5, atol=1e-5)
