"""The moe family under the Eq. 27 mixture and with the prefix cache,
against the JAX reference's engines (the helpers and the top-1 slice are
``test_torch_moe_serve.py``'s): the float32 ``deepseek_moe_16b`` smoke
config, 2 decentralized experts carried across from the reference's
pytrees, at capacity factor 8.0 and at 1.0, where pairs are dropped.

Token for token, finish reason for finish reason and spec counter for
spec counter: the ``MixtureSlotServer`` (top_k 2) paged + chunked, its two
experts' rows stacked in one forward, each row its own routing group as
under the reference's ``jax.vmap``, and with expert-0 drafting over one
stacked verify; and the top-1 server with the prefix cache on requests
that share a 19-token prefix (a hit splices 16 cached positions, so the
chunks of a hit hold other tokens than a miss's, and drop other pairs).
Request 1 is sampled, seeded, in every run.
"""
import pytest

torch = pytest.importorskip("torch")

from test_torch_moe_serve import (CFS, check_serving, dep,  # noqa: E402,F401
                                  one_thread, reference)

MIXTURE_KINDS = ["mixture-paged-chunked", "mixture-paged-chunked-expert",
                 "paged-chunked-prefix"]


@pytest.mark.parametrize("cf", CFS)
@pytest.mark.parametrize("kind", MIXTURE_KINDS)
def test_moe_mixture_and_prefix_serve_as_the_reference(dep, reference, kind,
                                                       cf):
    check_serving(dep, reference, kind, cf)
