"""The port's Eq. 27 mixture on the hybrid family (Zamba2: Mamba2 groups
and one shared attention block; the float32 ``zamba2_2_7b`` smoke config)
against the JAX reference's ``MixtureSlotServer``, which serves it: the
same checks as ``test_torch_mixture.py`` runs on the dense family (its
helpers, with the prefill chunk at the smoke config's scan length, 16),
where the experts' Mamba2 states and conv windows step as K·B rows of the
stacked cache.
"""
import pytest

torch = pytest.importorskip("torch")

from test_torch_mixture import (build_deployment, check_invariants,  # noqa: E402
                                check_probs_against_reference,
                                check_slice_against_reference,
                                check_stacked_steps_match_each_expert,
                                configs, find_stops)

ARCH = "zamba2_2_7b"
CHUNK = 16          # a multiple of the chunkwise-scan length


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module, restored after it: with
    parallel test workers each starting a thread per core, the threads
    contend and these smoke-size steps run many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def deployment():
    return build_deployment(ARCH)


@pytest.fixture(scope="module")
def stops(deployment):
    return find_stops(deployment, configs(CHUNK)["paged-chunked"])


@pytest.mark.parametrize("kind", list(configs(CHUNK))
                         + ["paged-chunked-sampled"])
def test_hybrid_mixture_matches_reference_token_for_token(deployment, stops,
                                                          kind):
    check_slice_against_reference(deployment, stops, kind, CHUNK)


def test_hybrid_mixture_invariants(deployment, stops):
    check_invariants(deployment, stops, CHUNK)


def test_hybrid_mixed_probabilities_match_reference(deployment):
    check_probs_against_reference(deployment, CHUNK)


def test_hybrid_stacked_steps_match_each_expert(deployment):
    check_stacked_steps_match_each_expert(deployment, CHUNK)
