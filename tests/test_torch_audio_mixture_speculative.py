"""The port's audio family under the Eq. 27 mixture with speculative
decoding, and its launchers, against the JAX reference (the float32
``whisper_small`` smoke config and 2 experts of ``test_torch_audio.py``,
whose helpers this module imports, ``RouterConfig(top_k=2)``).

The ``MixtureSlotServer`` emits exactly the reference's tokens, finish
reasons and speculation counters in paged + chunked serving with n-gram
and with expert-0 speculation (drafts accepted); two of the six requests
are sampled, seeded. The launchers have no audio frontend: both refuse
``--arch whisper_small`` where the reference's fail, at the first
admission or training step, with the port's clear error.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint import ckpt as jckpt  # noqa: E402
from repro.launch import serve as jax_launch_serve  # noqa: E402
from repro.launch import train as jax_launch_train  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402

from test_torch_audio import (ARCH, K, build_dep, check_slice,  # noqa: E402
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


@pytest.mark.parametrize("kind", ["paged-chunked-ngram",
                                  "paged-chunked-expert"])
def test_audio_mixture_speculation_matches_reference_token_for_token(
        dep, stops, kind):
    check_slice(dep, stops, "mixture", kind)


# ---------------------------------------------------------------------------
# The launchers
# ---------------------------------------------------------------------------

def test_launchers_refuse_audio_where_the_reference_fails(dep, tmp_path,
                                                          monkeypatch):
    """Neither launcher has an audio frontend. The serving launchers fail
    at the first admission, the reference's batch without ``frames``, the
    port with its clear error; so do the training launchers at the first
    step (the synthetic corpus has no audio)."""
    run = str(tmp_path / "run")
    for k in range(K):
        jckpt.save_expert(run, k, 1, {"params": dep["jexperts"][k]})
    # the launchers' synthetic requests carry 32 features
    cent = np.random.default_rng(2).normal(size=(K, 32)).astype(np.float32)
    jckpt.save_router(run, cent, 10.0, 1)
    flags = ["--run", run, "--arch", ARCH, "--requests", "2",
             "--prompt-len", "8", "--new-tokens", "4", "--slots", "2"]
    for extra in ([], ["--paged", "--page-block", "8", "--chunked-prefill",
                       "--prefill-chunk", "8"]):
        monkeypatch.setattr("sys.argv", ["serve"] + flags + extra)
        with pytest.raises(KeyError, match="frames"):
            jax_launch_serve.main()
        with pytest.raises(ValueError, match="the batch has no 'frames'"):
            launch_serve.main(flags + extra + ["--device", "cpu"])
    train = ["--arch", ARCH, "--mode", "dense", "--steps", "1", "--seq-len",
             "8", "--batch", "2", "--samples", "16"]
    monkeypatch.setattr("sys.argv", ["train"] + train
                        + ["--out", str(tmp_path / "ref")])
    with pytest.raises(KeyError, match="frames"):
        jax_launch_train.main()
    with pytest.raises(ValueError, match="the batch has no 'frames'"):
        launch_train.main(train + ["--out", str(tmp_path / "port"),
                                   "--device", "cpu"])
