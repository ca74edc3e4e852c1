"""The port's audio family against the JAX reference, continued (the
float32 ``whisper_small`` smoke config and 2 experts of
``test_torch_audio.py``, whose helpers this module imports).

n-gram speculation and the unfused step (``fused_step=False``): the
top-1 slice emits exactly the reference's tokens, finish reasons and
speculation counters in paged + chunked serving with n-gram speculation,
and in paged + chunked and contiguous + monolithic serving with the
unfused step, two of the six requests sampled.
The serving host layer: with the prefix cache, the same tokens under the
same frames hit and under other frames miss, as in the reference
(``occupancy()`` equal, and the tokens of an uncached run); a swap park's
payload holds the slot's cross-attention K/V (its direct leaves) beside
its blocks, and the resumed request emits the reference's tokens, is
parked as often, and ``stats()`` agree.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.serve import api as japi  # noqa: E402
from repro.serve import scheduler as jsched  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serve import scheduler as sched  # noqa: E402
from repro_torch.serve.api import EngineConfig, SamplingParams  # noqa: E402

from test_torch_audio import (ARCH, BLOCK, TOP1_KINDS,  # noqa: E402
                              build_dep, check_slice, find_stops, frames_of,
                              port_engine, reference_engine)


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


@pytest.mark.parametrize("kind", [k for k in TOP1_KINDS
                                  if "unfused" in k or "ngram" in k])
def test_audio_top1_slice_matches_reference_token_for_token(dep, stops,
                                                            kind):
    check_slice(dep, stops, "top1", kind)


# ---------------------------------------------------------------------------
# The serving host layer
# ---------------------------------------------------------------------------

def _prefix_traffic(dep):
    """Request 0, its exact repeat under the same frames (a hit), and its
    tokens under other frames (a miss), all on pod 0."""
    rng = np.random.default_rng(9)
    cfg = dep["jm"].cfg
    toks = rng.integers(0, cfg.vocab, 21).astype(np.int32)
    same, other = frames_of(cfg, rng), frames_of(cfg, rng)
    return [(toks, same), (toks, same), (toks, other)]


def _serve_in_turn(engine, sp_cls, dep, traffic):
    """Each request served to the end before the next is submitted."""
    res = {}
    for i, (toks, frames) in enumerate(traffic):
        engine.add_request(toks, sp_cls(max_new=6), {"frames": frames},
                           features=dep["cent"][0], rid=i)
        while engine.has_unfinished():
            for o in engine.step():
                if o.finished:
                    res[o.rid] = o.token_ids
    return res


def test_prefix_cache_hits_by_frames_as_the_reference(dep):
    """The same 21 tokens three times: under the same frames the second
    request skips the two full cached blocks (16 tokens), under other
    frames the third skips none; tokens and ``occupancy()`` equal to the
    reference's, and to an uncached run's."""
    traffic = _prefix_traffic(dep)
    eng = port_engine(dep, "top1", "paged-chunked", prefix_cache=True)
    got = _serve_in_turn(eng, SamplingParams, dep, traffic)
    jeng = reference_engine(dep, "top1", "paged-chunked", prefix_cache=True)
    assert got == _serve_in_turn(jeng, japi.SamplingParams, dep, traffic)
    assert got == _serve_in_turn(port_engine(dep, "top1", "paged-chunked"),
                                 SamplingParams, dep, traffic)
    occ = eng.occupancy()
    assert occ == jeng.occupancy()
    assert sum(p["prefix_skipped_tokens"] for p in occ) == 2 * BLOCK
    assert got[0] == got[1] and got[0] != got[2]


def _swap_queue(dep, port):
    """Two priority-0 requests that outgrow a 7-block pool, then a
    priority-2 one that forces a park; request 1 sampled."""
    mod, sp_cls = (sched, SamplingParams) if port \
        else (jsched, japi.SamplingParams)
    rng = np.random.default_rng(3)
    cfg = dep["jm"].cfg
    reqs = []
    for i, (m, p) in enumerate(((10, 0), (10, 0), (4, 2))):
        sp = sp_cls(max_new=m, temperature=0.8 * (i % 2), seed=100 + i,
                    priority=p)
        reqs.append(mod.Request(
            i, rng.integers(0, cfg.vocab, 8).astype(np.int32), m, params=sp,
            features=dep["cent"][0], extras={"frames": frames_of(cfg, rng)}))
    return reqs


def test_swap_park_restores_cross_kv_as_the_reference(dep, monkeypatch):
    """A swap park's payload holds the victim's cross-attention K/V (its
    direct leaves) beside its blocks; the resumed request emits the
    reference's tokens, parks as often, and ``stats()`` agree."""
    cfg = dict(n_slots=2, cache_len=32, paged=True, page_block=4,
               pool_blocks=7, chunked_prefill=True, chunk=8,
               preemption="swap")
    model = build_model(get_smoke_config(ARCH))
    eng = sched.make_engine(model, params=dep["texperts"][0], device="cpu",
                            config=EngineConfig(**cfg))
    payloads = []
    swap_out = type(eng.spec).swap_out
    monkeypatch.setattr(type(eng.spec), "swap_out", lambda *a: payloads
                        .append(swap_out(*a)) or payloads[-1])
    q = _swap_queue(dep, True)
    got = (eng.serve(q), [r.preemptions for r in q], eng.stats())
    jeng = jsched.make_engine(dep["jm"], params=dep["jexperts"][0],
                              config=japi.EngineConfig(**cfg))
    jq = _swap_queue(dep, False)
    assert got == (jeng.serve(jq), [r.preemptions for r in jq],
                   jeng.stats())
    assert sum(got[1]) > 0, "no preemption: the check is vacuous"
    assert payloads and payloads[0]["xk"].shape == (2, 1, 32, 4, 32)
    assert payloads[0]["xk"].abs().max() > 0


