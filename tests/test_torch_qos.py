"""The port's multi-tenant QoS layer against the JAX reference, dense
family (the float32 ``qwen3_8b`` smoke config, one model's weights
carried across from the reference's pytree by ``repro_torch.weights``).

* Policy units: the reference's ``QoSConfig``, deficit-round-robin and
  ``predict_ttft`` cases on the port's copy (``serve.qos``).
* Preempt and resume: two low-priority requests fill both slots of a
  7-block pool and a high-priority arrival must park one. With
  ``preemption="swap"`` (paged + monolithic, and paged + chunked with
  n-gram speculation) and ``"recompute"`` (paged + chunked, and with the
  prefix cache), greedy and seeded-sampled requests side by side, the
  port's ``serve()`` emits the reference's tokens and finish reasons,
  preempts the same requests as often, and ends with the reference's
  ``stats()`` (the parks and the tenant breakdown among them); the same
  tokens as an unpressured run without preemption. A preemption landing
  in a speculative run falls back to vanilla spans with the same tokens.
* Aborting a parked request frees its payload and pins exactly; admission
  control rejects on queue depth and on predicted TTFT with
  ``finish_reason="rejected"``, as the reference does; the tenant
  breakdown after DRR admission with preemption equals the reference's.
* Under the ``sanitize`` marker: preempt/resume churn with the
  PoolSanitizer on stays clean, and a corrupted block table raises
  ``PoolSanitizerError``.

The mixture, vlm and hybrid families' parks are held against the
reference in ``test_torch_qos_families.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs.base import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.serve import api as japi  # noqa: E402
from repro.serve import qos as jqos  # noqa: E402
from repro.serve import scheduler as jsched  # noqa: E402
from repro_torch.analysis.sanitizer import PoolSanitizerError  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serve import scheduler as sched  # noqa: E402
from repro_torch.serve.api import EngineConfig, SamplingParams  # noqa: E402
from repro_torch.serve.qos import (QoSConfig, TenantScheduler,  # noqa: E402
                                   predict_ttft)
from repro_torch.weights import from_tree  # noqa: E402

ARCH = "qwen3_8b"
PORT = (sched, EngineConfig, SamplingParams, QoSConfig)
REF = (jsched, japi.EngineConfig, japi.SamplingParams, jqos.QoSConfig)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def dep():
    jm = jax_build(jax_smoke(ARCH))
    jparams = jm.init(jax.random.PRNGKey(0))
    return dict(jm=jm, jparams=jparams,
                tparams=from_tree(jax.tree.map(np.asarray, jparams)),
                tm=build_model(get_smoke_config(ARCH)), vocab=jm.cfg.vocab)


def engine(dep, side, **cfg):
    mod, ecls = side[0], side[1]
    if side is PORT:
        return mod.make_engine(dep["tm"], dep["tparams"], config=ecls(**cfg),
                               device="cpu")
    return mod.make_engine(dep["jm"], dep["jparams"], config=ecls(**cfg))


def mixed_queue(side, vocab, *, lens, budgets, priorities, tenants=None,
                temperatures=None, seed=3):
    """The reference test's queue: even ids greedy, odd ids seeded
    sampling unless ``temperatures`` says otherwise."""
    mod, sp_cls = side[0], side[2]
    rng = np.random.default_rng(seed)
    reqs = []
    for i, (n, m, p) in enumerate(zip(lens, budgets, priorities)):
        temp = temperatures[i] if temperatures is not None \
            else (0.0 if i % 2 == 0 else 0.8)
        sp = sp_cls(max_new=m, temperature=temp, seed=100 + i, priority=p,
                    tenant=tenants[i] if tenants is not None else "default")
        reqs.append(mod.Request(i, rng.integers(0, vocab, size=n)
                                .astype(np.int32), m, params=sp))
    return reqs


def served(dep, side, queue_fn, **cfg):
    """``serve()`` of the queue: (tokens, finish reasons, preemptions per
    request, stats())."""
    eng = engine(dep, side, **cfg)
    queue = queue_fn(side)
    out = eng.serve(queue)
    return (out, {r.rid: r.finish_reason for r in queue},
            {r.rid: r.preemptions for r in queue}, eng.stats())


# ---------------------------------------------------------------------------
# Policy units (the reference's cases on the port's copy)
# ---------------------------------------------------------------------------

def test_qos_config_validation():
    with pytest.raises(ValueError, match="weights must be > 0"):
        QoSConfig(tenant_weights=(("a", 0.0),))
    with pytest.raises(ValueError, match="quantum"):
        QoSConfig(quantum=-1)
    with pytest.raises(ValueError, match="admit_lookahead"):
        QoSConfig(admit_lookahead=0)
    assert QoSConfig(tenant_weights=(("a", 2.0),)).weight("a") == 2.0
    assert QoSConfig().weight("anyone") == 1.0


def test_drr_weighted_fairness_equals_reference():
    picks = []
    for Q, TS in ((QoSConfig, TenantScheduler),
                  (jqos.QoSConfig, jqos.TenantScheduler)):
        ts = TS(Q(tenant_weights=(("a", 2.0), ("b", 1.0))), quantum=8)
        picks.append([ts.pick({"a": 8, "b": 8, "c": 5 + i % 7})
                      for i in range(40)])
    assert picks[0] == picks[1]
    counts = {t: picks[0].count(t) for t in "ab"}
    assert 1.5 <= counts["a"] / counts["b"] <= 2.5, counts


def test_drr_within_cost_proportionality():
    ts = TenantScheduler(QoSConfig(), quantum=4)
    served_ = {"cheap": 0, "dear": 0}
    for _ in range(50):
        t = ts.pick({"cheap": 4, "dear": 16})
        served_[t] += {"cheap": 4, "dear": 16}[t]
    assert 0.5 <= served_["cheap"] / served_["dear"] <= 2.0, served_


def test_drr_refund_and_idle_pruning():
    ts = TenantScheduler(QoSConfig(), quantum=10)
    t = ts.pick({"a": 10, "b": 10})
    d0 = ts._deficit[t]
    ts.refund(t, 10)
    assert ts._deficit[t] == d0 + 10
    assert ts.pick({"b": 10}) == "b"
    assert "a" not in ts._deficit


def test_predict_ttft_equals_reference():
    for backlog, chunk, step in ((0, 16, 0.01), (160, 16, 0.01),
                                 (320, 16, 0.01), (100, 16, 0.0),
                                 (17, 0, 0.5)):
        assert predict_ttft(backlog, chunk, step) == \
            jqos.predict_ttft(backlog, chunk, step)
    assert predict_ttft(160, 16, 0.01) == pytest.approx(0.11)


# ---------------------------------------------------------------------------
# Preempt and resume ≡ the reference
# ---------------------------------------------------------------------------

PARITY_CONFIGS = {
    "swap_paged": dict(paged=True, page_block=4),
    "recompute_chunked": dict(paged=True, page_block=4,
                              chunked_prefill=True, chunk=8),
    "recompute_prefix": dict(paged=True, page_block=4, chunked_prefill=True,
                             chunk=8, prefix_cache=True),
    "swap_speculative": dict(paged=True, page_block=4, chunked_prefill=True,
                             chunk=8, speculative="ngram", spec_len=3),
}


def parity_queue(vocab):
    # two low-priority requests fill both slots; the high-priority arrival
    # must park one (7 blocks: 6 usable, each low request peaks at 4)
    return lambda side: mixed_queue(side, vocab, lens=(8, 8, 8),
                                    budgets=(6, 6, 4), priorities=(0, 0, 2))


@pytest.mark.parametrize("name", list(PARITY_CONFIGS))
def test_preempt_resume_matches_reference(dep, name):
    knobs = PARITY_CONFIGS[name]
    mode = name.split("_")[0]
    q = parity_queue(dep["vocab"])
    tight = dict(n_slots=2, cache_len=32, pool_blocks=7, preemption=mode,
                 **knobs)
    got = served(dep, PORT, q, **tight)
    want = served(dep, REF, q, **tight)
    assert got == want
    assert sum(got[2].values()) > 0, "no preemption: the check is vacuous"
    assert got[3]["parked"] == 0
    free = served(dep, PORT, q, n_slots=2, cache_len=32, **knobs)
    assert got[0] == free[0]


def test_preempt_resume_speculative_fallback(dep):
    """A preemption in a speculative run: span growth never preempts, it
    falls back to vanilla steps, and the tokens stay the reference's."""
    toks = np.tile(np.arange(4, dtype=np.int32), 3)

    def q(side):
        mod, sp_cls = side[0], side[2]
        return [mod.Request(i, toks.copy(), 6, params=sp_cls(
            max_new=6, priority=p, seed=50 + i,
            temperature=0.0 if i % 2 == 0 else 0.7))
            for i, p in enumerate((0, 0, 3))]
    knobs = dict(n_slots=2, cache_len=32, paged=True, page_block=4,
                 chunked_prefill=True, chunk=8, speculative="ngram",
                 spec_len=4)
    got = served(dep, PORT, q, pool_blocks=7, preemption="swap", **knobs)
    assert got == served(dep, REF, q, pool_blocks=7, preemption="swap",
                         **knobs)
    assert sum(got[2].values()) > 0
    assert got[0] == served(dep, PORT, q, **knobs)[0]


# ---------------------------------------------------------------------------
# Parked state, admission control, the tenant breakdown
# ---------------------------------------------------------------------------

def drive_until(server, pred, max_steps=200):
    for _ in range(max_steps):
        server.step()
        if pred():
            return
    raise AssertionError("condition never reached")


def test_abort_parked_frees_swapped_state_exactly(dep):
    server = engine(dep, PORT, n_slots=2, cache_len=32, paged=True,
                    page_block=4, pool_blocks=7, chunked_prefill=True,
                    chunk=8, prefix_cache=True, preemption="swap",
                    sanitize=True)
    rng = np.random.default_rng(7)
    shared = rng.integers(0, dep["vocab"], size=8).astype(np.int32)

    def prompt():
        return np.concatenate(
            [shared, rng.integers(0, dep["vocab"], size=4).astype(np.int32)])

    free0 = server.allocator.n_free
    low = server.add_request(prompt(), SamplingParams(max_new=8, priority=0))
    drive_until(server, lambda: low in
                {r.rid for s, r in enumerate(server.slot_req)
                 if r is not None and not server.prefilling[s]})
    for _ in range(2):
        server.add_request(prompt(), SamplingParams(max_new=4, priority=2))
    drive_until(server, lambda: low in server._parked)
    st = server._parked[low]
    assert st.mode == "swap" and st.payload is not None
    assert all(t.device.type == "cpu" for t in st.payload.values())
    held = server.allocator.n_free
    out = server.abort(low)                  # abort() runs check_pool()
    assert out.finish_reason == "aborted"
    assert low not in server._parked and st.pinned == ()
    assert st.payload is None
    assert server.allocator.n_free >= held   # pins return refs, not blocks
    drive_until(server, lambda: not server.has_unfinished())
    stats = server.stats()
    assert stats["pool_free_blocks"] == \
        stats["pool_blocks"] - 1 - stats["prefix_cached_blocks"]
    assert server.allocator.n_free == free0 - stats["prefix_cached_blocks"]
    assert stats["aborted"] == 1 and stats["parked"] == 0
    server.sanitizer.check_pool()


def _rejections(dep, side):
    mod, sp_cls, Q = side[0], side[2], side[3]
    rng = np.random.default_rng(9)
    eng = engine(dep, side, n_slots=1, cache_len=32,
                 qos=Q(max_waiting=2))
    rids = [eng.add_request(
        rng.integers(0, dep["vocab"], size=6).astype(np.int32),
        sp_cls(max_new=2, tenant="t")) for _ in range(3)]
    depth = len(eng.waiting)
    outs = {}
    while eng.has_unfinished():
        outs.update({o.rid: (o.token_ids, o.finish_reason)
                     for o in eng.step() if o.finished})
    # the predicted-TTFT model: a cold EWMA accepts, a saturated one sheds
    eng2 = engine(dep, side, n_slots=1, cache_len=32, paged=True,
                  page_block=4, chunked_prefill=True, chunk=4,
                  qos=Q(max_predicted_ttft_s=0.05))
    ok = eng2.add_request(
        rng.integers(0, dep["vocab"], size=8).astype(np.int32),
        sp_cls(max_new=2))
    eng2._step_ewma = 10.0
    shed = eng2.add_request(
        rng.integers(0, dep["vocab"], size=8).astype(np.int32),
        sp_cls(max_new=2))
    eng2._step_ewma = 0.0
    outs2 = {}
    while eng2.has_unfinished():
        outs2.update({o.rid: (o.token_ids, o.finish_reason)
                      for o in eng2.step() if o.finished})
    return (depth, rids, outs, eng.stats()["tenants"], ok, shed, outs2,
            eng2.stats()["tenants"])


def test_rejections_match_reference(dep):
    got = _rejections(dep, PORT)
    assert got == _rejections(dep, REF)
    depth, rids, outs, tenants, ok, shed, outs2, _ = got
    assert depth == 2
    assert outs[rids[2]] == ([], "rejected")
    assert outs[rids[0]][1] == outs[rids[1]][1] == "length"
    assert tenants["t"]["rejections"] == 1
    assert outs2[shed] == ([], "rejected") and outs2[ok][1] == "length"


def test_tenant_breakdown_matches_reference(dep):
    def q(side):
        return mixed_queue(side, dep["vocab"], lens=(8, 8, 8, 8),
                           budgets=(6, 6, 6, 6), priorities=(0, 0, 2, 2),
                           tenants=("a", "b", "a", "b"))
    cfg = dict(n_slots=2, cache_len=32, paged=True, page_block=4,
               pool_blocks=7, chunked_prefill=True, chunk=8,
               preemption="recompute")
    got = served(dep, PORT, q, qos=QoSConfig(tenant_weights=(("a", 3.0),)),
                 **cfg)
    want = served(dep, REF, q,
                  qos=jqos.QoSConfig(tenant_weights=(("a", 3.0),)), **cfg)
    assert got == want
    out, _, pre, st = got
    assert set(st["tenants"]) == {"a", "b"}
    assert sum(st["tenants"][t]["preemptions"] for t in "ab") == \
        sum(pre.values()) > 0
    assert st["parked"] == 0


# ---------------------------------------------------------------------------
# The PoolSanitizer under preemption
# ---------------------------------------------------------------------------

@pytest.mark.sanitize
def test_sanitizer_clean_across_preempt_resume_churn(dep):
    def q(side):
        return mixed_queue(side, dep["vocab"], lens=(8,) * 6,
                           budgets=(6, 6, 4, 4, 5, 5),
                           priorities=(0, 0, 2, 2, 1, 0),
                           tenants=("a", "b", "a", "b", "a", "b"))
    server = engine(dep, PORT, n_slots=2, cache_len=32, paged=True,
                    page_block=4, pool_blocks=7, chunked_prefill=True,
                    chunk=8, prefix_cache=True, preemption="recompute",
                    qos=QoSConfig(tenant_weights=(("a", 2.0), ("b", 1.0))),
                    sanitize=True)
    queue = q(PORT)
    out = server.serve(queue)            # the sanitizer raises on drift
    assert len(out) == 6
    assert sum(r.preemptions for r in queue) > 0
    st = server.stats()
    assert st["sanitize_violations"] == 0
    assert st["sanitize_checked_steps"] > 0


@pytest.mark.sanitize
def test_sanitizer_names_a_corrupted_table(dep):
    """One physical block mapped into two slots without a prefix-cache
    refcount: the next step's scan raises naming the block."""
    server = engine(dep, PORT, n_slots=2, cache_len=32, paged=True,
                    page_block=8, sanitize=True)
    rng = np.random.default_rng(1)
    for rid in range(2):
        server.add_request(rng.integers(0, dep["vocab"], 12)
                           .astype(np.int32), SamplingParams(max_new=8),
                           rid=rid)
    server.step()
    server.step()
    assert server.stats()["sanitize_violations"] == 0
    server.block_tables[1, 0] = server.block_tables[0, 0]
    with pytest.raises(PoolSanitizerError, match="mapped writable"):
        server.step()
