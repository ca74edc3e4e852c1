"""The port's telemetry layer (``repro_torch.obs``) against the JAX
reference.

* Registry and recorder units: the reference's metric and trace cases run
  on the port's copies (counters, gauges, histograms and their buckets,
  get-or-create identity, base labels, ``reset()``, the Prometheus text,
  merged snapshots; the no-op recorder, every event shape, the ring's
  bound with its metadata kept, the merge of pods).
* Engine integration, dense family (the float32 ``qwen3_8b`` smoke config,
  weights carried across from the reference's pytrees): a traced server's
  export is schema-valid Chrome/Perfetto JSON with the reference's span
  taxonomy; every request's spans tile its end-to-end latency exactly;
  tracing is observation only (the same tokens, and nothing recorded by
  default); TTFT and queue delay are measured from submission on a
  pool-starved queue; a second ``serve()`` starts its ``aborted`` and
  ``stopped`` at zero; the decentralized export keeps one pid per pod.
* ``export_metrics``: after one queue, top-1 and under the mixture, every
  counter and gauge series of the reference engine — names, labels and
  values — is the port's too, and every histogram's count (its sum too
  where it is not a time); the port adds the pod step's phase histograms
  alone.
* The pod step's phases (``EngineObs.step_begin``): fused, unfused,
  mixture and speculative, the dispatch's halves sum to the dispatch and
  the phases to the step; the chunk half counts the chunks; a collection
  inside a step shows in its histogram; under ``torch.profiler`` a step
  gives the ``repro.serve.*`` ranges, nested as the recorder's spans,
  with the forward's ops inside the halves, and the same tokens; with no
  profiler no range is entered.
"""
import gc
import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_smoke_config as jax_smoke  # noqa: E402
from repro.core.router import CentroidRouter as JaxRouter  # noqa: E402
from repro.core.router import RouterConfig as JaxRouterConfig  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.serve import api as japi  # noqa: E402
from repro.serve import scheduler as jsched  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.router import CentroidRouter, RouterConfig  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.obs import engine as obs_engine  # noqa: E402
from repro_torch.obs.metrics import (MetricsRegistry, log_buckets,  # noqa: E402
                                     prometheus, snapshot)
from repro_torch.obs.trace import (ADMIT_TID, SLOT_TID0, STEP_TID,  # noqa: E402
                                   NullRecorder, TraceRecorder,
                                   merge_chrome, us)
from repro_torch.serve import scheduler as sched  # noqa: E402
from repro_torch.serve.api import EngineConfig, SamplingParams  # noqa: E402
from repro_torch.weights import from_tree  # noqa: E402

ARCH, K, FEAT, CACHE_LEN = "qwen3_8b", 2, 8, 48


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def dep():
    jm = jax_build(jax_smoke(ARCH))
    jexperts = [jm.init(jax.random.PRNGKey(k)) for k in range(K)]
    rng = np.random.default_rng(0)
    return dict(jm=jm, jexperts=jexperts,
                texperts=[from_tree(jax.tree.map(np.asarray, p))
                          for p in jexperts],
                tm=build_model(get_smoke_config(ARCH)), vocab=jm.cfg.vocab,
                cent=rng.normal(size=(K, FEAT)).astype(np.float32))


def prompts_of(vocab, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n).astype(np.int32) for n in lens]


def chunked(**kw):
    return EngineConfig(**dict(dict(
        n_slots=2, cache_len=CACHE_LEN, paged=True, page_block=8,
        chunked_prefill=True, chunk=8), **kw))


def slot_server(dep, **kw):
    return sched.make_engine(dep["tm"], dep["texperts"][0],
                             config=chunked(**kw), device="cpu")


# ---------------------------------------------------------------------------
# Metrics registry units
# ---------------------------------------------------------------------------

def test_counter_gauge_semantics():
    r = MetricsRegistry()
    c = r.counter("c_total", "help")
    c.inc()
    c.inc(2.5)
    assert c.value == 3.5
    with pytest.raises(ValueError):
        c.inc(-1)
    g = r.gauge("g")
    g.set(7)
    g.inc(-2)
    assert g.value == 5.0


def test_histogram_buckets_and_mean():
    r = MetricsRegistry()
    h = r.histogram("h_seconds", bounds=(1.0, 2.0, 4.0))
    for v in (0.5, 1.5, 3.0, 100.0):
        h.observe(v)
    assert h.counts == (1, 1, 1, 1)
    assert h.count == 4 and h.sum == 105.0
    assert h.value == pytest.approx(105.0 / 4)
    with pytest.raises(ValueError):
        r.histogram("h_bad", bounds=(2.0, 1.0))
    assert math.isnan(r.histogram("h_empty").value)


def test_log_buckets_span_and_monotonicity():
    b = log_buckets()
    assert b[0] == pytest.approx(1e-5) and b[-1] >= 10.0
    assert list(b) == sorted(b) and len(set(b)) == len(b)
    with pytest.raises(ValueError):
        log_buckets(lo=0)


def test_registry_get_or_create_and_type_conflict():
    r = MetricsRegistry(base_labels={"pod": "3"})
    c1 = r.counter("x_total", "first help")
    assert r.counter("x_total") is c1 and c1.label_dict == {"pod": "3"}
    c3 = r.counter("x_total", labels={"reason": "stop"})
    assert c3 is not c1
    assert c3.label_dict == {"pod": "3", "reason": "stop"}
    with pytest.raises(ValueError):
        r.gauge("x_total")
    assert r.get("x_total") is c1
    assert r.get("x_total", {"reason": "stop"}) is c3
    assert r.get("nope") is None


def test_registry_reset_keeps_handles_valid():
    r = MetricsRegistry()
    c = r.counter("c_total")
    h = r.histogram("h_seconds")
    c.inc(5)
    h.observe(1.0)
    r.reset()
    assert c.value == 0.0 and h.count == 0
    c.inc()
    assert r.get("c_total").value == 1.0


def test_prometheus_exposition_format():
    r = MetricsRegistry(base_labels={"pod": "0"})
    r.counter("req_total", "requests").inc(3)
    h = r.histogram("lat_seconds", "latency", bounds=(0.1, 1.0))
    for v in (0.05, 0.5, 5.0):
        h.observe(v)
    lines = r.to_prometheus().splitlines()
    assert "# TYPE req_total counter" in lines
    assert 'req_total{pod="0"} 3.0' in lines
    assert 'lat_seconds_bucket{pod="0",le="0.1"} 1' in lines
    assert 'lat_seconds_bucket{pod="0",le="1.0"} 2' in lines
    assert 'lat_seconds_bucket{pod="0",le="+Inf"} 3' in lines
    assert 'lat_seconds_count{pod="0"} 3' in lines
    r2 = MetricsRegistry(base_labels={"pod": "1"})
    r2.counter("req_total", "requests").inc(1)
    merged = prometheus([r, r2])
    assert merged.count("# TYPE req_total counter") == 1
    assert 'req_total{pod="1"} 1.0' in merged


def test_snapshot_merges_registries():
    r0 = MetricsRegistry(base_labels={"pod": "0"})
    r1 = MetricsRegistry(base_labels={"pod": "1"})
    r0.counter("c_total").inc()
    r1.counter("c_total").inc(2)
    vals = {m["labels"]["pod"]: m["value"]
            for m in snapshot([r0, r1])["metrics"]}
    assert vals == {"0": 1.0, "1": 2.0}


# ---------------------------------------------------------------------------
# Trace recorder units
# ---------------------------------------------------------------------------

def test_null_recorder_is_inert():
    tr = NullRecorder(pid=0)
    assert tr.enabled is False
    tr.complete("x", 0.0, 1.0, 0)
    tr.instant("i", 0.5, 0)
    assert tr.events() == [] and tr.to_chrome()["traceEvents"] == []


def test_recorder_event_shapes():
    tr = TraceRecorder(capacity=64, pid=5)
    tr.set_process_name("pod 5")
    tr.set_thread_name(STEP_TID, "engine steps")
    tr.complete("span", 1.0, 1.25, SLOT_TID0, args={"rid": 7})
    tr.async_begin("queued", 1.0, 7)
    tr.async_end("queued", 2.0, 7)
    tr.instant("retire", 2.0, SLOT_TID0)
    tr.counter("engine", 2.0, {"active": 1})
    by_ph = {e["ph"]: e for e in tr.events()}
    x = by_ph["X"]
    assert x["ts"] == us(1.0) and x["dur"] == us(1.25) - us(1.0)
    assert x["pid"] == 5 and x["tid"] == SLOT_TID0
    assert x["args"]["rid"] == 7
    assert by_ph["b"]["id"] == 7 and by_ph["e"]["id"] == 7
    assert by_ph["b"]["tid"] == ADMIT_TID
    assert by_ph["i"]["name"] == "retire"
    assert by_ph["C"]["args"] == {"active": 1}
    tr.complete("clamped", 3.0, 2.0, 0)
    assert [e for e in tr.events()
            if e["name"] == "clamped"][0]["dur"] == 0


def test_ring_bounds_and_metadata_survive_wrap():
    tr = TraceRecorder(capacity=8, pid=0)
    tr.set_process_name("pod 0")
    tr.set_thread_name(0, "steps")
    for i in range(100):
        tr.instant(f"e{i}", float(i), 0)
    evs = tr.events()
    others = [e for e in evs if e["ph"] != "M"]
    assert len([e for e in evs if e["ph"] == "M"]) == 2
    assert len(others) == 8
    assert others[0]["name"] == "e92" and others[-1]["name"] == "e99"
    assert tr.dropped == 92
    with pytest.raises(ValueError):
        TraceRecorder(capacity=0)


def test_merge_chrome_concatenates_pods():
    a, b = TraceRecorder(capacity=8, pid=0), TraceRecorder(capacity=8, pid=1)
    a.instant("x", 1.0, 0)
    b.instant("y", 2.0, 0)
    assert {e["pid"] for e in merge_chrome([a, b])["traceEvents"]} == {0, 1}


# ---------------------------------------------------------------------------
# Engine integration
# ---------------------------------------------------------------------------

REQ_KEYS = {"X": {"name", "ph", "ts", "dur", "pid", "tid"},
            "b": {"name", "ph", "ts", "pid", "tid", "id"},
            "e": {"name", "ph", "ts", "pid", "tid", "id"},
            "i": {"name", "ph", "ts", "pid", "tid"},
            "C": {"name", "ph", "ts", "pid", "args"},
            "M": {"name", "ph", "pid", "args"}}


def validate_chrome(doc, n_slots, pids):
    """Schema-validate a Chrome/Perfetto trace_event document (the
    reference test's check)."""
    assert set(doc) >= {"traceEvents", "displayTimeUnit"}
    evs = doc["traceEvents"]
    for e in evs:
        assert e["ph"] in REQ_KEYS, e
        assert not REQ_KEYS[e["ph"]] - set(e), e
        if e["ph"] in ("X", "b", "e", "i"):
            assert isinstance(e["ts"], int) and e["ts"] >= 0, e
        if e["ph"] == "X":
            assert isinstance(e["dur"], int) and e["dur"] >= 0, e
    tracks = {}
    for e in evs:
        if e["ph"] == "X":
            tracks.setdefault((e["pid"], e["tid"]), []).append(e)
    for track, spans in tracks.items():
        spans.sort(key=lambda e: (e["ts"], -e["dur"]))
        stack = []
        for e in spans:
            while stack and e["ts"] >= stack[-1]:
                stack.pop()
            if stack:
                assert e["ts"] + e["dur"] <= stack[-1], (track, e)
            stack.append(e["ts"] + e["dur"])
    for pid in pids:
        pmeta = [e for e in evs if e["ph"] == "M" and e["pid"] == pid]
        assert "process_name" in {e["name"] for e in pmeta}, pid
        tids = {e["tid"] for e in pmeta if e["name"] == "thread_name"}
        assert tids >= {STEP_TID, ADMIT_TID} | \
            {SLOT_TID0 + s for s in range(n_slots)}, (pid, tids)
    return evs


def serve_traced(dep, prompts, max_new=6, **kw):
    srv = slot_server(dep, trace=True, prefix_cache=True, **kw)
    reqs = [sched.Request(i, p, max_new) for i, p in enumerate(prompts)]
    return srv, reqs, srv.serve(reqs)


def test_trace_schema_and_span_taxonomy(dep):
    srv, reqs, _ = serve_traced(dep, prompts_of(dep["vocab"], (12, 9, 14, 7)))
    doc = json.loads(json.dumps(srv.export_trace()))
    evs = validate_chrome(doc, n_slots=2, pids=[0])
    names = {e["name"] for e in evs if e["ph"] == "X"}
    assert {"admission", "prefix_match", "prefill", "decode", "dispatch",
            "device_get"} <= names
    assert set(obs_engine.PHASES) | {"pod_step"} <= names
    assert any(n.startswith("prefill_chunk[") for n in names)
    assert {n for n in names if n.startswith("step:")} >= \
        {"step:chunk", "step:decode+chunk", "step:decode"}
    retires = [e for e in evs if e["ph"] == "i" and e["name"] == "retire"]
    assert len(retires) == len(reqs)
    assert all(e["args"]["finish_reason"] == "length" for e in retires)
    for kind in ("b", "e"):
        assert {e["id"] for e in evs
                if e["ph"] == kind and e["name"] == "queued"} \
            == {r.rid for r in reqs}


def test_spans_tile_end_to_end_latency_exactly(dep):
    srv, reqs, _ = serve_traced(dep, prompts_of(dep["vocab"], (12, 9, 15)))
    evs = srv.export_trace()["traceEvents"]
    for req in reqs:
        rid = req.rid
        phase = [e for e in evs if e["ph"] == "X"
                 and e["name"] in ("admission", "prefill", "decode")
                 and e["args"].get("rid") == rid]
        q_b = next(e for e in evs if e["ph"] == "b" and e["id"] == rid)
        q_e = next(e for e in evs if e["ph"] == "e" and e["id"] == rid)
        total = (q_e["ts"] - q_b["ts"]) + sum(e["dur"] for e in phase)
        assert total == us(req.t_done) - us(req.t_submit), rid
        phase.sort(key=lambda e: e["ts"])
        assert phase[0]["ts"] == q_e["ts"]
        for a, b in zip(phase, phase[1:]):
            assert a["ts"] + a["dur"] == b["ts"], (rid, a, b)


def test_tracing_is_observation_only(dep):
    ps = prompts_of(dep["vocab"], (12, 9, 14, 7))
    srv_off = slot_server(dep, prefix_cache=True)
    out_off = srv_off.serve([sched.Request(i, p, 6)
                             for i, p in enumerate(ps)])
    _, _, out_on = serve_traced(dep, ps)
    assert out_on == out_off
    assert srv_off.obs.trace.enabled is False
    assert srv_off.export_trace()["traceEvents"] == []
    assert srv_off.obs.steps.value > 0
    assert srv_off.obs.e2e_s.count == len(ps)
    # every step's split was recorded, dispatch and readback alike
    assert srv_off.obs.dispatch_s.count == srv_off.obs.readback_s.count > 0


def test_ttft_measured_from_submission_under_pool_starvation(dep):
    ps = prompts_of(dep["vocab"], (16,) * 6)
    srv = slot_server(dep, pool_blocks=7)
    outs = {}
    for i, p in enumerate(ps):
        srv.add_request(p, SamplingParams(max_new=6), rid=i)
    while srv.has_unfinished():
        outs.update({o.rid: o for o in srv.step() if o.finished})
    assert len(outs) == len(ps)
    for o in outs.values():
        assert o.t_admit >= o.t_submit > 0
        assert o.queued_s >= 0 and not math.isnan(o.queued_s)
        assert o.ttft_s >= o.queued_s and o.ttft == o.ttft_s
    order = sorted(outs.values(), key=lambda o: o.t_admit)
    assert order[-1].queued_s > order[0].queued_s
    assert order[-1].queued_s > 1e-4
    for h in (srv.obs.queued_s, srv.obs.ttft_s, srv.obs.e2e_s):
        assert h.count == len(ps)


def test_repeated_serve_does_not_accumulate_stats(dep):
    ps = prompts_of(dep["vocab"], (10, 10))
    srv = slot_server(dep)
    first = srv.serve([sched.Request(0, ps[0], 8)])[0][0]
    srv.add_request(ps[0], SamplingParams(max_new=8,
                                          stop_token_ids=(first,)), rid=10)
    srv.add_request(ps[1], SamplingParams(max_new=8), rid=11)
    srv.abort(11)
    while srv.has_unfinished():
        srv.step()
    st = srv.stats()
    assert st["stopped"] == 1 and st["aborted"] == 1
    assert len(srv.serve([sched.Request(20, ps[1], 4)])) == 1
    st2 = srv.stats()
    assert st2["stopped"] == 0 and st2["aborted"] == 0
    assert srv.obs.admitted.value >= 3
    srv.metrics.reset()
    assert srv.obs.admitted.value == 0


def test_serve_raises_on_exhausted_steps(dep):
    srv = slot_server(dep)
    ps = prompts_of(dep["vocab"], (10, 10, 10))
    with pytest.raises(RuntimeError, match="exhausted max_steps=2"):
        srv.serve([sched.Request(i, p, 6) for i, p in enumerate(ps)],
                  max_steps=2)
    with pytest.raises(RuntimeError, match=r"\(prefill 8/10\)|queued"):
        slot_server(dep).serve([sched.Request(0, ps[0], 6)], max_steps=1)


def decentralized(dep, strategy="top1", **kw):
    return sched.make_engine(
        dep["tm"], experts=dep["texperts"],
        router=CentroidRouter(torch.as_tensor(dep["cent"]),
                              RouterConfig(top_k=K if strategy == "mixture"
                                           else 1)),
        config=chunked(strategy=strategy, **kw), device="cpu")


def test_decentralized_trace_keeps_one_pid_per_pod(dep):
    srv = decentralized(dep, trace=True)
    ps = prompts_of(dep["vocab"], (10, 9, 11, 8))
    feats = np.random.default_rng(0).normal(size=(len(ps), FEAT)) \
        .astype(np.float32)
    out = srv.serve([sched.Request(i, p, 4, features=feats[i])
                     for i, p in enumerate(ps)])
    assert len(out) == len(ps)
    doc = srv.export_trace()
    assert {e["pid"] for e in doc["traceEvents"]} == {0, 1}
    validate_chrome(doc, n_slots=2, pids=[0, 1])
    assert {m["labels"].get("pod")
            for m in srv.export_metrics()["metrics"]} == {"0", "1"}
    text = srv.prometheus_metrics()
    assert 'pod="0"' in text and 'pod="1"' in text
    srv.reset_stats()
    assert all(p.stats()["stopped"] == 0 for p in srv.pods)


def _series(doc):
    """{(name, labels): comparable value}: counters and gauges by value,
    histograms by count (and by sum where it is not a time)."""
    out = {}
    for m in doc["metrics"]:
        key = (m["name"], tuple(sorted(m["labels"].items())))
        if m["type"] == "histogram":
            out[key] = (m["count"], None if m["name"].endswith("_seconds")
                        else m["sum"])
        else:
            out[key] = m["value"]
    return out


@pytest.mark.parametrize("strategy", ["top1", "mixture"])
def test_export_metrics_counters_equal_reference(dep, strategy):
    """One queue (a shared prefix, a stop id, n-gram speculation) through
    the port's and the reference's deployments: every series equal."""
    rng = np.random.default_rng(4)
    shared = rng.integers(0, dep["vocab"], 17).astype(np.int32)
    ps = [np.concatenate([shared, rng.integers(0, dep["vocab"], n)
                          .astype(np.int32)]) for n in (3, 7, 5, 9)]
    feats = rng.normal(size=(len(ps), FEAT)).astype(np.float32)
    feats[:3] = dep["cent"][0]       # three on pod 0: the third one hits
    kw = dict(prefix_cache=True, speculative="ngram", spec_len=3)
    port = decentralized(dep, strategy, **kw)
    ref = jsched.make_engine(
        dep["jm"], experts=dep["jexperts"],
        router=JaxRouter(jnp.asarray(dep["cent"]), JaxRouterConfig(
            top_k=K if strategy == "mixture" else 1)),
        config=japi.EngineConfig(**dict(
            n_slots=2, cache_len=CACHE_LEN, paged=True, page_block=8,
            chunked_prefill=True, chunk=8, strategy=strategy, **kw)))
    outs = []
    for eng, sp, mod in ((port, SamplingParams, sched),
                         (ref, japi.SamplingParams, jsched)):
        outs.append(eng.serve([mod.Request(
            i, p, 6, features=feats[i], params=sp(
                max_new=6, stop_token_ids=(7,) if i == 1 else ()))
            for i, p in enumerate(ps)]))
    assert outs[0] == outs[1]
    got, want = _series(port.export_metrics()), \
        _series(ref.export_metrics())
    assert {k: v for k, v in got.items() if k in want} == want
    # the extra series: the seven phase histograms, each under exactly
    # the labels of the reference's dispatch histogram (one per pod)
    pods = {lab for name, lab in want
            if name == "serve_step_dispatch_seconds"}
    assert pods
    assert set(got) - set(want) == {(name, lab) for name in PHASE_SERIES
                                    for lab in pods}
    assert sum(v for (name, _), v in got.items()
               if name == "serve_prefix_skipped_tokens_total") > 0
    assert sum(v for (name, _), v in got.items()
               if name == "serve_spec_steps_total") > 0


# ---------------------------------------------------------------------------
# The pod step's phases
# ---------------------------------------------------------------------------

PHASE_SERIES = {"serve_step_admit_seconds", "serve_step_prepare_seconds",
                "serve_step_decode_dispatch_seconds",
                "serve_step_chunk_dispatch_seconds",
                "serve_step_finish_seconds", "serve_step_gc_seconds",
                "serve_step_seconds"}
FORWARD_OPS = ("aten::mm", "aten::addmm", "aten::matmul", "aten::linear",
               "aten::bmm", "aten::einsum")
def _phase_pods(dep, kind):
    if kind == "mixture":
        return decentralized(dep, "mixture").pods
    over = {"fused": {}, "unfused": dict(fused_step=False),
            "speculative": dict(speculative="ngram", spec_len=3)}[kind]
    return [slot_server(dep, **over)]


def _serve_pods(dep, pods, lens=(12, 9, 14, 7, 11), max_new=6):
    """Serve a queue on each pod (or engine); repetitive prompts so that
    n-gram drafts are accepted."""
    rng = np.random.default_rng(3)
    feats = rng.normal(size=(len(lens), FEAT)).astype(np.float32)
    ps = [np.tile(p[:4], 4)[:n] for p, n in
          zip(prompts_of(dep["vocab"], lens), lens)]
    for pod in pods:
        pod.serve([sched.Request(i, p, max_new, features=feats[i])
                   for i, p in enumerate(ps)])


@pytest.mark.parametrize("kind", ["fused", "unfused", "mixture",
                                  "speculative"])
def test_step_phases_tile_the_pod_step(dep, kind):
    """The dispatch's decode and chunk halves sum to the dispatch, and
    admit + prepare + dispatch + device_get + finish to the step, over
    every step; the chunk half is observed once per chunk consumed."""
    pods = _phase_pods(dep, kind)
    chunks0 = [p.n_chunks for p in pods]
    _serve_pods(dep, pods)
    for pod, c0 in zip(pods, chunks0):
        o = pod.obs
        ph = o.phase_s
        steps = int(o.steps.value)
        assert steps > 0
        assert o.step_s.count == o.gc_s.count == ph["admit"].count == \
            ph["finish"].count == steps
        assert o.dispatch_s.count == o.readback_s.count > 0
        assert ph["decode_dispatch"].count > 0 and \
            ph["chunk_dispatch"].count > 0
        assert ph["decode_dispatch"].sum + ph["chunk_dispatch"].sum == \
            pytest.approx(o.dispatch_s.sum, rel=1e-12, abs=1e-12)
        five = ph["admit"].sum + ph["prepare"].sum + o.dispatch_s.sum + \
            o.readback_s.sum + ph["finish"].sum
        assert five == pytest.approx(o.step_s.sum, rel=1e-12, abs=1e-12)
        assert ph["chunk_dispatch"].count == pod.n_chunks - c0
        if kind == "speculative":
            assert o.n_spec_steps > 0


def test_a_collection_inside_a_step_shows_in_its_histogram(dep):
    srv = slot_server(dep)
    srv.add_request(prompts_of(dep["vocab"], (10,))[0],
                    SamplingParams(max_new=4), rid=0)
    finish = srv._obs_step

    def collecting():
        gc.collect()
        finish()
    was = gc.isenabled()
    gc.disable()
    try:
        srv.step()
        quiet = srv.obs.gc_s.sum
        srv._obs_step = collecting
        srv.step()
    finally:
        if was:
            gc.enable()
    assert quiet == 0.0
    assert srv.obs.gc_s.count == 2 and srv.obs.gc_s.sum > 0.0
    assert srv.obs.gc_s.sum <= srv.obs.step_s.sum


def _profiled_steps(srv, n_steps):
    """Run ``n_steps`` steps under a CPU profiler; the ``repro.serve.*``
    and forward ranges of the host thread, as (start, end, name)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(n_steps):
            srv.step()
    return sorted((e.time_range.start, e.time_range.end, e.name)
                  for e in prof.events()
                  if e.name.startswith(obs_engine.SERVE_RANGE)
                  or e.name in FORWARD_OPS)


def _inside(a, b):
    return a[0] <= b[0] and b[1] <= a[1]


def test_profiler_ranges_nest_as_the_recorded_spans(dep):
    """One decode + chunk step under ``torch.profiler``: its ranges are
    the recorder's step-track spans (but ``step:<kind>``), each pair
    nested alike, and every matrix product of the forward lies inside
    the decode or the chunk half."""
    srv = slot_server(dep, trace=True)
    for i, p in enumerate(prompts_of(dep["vocab"], (7, 20))):
        srv.add_request(p, SamplingParams(max_new=8), rid=i)
    srv.step()                       # the first prompt's only chunk
    n_spans = len(srv.export_trace()["traceEvents"])
    evs = _profiled_steps(srv, 1)    # decode + the second prompt's chunk
    ranges = {n[len(obs_engine.SERVE_RANGE):]: (a, b)
              for a, b, n in evs if n.startswith(obs_engine.SERVE_RANGE)}
    assert set(ranges) == {"pod_step", "dispatch", *obs_engine.PHASES}
    spans = {e["name"]: (e["ts"], e["ts"] + e["dur"])
             for e in srv.export_trace()["traceEvents"][n_spans:]
             if e["ph"] == "X" and e["tid"] == STEP_TID}
    assert set(spans) == set(ranges) | {"step:decode+chunk"}
    for x in ranges:
        for y in ranges:
            if x != y:
                assert _inside(ranges[x], ranges[y]) == \
                    _inside(spans[x], spans[y]), (x, y)
    order = [ranges[p] for p in obs_engine.PHASES]
    assert all(a[1] <= b[0] for a, b in zip(order, order[1:]))
    ops = [e for e in evs if e[2] in FORWARD_OPS]
    assert ops and all(_inside(ranges["decode_dispatch"], op)
                       or _inside(ranges["chunk_dispatch"], op)
                       for op in ops)
    assert any(_inside(ranges["decode_dispatch"], op) for op in ops)
    assert any(_inside(ranges["chunk_dispatch"], op) for op in ops)


def test_engine_step_range_covers_every_pod(dep):
    srv = decentralized(dep)
    feats = np.stack([dep["cent"][0], dep["cent"][1]])
    for i, p in enumerate(prompts_of(dep["vocab"], (9, 9))):
        srv.add_request(p, SamplingParams(max_new=4), features=feats[i],
                        rid=i)
    evs = _profiled_steps(srv, 1)
    engine = [e for e in evs if e[2] == "repro.serve.engine_step"]
    pods = [e for e in evs if e[2] == "repro.serve.pod_step"]
    assert len(engine) == 1 and len(pods) == 2
    assert all(_inside(engine[0], p) for p in pods)


class _CountingRange(torch.autograd.profiler.record_function):
    entered = 0

    def __enter__(self):
        type(self).entered += 1
        return super().__enter__()


def test_no_range_is_entered_without_a_profiler(dep, monkeypatch):
    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        _CountingRange)
    _CountingRange.entered = 0
    _serve_pods(dep, [decentralized(dep)] + _phase_pods(dep, "unfused"))
    with obs_engine.host_range("repro.train.forward"):
        pass
    assert _CountingRange.entered == 0
    srv = slot_server(dep)
    srv.add_request(prompts_of(dep["vocab"], (9,))[0],
                    SamplingParams(max_new=4), rid=0)
    _profiled_steps(srv, 1)
    assert _CountingRange.entered > 0    # the ranges go through it


def test_tokens_are_the_same_under_the_profiler(dep):
    ps = prompts_of(dep["vocab"], (12, 9, 14, 7))

    def serve():
        return slot_server(dep, prefix_cache=True).serve(
            [sched.Request(i, p, 6) for i, p in enumerate(ps)])
    off = serve()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        on = serve()
    assert on == off


def test_a_step_that_raises_closes_its_ranges(dep, monkeypatch):
    """Under a profiler, a pod step that raises inside its dispatch
    closes the ranges it opened and observes neither the phase it broke
    off nor the step; the next step runs whole."""
    srv = slot_server(dep)
    srv.add_request(prompts_of(dep["vocab"], (9,))[0],
                    SamplingParams(max_new=4), rid=0)
    run = srv._run_chunk_only

    def boom(*a):
        raise RuntimeError("dispatch failed")
    monkeypatch.setattr(srv, "_run_chunk_only", boom)
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        with pytest.raises(RuntimeError, match="dispatch failed"):
            srv.step()
        assert srv.obs._ranges == [] and srv.obs.phase_name == ""
        monkeypatch.setattr(srv, "_run_chunk_only", run)
        srv.step()
    o = srv.obs
    assert o.step_s.count == o.dispatch_s.count == 1
    assert o.phase_s["admit"].count == o.phase_s["prepare"].count == 2
    assert o.phase_s["chunk_dispatch"].count == 1
    names = [e.name for e in prof.events()]
    assert names.count("repro.serve.pod_step") == 2
    assert names.count("repro.serve.chunk_dispatch") == 2
