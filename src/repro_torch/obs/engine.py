"""Per-engine telemetry bundle: registry handles + trace recorder.

One :class:`EngineObs` per ``_SlotTable`` (per pod on the decentralized
server). It owns the engine's private :class:`MetricsRegistry` (labelled
``pod=<k>``), caches every hot-path instrument handle at construction so
the step loop does dict-free attribute loads, and holds either a real
:class:`TraceRecorder` or the :class:`NullRecorder` off-switch.

The metrics side is **always on** — plain-Python counter bumps and a few
``perf_counter`` stamps per engine step, orders of magnitude below the
device dispatch they time (``chip_smoke.py`` prints the split they
measure on the card). The trace side is off by default:
every span site checks ``obs.trace.enabled`` (or uses the no-op emit)
before doing any per-event work.

The pod step's phases (``step_begin``, ``phase``, ``step_timing``,
``step_end``; ``abort_step`` where the step raised) tile the step at shared stamps: ``admit``, ``prepare``,
the dispatch's ``decode_dispatch`` and ``chunk_dispatch`` halves,
``device_get`` and ``finish``. Each boundary takes one stamp, observes
the phase that ends in its always-on histogram, emits its span when
tracing, and, only while a ``torch.profiler`` records, closes and opens
``repro.serve.<phase>`` ranges, so the phases sit on the profiler's own
clock beside the kernels they launch. With no profiler the ranges cost
one ``_profiler_enabled()`` check a boundary. ``host_range`` gives other
code (the trainer) the same gated range. torch is imported on the first
such check, so importing the package imports no torch. A ``gc.callbacks``
hook, installed once per process, adds up the seconds spent in Python's
collector; a step observes what it added while the step ran.

Metric catalog lives in docs/observability.md (the reference's names)
and docs/observability_torch.md (the pod step's phases and ranges);
names are stable surface.
"""
from __future__ import annotations

import contextlib
import gc
import time
from typing import Dict, List, Tuple

from repro_torch.obs import metrics as _m
from repro_torch.obs.trace import (ADMIT_TID, SLOT_TID0, STEP_TID, NullRecorder,
                             TraceRecorder)

__all__ = ["EngineObs", "host_range", "profiling", "PHASES",
           "SERVE_RANGE"]

# Accept-length histogram: speculative spans commit 1..spec_len tokens
# per verify step; unit-width buckets make the histogram an exact
# distribution over commit lengths for any spec_len <= 16.
ACCEPT_LEN_BUCKETS = tuple(float(i) for i in range(1, 17))
# Per-request accept-rate in [0, 1], tenth-width buckets.
RATE_BUCKETS = tuple(round(0.1 * i, 1) for i in range(0, 11))

# The pod step's phases, in order; every step runs ``admit`` and
# ``finish``. The two halves nest in the dispatch.
PHASES = ("admit", "prepare", "decode_dispatch", "chunk_dispatch",
          "device_get", "finish")
_HALVES = frozenset(("decode_dispatch", "chunk_dispatch"))
_PHASE_HELP = {
    "admit": "host time admitting from the waiting queue",
    "prepare": "host time from admission to the dispatch",
    "decode_dispatch": "host time queueing the dispatch's decode half",
    "chunk_dispatch": "host time queueing the dispatch's prefill chunk "
                      "half",
    "finish": "host time from the readback to the step's return",
}
SERVE_RANGE = "repro.serve."    # profiler range prefix of the pod step

# -- profiler ranges --------------------------------------------------------
_profiler_enabled = None        # torch's check, bound on the first call
_NO_RANGE = contextlib.nullcontext()


def profiling() -> bool:
    """Whether a torch profiler records now: one C call. torch is
    imported on the first call."""
    global _profiler_enabled
    if _profiler_enabled is None:
        from torch._C._autograd import _profiler_enabled
    return _profiler_enabled()


def host_range(name: str):
    """``with host_range(name):`` — a ``record_function`` range while a
    profiler records, else a shared no-op context."""
    if not profiling():
        return _NO_RANGE
    from torch.autograd.profiler import record_function
    return record_function(name)


# -- seconds in Python's collector ------------------------------------------
_gc_clock = [0.0, 0.0]          # [seconds collected so far, pause start]


def _on_gc(phase: str, info: dict) -> None:
    if phase == "start":
        _gc_clock[1] = time.perf_counter()
    else:
        _gc_clock[0] += time.perf_counter() - _gc_clock[1]


def _install_gc_hook() -> None:
    if _on_gc not in gc.callbacks:
        gc.callbacks.append(_on_gc)


class EngineObs:
    """Telemetry handles for one engine/pod.

    Parameters
    ----------
    pod: pod index — becomes the trace ``pid`` and the registry's
        ``pod`` label.
    trace: attach a real ring-buffer recorder (else the no-op recorder).
    trace_ring: ring capacity when tracing.
    publish: attach this registry to the process-global exposition set
        (``EngineConfig(metrics=True)``).
    """

    def __init__(self, *, pod: int = 0, trace: bool = False,
                 trace_ring: int = 65536, publish: bool = False) -> None:
        self.pod = pod
        self.registry = _m.MetricsRegistry(base_labels={"pod": str(pod)})
        self.trace: NullRecorder = (
            TraceRecorder(capacity=trace_ring, pid=pod) if trace
            else NullRecorder(pid=pod))
        if publish:
            _m.attach(self.registry)
        r = self.registry
        # -- request lifecycle (counters) --------------------------------
        self.submitted = r.counter(
            "serve_requests_submitted_total",
            "requests handed to add_request")
        self.admitted = r.counter(
            "serve_admissions_total",
            "requests that won a slot (or retired at admission)")
        self.aborted = r.counter(
            "serve_aborts_total", "requests cancelled via abort()")
        self._retired: Dict[str, _m.Counter] = {}
        # -- step loop ----------------------------------------------------
        self.steps = r.counter("serve_engine_steps_total",
                               "engine step() iterations")
        self.dispatch_s = r.histogram(
            "serve_step_dispatch_seconds",
            "host time to build + launch the fused step dispatch")
        self.readback_s = r.histogram(
            "serve_step_device_get_seconds",
            "host time blocked in the one per-step readback")
        # -- the pod step's phases (step_begin ... step_end) ---------------
        self.phase_s: Dict[str, _m.Histogram] = {
            p: r.histogram(f"serve_step_{p}_seconds", h)
            for p, h in _PHASE_HELP.items()}
        self.phase_s["device_get"] = self.readback_s
        self.step_s = r.histogram("serve_step_seconds",
                                  "pod step wall time, entry to return")
        self.gc_s = r.histogram(
            "serve_step_gc_seconds",
            "seconds of the pod step spent in Python's garbage collector")
        self.phase_name = ""       # the phase running now
        self.t_phase = 0.0         # its start
        self._t_step = self._t_dispatch = self._gc_step = 0.0
        self._ranges: List[Tuple[str, object]] = []  # open, innermost last
        _install_gc_hook()
        self.active_g = r.gauge("serve_active_slots",
                                "slots holding a live request")
        self.waiting_g = r.gauge("serve_waiting_requests",
                                 "requests queued for admission")
        self.pool_free_g = r.gauge("serve_pool_free_blocks",
                                   "free physical KV blocks in the pool")
        self.pool_total_g = r.gauge("serve_pool_blocks",
                                    "physical KV blocks in the pool")
        # -- request latency (histograms) --------------------------------
        self.queued_s = r.histogram(
            "serve_request_queued_seconds",
            "submission to admission (queue delay)")
        self.ttft_s = r.histogram(
            "serve_request_ttft_seconds",
            "submission to first emitted token")
        self.e2e_s = r.histogram(
            "serve_request_e2e_seconds", "submission to retirement")
        # -- speculative decoding ----------------------------------------
        self.spec_steps = r.counter(
            "serve_spec_steps_total", "speculative verify dispatches")
        self.spec_tokens = r.counter(
            "serve_spec_tokens_total",
            "tokens committed by speculative verify steps")
        self.accept_len = r.histogram(
            "serve_spec_accept_length",
            "tokens committed per verify step (1 = all drafts rejected)",
            bounds=ACCEPT_LEN_BUCKETS)
        self.req_accept_rate = r.histogram(
            "serve_spec_request_accept_rate",
            "per-request draft acceptance rate at retirement",
            bounds=RATE_BUCKETS)
        self._drafts: Dict[str, Dict[str, _m.Counter]] = {}
        # -- multi-tenant QoS (lazily-resolved tenant-labelled counters) --
        self._tenant_tokens: Dict[str, _m.Counter] = {}
        self._preempted: Dict[str, _m.Counter] = {}
        self._resumed: Dict[str, _m.Counter] = {}
        self._rejected: Dict[str, _m.Counter] = {}

    # -- labelled lazily-resolved counters --------------------------------
    def retired(self, reason: str) -> _m.Counter:
        """`serve_retirements_total{reason=...}` — one per finish reason."""
        c = self._retired.get(reason)
        if c is None:
            c = self.registry.counter(
                "serve_retirements_total",
                "requests retired from a slot, by finish_reason",
                labels={"reason": reason})
            self._retired[reason] = c
        return c

    def drafts(self, source: str, kind: str) -> _m.Counter:
        """`serve_spec_drafts_{proposed,accepted}_total{source=...}`."""
        by_kind = self._drafts.setdefault(source, {})
        c = by_kind.get(kind)
        if c is None:
            c = self.registry.counter(
                f"serve_spec_drafts_{kind}_total",
                f"draft tokens {kind}, by draft source",
                labels={"source": source})
            by_kind[kind] = c
        return c

    def tenant_tokens(self, tenant: str) -> _m.Counter:
        """`serve_tenant_tokens_total{tenant=...}` — tokens emitted for
        the tenant's retired requests (live requests are added by
        ``stats()`` on top of this cumulative base)."""
        c = self._tenant_tokens.get(tenant)
        if c is None:
            c = self.registry.counter(
                "serve_tenant_tokens_total",
                "tokens emitted, by tenant (counted at retirement)",
                labels={"tenant": tenant})
            self._tenant_tokens[tenant] = c
        return c

    def preempted(self, tenant: str, mode: str) -> _m.Counter:
        """`serve_preemptions_total{tenant=,mode=}` — requests parked
        (swap/recompute) or bounced back mid-prefill (requeue)."""
        key = f"{tenant}\x00{mode}"
        c = self._preempted.get(key)
        if c is None:
            c = self.registry.counter(
                "serve_preemptions_total",
                "decoding/prefilling requests preempted, by tenant + mode",
                labels={"tenant": tenant, "mode": mode})
            self._preempted[key] = c
        return c

    def resumed(self, tenant: str) -> _m.Counter:
        """`serve_resumes_total{tenant=...}` — preempted requests
        re-admitted into a slot."""
        c = self._resumed.get(tenant)
        if c is None:
            c = self.registry.counter(
                "serve_resumes_total",
                "preempted requests re-admitted, by tenant",
                labels={"tenant": tenant})
            self._resumed[tenant] = c
        return c

    def rejected(self, tenant: str) -> _m.Counter:
        """`serve_rejections_total{tenant=...}` — submissions refused by
        admission control (finish_reason="rejected")."""
        c = self._rejected.get(tenant)
        if c is None:
            c = self.registry.counter(
                "serve_rejections_total",
                "submissions refused by admission control, by tenant",
                labels={"tenant": tenant})
            self._rejected[tenant] = c
        return c

    # -- aggregate views used by stats() ----------------------------------
    @property
    def n_aborted(self) -> int:
        return int(self.aborted.value)

    @property
    def n_stopped(self) -> int:
        c = self._retired.get("stop")
        return int(c.value) if c is not None else 0

    @property
    def n_spec_steps(self) -> int:
        return int(self.spec_steps.value)

    @property
    def n_spec_tokens(self) -> int:
        return int(self.spec_tokens.value)

    def reset_run_counters(self) -> None:
        """Per-run hygiene: zero the request-lifecycle counters.

        Called at the top of ``serve()`` so back-to-back drain loops on
        one engine report that run's ``aborted``/``stopped`` alone.
        Cumulative series (spec totals, prefix cache, latency
        histograms) are left to the full ``registry.reset()``.
        """
        self.aborted.reset()
        for c in self._retired.values():
            c.reset()

    # -- trace conveniences ------------------------------------------------
    def name_tracks(self, n_slots: int, label: str) -> None:
        """Emit the "M" metadata naming this pod + its fixed tracks."""
        tr = self.trace
        if not tr.enabled:
            return
        tr.set_process_name(label)
        tr.set_thread_name(STEP_TID, "engine steps")
        tr.set_thread_name(ADMIT_TID, "queue / admission-retired")
        for s in range(n_slots):
            tr.set_thread_name(SLOT_TID0 + s, f"slot {s}")

    @staticmethod
    def slot_tid(slot: int) -> int:
        return SLOT_TID0 + slot

    # -- the pod step's phases -------------------------------------------
    def step_begin(self) -> None:
        """A pod step's entry: ``admit`` begins."""
        t = time.perf_counter()
        self._t_step = self.t_phase = t
        self._gc_step = _gc_clock[0]
        self.phase_name = "admit"
        if profiling():
            self._ranges = []
            self._open("pod_step")
            self._open("admit")

    def phase(self, name: str) -> float:
        """A boundary inside the pod step: the phase running now ends and
        ``name`` begins at one stamp, which is returned. Entering a half
        from outside the dispatch opens the dispatch; leaving the halves
        closes it (``serve_step_dispatch_seconds``, the ``dispatch``
        span and range). A boundary into the phase running now is
        none."""
        prev = self.phase_name
        if name == prev:
            return self.t_phase
        t = time.perf_counter()
        t0 = self.t_phase
        self.phase_s[prev].observe(t - t0)
        into, out_of = name in _HALVES, prev in _HALVES
        if into and not out_of:
            self._t_dispatch = t
        elif out_of and not into:
            self.dispatch_s.observe(t - self._t_dispatch)
        tr = self.trace
        if tr.enabled:
            tr.complete(prev, t0, t, STEP_TID)
            if out_of and not into:
                tr.complete("dispatch", self._t_dispatch, t, STEP_TID)
        if profiling():
            self._close(prev)
            if out_of and not into:
                self._close("dispatch")
            if into and not out_of:
                self._open("dispatch")
            self._open(name)
        self.phase_name, self.t_phase = name, t
        return t

    def step_timing(self, kind: str) -> float:
        """The end of the step's one readback: ``device_get`` ends and
        ``finish`` begins (``phase``). The trace gets the step ⊃
        {dispatch, device_get} span triple on the step track; ``kind``
        names the step."""
        t0 = self._t_dispatch
        t = self.phase("finish")
        tr = self.trace
        if tr.enabled:
            tr.complete(f"step:{kind}", t0, t, STEP_TID)
        return t

    def step_end(self) -> float:
        """The pod step's return: its last phase ends; observes the
        step's wall time, which is returned, and its collector
        seconds."""
        t = time.perf_counter()
        prev, t0 = self.phase_name, self.t_phase
        self.phase_s[prev].observe(t - t0)
        dt = t - self._t_step
        self.step_s.observe(dt)
        self.gc_s.observe(_gc_clock[0] - self._gc_step)
        tr = self.trace
        if tr.enabled:
            tr.complete(prev, t0, t, STEP_TID)
            tr.complete("pod_step", self._t_step, t, STEP_TID)
        self._close_all()
        self.phase_name = ""
        return dt

    def abort_step(self) -> None:
        """A pod step that raised: closes its open ranges; neither the
        phase it broke off nor the step is observed."""
        self._close_all()
        self.phase_name = ""

    def _close_all(self) -> None:
        while self._ranges:
            self._ranges.pop()[1].__exit__(None, None, None)

    def _open(self, name: str) -> None:
        from torch.autograd.profiler import record_function
        rf = record_function(SERVE_RANGE + name)
        rf.__enter__()
        self._ranges.append((name, rf))

    def _close(self, name: str) -> None:
        """Close the innermost range if it is ``name`` (a profiler that
        started inside the step never opened the ranges before it)."""
        if self._ranges and self._ranges[-1][0] == name:
            self._ranges.pop()[1].__exit__(None, None, None)
