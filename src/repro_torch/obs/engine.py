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

Metric catalog lives in docs/observability.md; names are stable surface.
"""
from __future__ import annotations

import time
from typing import Dict, Optional

from repro_torch.obs import metrics as _m
from repro_torch.obs.trace import (ADMIT_TID, SLOT_TID0, STEP_TID, NullRecorder,
                             TraceRecorder)

__all__ = ["EngineObs"]

# Accept-length histogram: speculative spans commit 1..spec_len tokens
# per verify step; unit-width buckets make the histogram an exact
# distribution over commit lengths for any spec_len <= 16.
ACCEPT_LEN_BUCKETS = tuple(float(i) for i in range(1, 17))
# Per-request accept-rate in [0, 1], tenth-width buckets.
RATE_BUCKETS = tuple(round(0.1 * i, 1) for i in range(0, 11))


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

    def step_timing(self, kind: str, t0: float, t1: float) -> None:
        """Record one step's dispatch/readback split (t2 = now).

        ``t0`` → dispatch begins, ``t1`` → dispatch returned (device
        launches queued), now → the step's one ``.cpu()`` readback done
        (on the card: the wait for the device). The
        histograms always update; the trace gets a nested
        step ⊃ {dispatch, device_get} span triple on the step track.
        """
        t2 = time.perf_counter()
        self.dispatch_s.observe(t1 - t0)
        self.readback_s.observe(t2 - t1)
        tr = self.trace
        if tr.enabled:
            tr.complete(f"step:{kind}", t0, t2, STEP_TID)
            tr.complete("dispatch", t0, t1, STEP_TID)
            tr.complete("device_get", t1, t2, STEP_TID)
        return None
