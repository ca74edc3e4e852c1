"""Per-request span tracing with Chrome/Perfetto ``trace_event`` export (a
copy of ``repro.obs.trace``; the port imports nothing of ``repro``).

Spans are stamped **host-side at scheduler boundaries only** — a stamp is
one ``time.perf_counter()`` call around code the scheduler already runs
(admission, dispatch, the step's one ``.cpu()`` readback, retirement).
Nothing here touches a device tensor or forces a device sync, so the
single-readback contract stays intact. This module imports no torch.

Recorder
--------
:class:`TraceRecorder` keeps events in a bounded ring (``deque`` with
``maxlen``): a long serve run retains the most recent ``capacity`` events
and counts the rest in ``dropped``. Track-naming metadata ("M" events)
lives outside the ring so process/thread names survive wrap. The
:class:`NullRecorder` is the off-switch — every emit method is a no-op
``pass`` and ``enabled`` is False so call sites can skip stamp work
entirely; it is what every engine gets unless ``EngineConfig(trace=True)``.

Event vocabulary (Chrome trace_event, the subset Perfetto renders)
------------------------------------------------------------------
* ``"X"`` complete spans — ``ts``/``dur`` in integer microseconds. Used
  for everything slot-serial: admission, prefix_match, prefill_chunk[i],
  prefill/decode phases, and the per-step dispatch/device_get pair
  (``device_get`` names the readback, as in the reference).
  Same-track "X" spans must nest (contain or be disjoint) — the schema
  test enforces this.
* ``"b"``/``"e"`` async spans keyed by ``id`` — used for ``queued``,
  which can overlap arbitrarily many slot-resident spans (requests queue
  while other requests decode on the very slot they will land on).
* ``"C"`` counters — pool free blocks, active/waiting; Perfetto renders
  these as timeline graphs.
* ``"i"`` instants — retirement (with ``finish_reason``), aborts.
* ``"M"`` metadata — ``process_name`` per pod, ``thread_name`` per track.

Track scheme: ``pid`` = pod index. ``tid 0`` = the pod's engine-step
track, ``tid 1`` = admission-retired requests (never held a slot),
``tid 1000+slot`` = one track per cache slot.

Export: ``to_chrome()`` returns ``{"traceEvents": [...]}`` — the JSON
object format ``ui.perfetto.dev`` and ``chrome://tracing`` both load.
"""
from __future__ import annotations

import json
from collections import deque
from typing import Dict, Iterable, List, Optional

__all__ = ["NullRecorder", "TraceRecorder", "merge_chrome", "us"]

# Track ids within one pod (pid). Slot tracks start high so slot count
# never collides with the fixed tracks.
STEP_TID = 0
ADMIT_TID = 1
SLOT_TID0 = 1000


def us(t_seconds: float) -> int:
    """perf_counter seconds → integer trace microseconds."""
    return int(round(t_seconds * 1e6))


class NullRecorder:
    """Do-nothing recorder — the default. ``enabled`` gates stamp work.

    Every emit is ``pass`` so a disabled engine pays one attribute load
    and a no-op call per would-be event; sites that need extra stamps
    (``time.perf_counter()`` pairs taken only for tracing) check
    ``enabled`` first and skip them entirely.
    """

    enabled = False

    def __init__(self, pid: int = 0) -> None:
        self.pid = pid
        self.dropped = 0

    # -- emission (all no-ops) -------------------------------------------
    def complete(self, name: str, t0: float, t1: float, tid: int,
                 cat: str = "span", args: Optional[dict] = None) -> None:
        pass

    def async_begin(self, name: str, t0: float, aid: int,
                    cat: str = "request",
                    args: Optional[dict] = None) -> None:
        pass

    def async_end(self, name: str, t1: float, aid: int,
                  cat: str = "request") -> None:
        pass

    def instant(self, name: str, t: float, tid: int,
                args: Optional[dict] = None) -> None:
        pass

    def counter(self, name: str, t: float, values: dict) -> None:
        pass

    def set_process_name(self, name: str) -> None:
        pass

    def set_thread_name(self, tid: int, name: str) -> None:
        pass

    # -- export -----------------------------------------------------------
    def events(self) -> List[dict]:
        return []

    def to_chrome(self) -> dict:
        return {"traceEvents": [], "displayTimeUnit": "ms"}

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)


class TraceRecorder(NullRecorder):
    """Bounded ring-buffer recorder emitting Chrome trace events.

    ``capacity`` bounds the span/instant/counter ring; when it wraps the
    oldest events drop (counted in ``dropped``) and the trace keeps the
    most recent window — the right default for long serve runs. Metadata
    events are stored aside (a handful per engine) so track names always
    survive.
    """

    enabled = True

    def __init__(self, capacity: int = 65536, pid: int = 0) -> None:
        super().__init__(pid)
        if capacity < 1:
            raise ValueError(f"trace ring capacity must be >= 1, "
                             f"got {capacity}")
        self.capacity = capacity
        self._ring: "deque[dict]" = deque(maxlen=capacity)
        self._meta: Dict[tuple, dict] = {}

    def _push(self, ev: dict) -> None:
        if len(self._ring) == self.capacity:
            self.dropped += 1
        self._ring.append(ev)

    # -- emission ---------------------------------------------------------
    def complete(self, name: str, t0: float, t1: float, tid: int,
                 cat: str = "span", args: Optional[dict] = None) -> None:
        ev = {"name": name, "cat": cat, "ph": "X", "ts": us(t0),
              "dur": max(0, us(t1) - us(t0)), "pid": self.pid, "tid": tid}
        if args:
            ev["args"] = args
        self._push(ev)

    def async_begin(self, name: str, t0: float, aid: int,
                    cat: str = "request",
                    args: Optional[dict] = None) -> None:
        ev = {"name": name, "cat": cat, "ph": "b", "id": aid, "ts": us(t0),
              "pid": self.pid, "tid": ADMIT_TID}
        if args:
            ev["args"] = args
        self._push(ev)

    def async_end(self, name: str, t1: float, aid: int,
                  cat: str = "request") -> None:
        self._push({"name": name, "cat": cat, "ph": "e", "id": aid,
                    "ts": us(t1), "pid": self.pid, "tid": ADMIT_TID})

    def instant(self, name: str, t: float, tid: int,
                args: Optional[dict] = None) -> None:
        ev = {"name": name, "cat": "event", "ph": "i", "ts": us(t),
              "pid": self.pid, "tid": tid, "s": "t"}
        if args:
            ev["args"] = args
        self._push(ev)

    def counter(self, name: str, t: float, values: dict) -> None:
        self._push({"name": name, "cat": "counter", "ph": "C",
                    "ts": us(t), "pid": self.pid, "tid": STEP_TID,
                    "args": dict(values)})

    def set_process_name(self, name: str) -> None:
        self._meta[("p",)] = {
            "name": "process_name", "ph": "M", "pid": self.pid, "tid": 0,
            "args": {"name": name}}

    def set_thread_name(self, tid: int, name: str) -> None:
        self._meta[("t", tid)] = {
            "name": "thread_name", "ph": "M", "pid": self.pid, "tid": tid,
            "args": {"name": name}}

    # -- export -----------------------------------------------------------
    def events(self) -> List[dict]:
        return [self._meta[k] for k in sorted(self._meta,
                                              key=lambda k: (len(k), k))] \
            + list(self._ring)

    def to_chrome(self) -> dict:
        return {"traceEvents": self.events(), "displayTimeUnit": "ms"}


def merge_chrome(recorders: Iterable[NullRecorder]) -> dict:
    """One Chrome trace over several recorders (one per pod).

    Recorders share the process ``perf_counter`` time base, so their
    timestamps interleave coherently; distinct ``pid``s keep their tracks
    apart in the Perfetto UI.
    """
    events: List[dict] = []
    for r in recorders:
        events.extend(r.events())
    return {"traceEvents": events, "displayTimeUnit": "ms"}
