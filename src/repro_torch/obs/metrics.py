"""Metrics registry — counters, gauges, and log-bucket histograms (a copy
of ``repro.obs.metrics``; the port imports nothing of ``repro``).

The serving engine's telemetry substrate (the QoS layer emits into it).
Pure host-side Python — this module imports neither torch nor numpy and
never touches device values, so it adds no device synchronisation.

Model
-----
A :class:`MetricsRegistry` owns a flat set of *series*, each keyed by
``(name, sorted label items)``. Three instrument types:

* :class:`Counter` — monotonically increasing float (``inc``). Resets
  only via the documented ``reset()`` (see below).
* :class:`Gauge` — last-write-wins float (``set``/``inc``).
* :class:`Histogram` — fixed-bound bucket counts + running sum/count.
  Latency histograms use :func:`log_buckets` (powers of two from 10 µs
  to ~10 s) so one bucket layout serves µs-scale host stamps and
  second-scale queue delays alike.

Each engine owns a private registry (labelled with its pod id); a
process-global *default* registry aggregates engines that opted in via
``EngineConfig(metrics=True)`` for single-endpoint exposition.

Exposition
----------
``to_dict()`` emits a JSON-friendly snapshot; ``to_prometheus()`` emits
Prometheus text format (``# TYPE`` once per metric name, ``_bucket``/
``_sum``/``_count`` expansion for histograms, cumulative ``le`` buckets).

Reset semantics (documented contract)
-------------------------------------
``MetricsRegistry.reset()`` zeroes **every** series in the registry —
counters, gauges, and histogram buckets — without dropping the series
themselves (handles held by the engine stay valid). The engine layer
builds its narrower per-run ``reset_stats()`` on top of this; see
``scheduler._SlotTable.reset_stats``.
"""
from __future__ import annotations

import json
import threading
import weakref
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "log_buckets", "default_registry", "snapshot", "prometheus",
]


def log_buckets(lo: float = 1e-5, hi: float = 16.0,
                factor: float = 2.0) -> Tuple[float, ...]:
    """Fixed log-scale bucket bounds: ``lo * factor**i`` up through ``hi``.

    Defaults span 10 µs … ~16 s in powers of two — wide enough that one
    layout covers dispatch stamps, readback stamps, TTFT and e2e latency
    without per-metric tuning (21 buckets + the implicit +Inf).
    """
    if lo <= 0 or factor <= 1:
        raise ValueError("log_buckets needs lo > 0 and factor > 1")
    out: List[float] = []
    b = lo
    while b <= hi * (1 + 1e-12):
        out.append(b)
        b *= factor
    return tuple(out)


LATENCY_BUCKETS = log_buckets()


def _label_key(labels: Optional[Mapping[str, str]]) -> Tuple[Tuple[str, str], ...]:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class _Series:
    """Common bits: identity (name + labels) and the owning lock."""

    kind = "untyped"

    def __init__(self, name: str, help: str,
                 labels: Tuple[Tuple[str, str], ...],
                 lock: threading.Lock) -> None:
        self.name = name
        self.help = help
        self.labels = labels
        self._lock = lock

    @property
    def label_dict(self) -> Dict[str, str]:
        return dict(self.labels)


class Counter(_Series):
    """Monotonic counter. ``inc(n)`` with n >= 0; read via ``.value``."""

    kind = "counter"

    def __init__(self, name: str, help: str,
                 labels: Tuple[Tuple[str, str], ...],
                 lock: threading.Lock) -> None:
        super().__init__(name, help, labels, lock)
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        return self._value

    def reset(self) -> None:
        with self._lock:
            self._value = 0.0


class Gauge(_Series):
    """Last-write-wins instantaneous value."""

    kind = "gauge"

    def __init__(self, name: str, help: str,
                 labels: Tuple[Tuple[str, str], ...],
                 lock: threading.Lock) -> None:
        super().__init__(name, help, labels, lock)
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        return self._value

    def reset(self) -> None:
        with self._lock:
            self._value = 0.0


class Histogram(_Series):
    """Fixed-bound histogram with running sum/count.

    ``bounds`` are upper edges of the finite buckets; one extra bucket
    catches overflow (the Prometheus ``+Inf`` bucket). Observation is a
    linear scan — bounds are short (≤ ~24) and the hot path observes a
    handful of values per engine step, so this stays cheaper than the
    dispatch it measures.
    """

    kind = "histogram"

    def __init__(self, name: str, help: str,
                 labels: Tuple[Tuple[str, str], ...],
                 lock: threading.Lock,
                 bounds: Sequence[float] = LATENCY_BUCKETS) -> None:
        super().__init__(name, help, labels, lock)
        b = tuple(float(x) for x in bounds)
        if list(b) != sorted(b) or len(set(b)) != len(b):
            raise ValueError(f"histogram {name}: bounds must be strictly "
                             f"increasing, got {b}")
        self.bounds = b
        self._counts = [0] * (len(b) + 1)
        self._sum = 0.0
        self._count = 0

    def observe(self, v: float) -> None:
        i = 0
        n = len(self.bounds)
        while i < n and v > self.bounds[i]:
            i += 1
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1

    @property
    def value(self) -> float:
        """Mean observation (NaN when empty) — the scalar summary."""
        return self._sum / self._count if self._count else float("nan")

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    @property
    def counts(self) -> Tuple[int, ...]:
        return tuple(self._counts)

    def reset(self) -> None:
        with self._lock:
            self._counts = [0] * (len(self.bounds) + 1)
            self._sum = 0.0
            self._count = 0


class MetricsRegistry:
    """Flat series store keyed by ``(name, labels)``.

    ``counter``/``gauge``/``histogram`` are get-or-create: calling twice
    with the same name+labels returns the same handle, so engine layers
    can cache handles at init and label-variant call sites (per finish
    reason, per draft source) can resolve lazily. A name is bound to one
    instrument type; re-requesting it as another type raises.

    ``base_labels`` (e.g. ``{"pod": "0"}``) are merged into every series
    created through this registry — this is how per-pod labelling on the
    decentralized server works without threading a pod id through every
    call site.
    """

    def __init__(self, base_labels: Optional[Mapping[str, str]] = None) -> None:
        self.base_labels = dict(base_labels or {})
        self._lock = threading.Lock()
        self._series: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], _Series] = {}
        self._kinds: Dict[str, str] = {}
        self._help: Dict[str, str] = {}

    # -- creation ---------------------------------------------------------
    def _get(self, cls, name: str, help: str,
             labels: Optional[Mapping[str, str]], **kw) -> _Series:
        merged = dict(self.base_labels)
        merged.update(labels or {})
        key = (name, _label_key(merged))
        with self._lock:
            s = self._series.get(key)
            if s is not None:
                if not isinstance(s, cls):
                    raise ValueError(f"metric {name!r} already registered "
                                     f"as {s.kind}, not {cls.kind}")
                return s
            if name in self._kinds and self._kinds[name] != cls.kind:
                raise ValueError(f"metric {name!r} already registered "
                                 f"as {self._kinds[name]}, not {cls.kind}")
            s = cls(name, help or self._help.get(name, ""), key[1],
                    threading.Lock(), **kw)
            self._series[key] = s
            self._kinds[name] = cls.kind
            if help:
                self._help[name] = help
            return s

    def counter(self, name: str, help: str = "",
                labels: Optional[Mapping[str, str]] = None) -> Counter:
        return self._get(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Optional[Mapping[str, str]] = None) -> Gauge:
        return self._get(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "",
                  labels: Optional[Mapping[str, str]] = None,
                  bounds: Sequence[float] = LATENCY_BUCKETS) -> Histogram:
        return self._get(Histogram, name, help, labels, bounds=bounds)

    # -- access -----------------------------------------------------------
    def series(self) -> List[_Series]:
        with self._lock:
            return sorted(self._series.values(),
                          key=lambda s: (s.name, s.labels))

    def get(self, name: str,
            labels: Optional[Mapping[str, str]] = None) -> Optional[_Series]:
        merged = dict(self.base_labels)
        merged.update(labels or {})
        return self._series.get((name, _label_key(merged)))

    def reset(self) -> None:
        """Zero every series (documented contract — see module docstring).

        Series objects survive: handles cached by the engine keep
        working, only their values return to zero. Use this between
        exposition epochs; the engine's per-run hygiene is the narrower
        ``reset_stats()`` built on individual handles.
        """
        for s in self.series():
            s.reset()

    # -- exposition -------------------------------------------------------
    def to_dict(self) -> Dict[str, object]:
        """JSON-friendly snapshot: one entry per series."""
        out: List[Dict[str, object]] = []
        for s in self.series():
            d: Dict[str, object] = {
                "name": s.name, "type": s.kind, "labels": s.label_dict,
            }
            if isinstance(s, Histogram):
                d["sum"] = s.sum
                d["count"] = s.count
                d["bounds"] = list(s.bounds)
                d["buckets"] = list(s.counts)
            else:
                d["value"] = s.value
            out.append(d)
        return {"metrics": out}

    def to_prometheus(self) -> str:
        return prometheus([self])

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=1)


# -- process-global default registry -------------------------------------
# Engines created with EngineConfig(metrics=True) attach their private
# registries here so one exposition endpoint can serve every live engine
# in the process. WeakSet: an engine that goes away takes its series with
# it instead of leaking into the global view forever.
_DEFAULT = MetricsRegistry()
_ATTACHED: "weakref.WeakSet[MetricsRegistry]" = weakref.WeakSet()


def default_registry() -> MetricsRegistry:
    """The process-global registry (plus ``attached()`` engine views)."""
    return _DEFAULT


def attach(reg: MetricsRegistry) -> None:
    _ATTACHED.add(reg)


def detach(reg: MetricsRegistry) -> None:
    _ATTACHED.discard(reg)


def attached() -> List[MetricsRegistry]:
    return sorted(_ATTACHED, key=lambda r: sorted(r.base_labels.items()))


def _all_default() -> List[MetricsRegistry]:
    return [_DEFAULT] + attached()


def snapshot(regs: Optional[Iterable[MetricsRegistry]] = None) -> Dict[str, object]:
    """Merged JSON snapshot over ``regs`` (default: global + attached)."""
    merged: List[object] = []
    for r in (_all_default() if regs is None else regs):
        merged.extend(r.to_dict()["metrics"])  # type: ignore[arg-type]
    return {"metrics": merged}


def prometheus(regs: Optional[Iterable[MetricsRegistry]] = None) -> str:
    """Prometheus text exposition over ``regs`` (default: global + attached).

    ``# HELP``/``# TYPE`` once per metric name even when the same name
    appears in several registries (one series per pod).
    """
    by_name: Dict[str, List[_Series]] = {}
    kinds: Dict[str, str] = {}
    helps: Dict[str, str] = {}
    for r in (_all_default() if regs is None else regs):
        for s in r.series():
            by_name.setdefault(s.name, []).append(s)
            kinds[s.name] = s.kind
            if s.help:
                helps.setdefault(s.name, s.help)
    lines: List[str] = []
    for name in sorted(by_name):
        if name in helps:
            lines.append(f"# HELP {name} {helps[name]}")
        lines.append(f"# TYPE {name} {kinds[name]}")
        for s in by_name[name]:
            if isinstance(s, Histogram):
                cum = 0
                for bound, c in zip(list(s.bounds) + [float("inf")],
                                    s.counts):
                    cum += c
                    le = "+Inf" if bound == float("inf") else repr(bound)
                    lines.append(f"{name}_bucket"
                                 f"{_fmt_labels(s.labels, ('le', le))} {cum}")
                lines.append(f"{name}_sum{_fmt_labels(s.labels)} {s.sum}")
                lines.append(f"{name}_count{_fmt_labels(s.labels)} {s.count}")
            else:
                lines.append(f"{name}{_fmt_labels(s.labels)} {s.value}")
    return "\n".join(lines) + "\n"


def _fmt_labels(labels: Tuple[Tuple[str, str], ...],
                extra: Optional[Tuple[str, str]] = None) -> str:
    items = list(labels) + ([extra] if extra else [])
    if not items:
        return ""
    body = ",".join(f'{k}="{v}"' for k, v in items)
    return "{" + body + "}"
