"""QoS policy layer: tenant fairness, preemption state, admission control
(a copy of ``repro.serve.qos``; the port imports nothing of ``repro``).

The slot scheduler (``serve/scheduler.py``) is a mechanism: slots, a
paged block pool, chunked prefill co-scheduled with decode. This module
holds the *policy* that arbitrates those mechanisms between tenants —
the pieces the ROADMAP's "Multi-tenant QoS" item names:

* **Weighted fair sharing** (``TenantScheduler``) — classic deficit
  round robin over tenants. Each tenant accrues credit in proportion to
  its configured weight and spends it on prompt tokens (admission charges
  the request's prefill width, a chunk pick charges one chunk), so a
  bursty tenant can never starve a streaming one of prefill bandwidth.
  FCFS order is preserved *within* a tenant; DRR only decides which
  tenant's head request goes next.
* **Preemption bookkeeping** (``ParkedState``) — the host-side record of
  a preempted request: either the swapped-out contents of its private
  KV blocks (``mode="swap"``) or nothing but its pinned prefix-cache
  references (``mode="recompute"``, the victim re-enters chunked prefill
  and replays its generated tokens through the radix cache).
* **Admission control** (``predict_ttft``) — a first-order TTFT model
  from the live token-budget backlog: every queued/prefilling prompt
  token ahead of a new arrival must flow through the per-step chunk
  budget, so predicted TTFT is (backlog / chunk) x the observed step
  time. ``QoSConfig.max_predicted_ttft_s`` turns that into a reject
  (``finish_reason="rejected"``) instead of a wedged queue.

Everything here is plain host-side Python — no device state.
The scheduler consumes the policy objects; this module never imports
the scheduler.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional, Tuple

# Bounded skip-ahead window for admission even when no QoSConfig is set:
# a pool-starved large prompt at the queue head no longer blocks smaller
# admissible requests behind it (head-of-line fix). Kept deliberately
# small so the head request's effective priority degrades by at most
# this many positions.
DEFAULT_ADMIT_LOOKAHEAD = 8


@dataclass(frozen=True)
class QoSConfig:
    """Multi-tenant QoS policy knobs (all optional; frozen/hashable).

    ``tenant_weights`` maps tenant name -> relative fair-share weight as
    a tuple of pairs (a dict would break hashability of the frozen
    ``EngineConfig`` that embeds this). Unlisted tenants weigh 1.0.
    ``quantum`` is the DRR credit per round in prompt tokens (0 -> the
    engine's prefill chunk). ``admit_lookahead`` bounds admission
    skip-ahead past an unservable queue head. ``max_predicted_ttft_s``
    rejects arrivals whose predicted TTFT exceeds it (0 -> disabled);
    ``max_waiting`` rejects on queue depth (0 -> unbounded).
    """
    tenant_weights: Tuple[Tuple[str, float], ...] = ()
    quantum: int = 0
    admit_lookahead: int = DEFAULT_ADMIT_LOOKAHEAD
    max_predicted_ttft_s: float = 0.0
    max_waiting: int = 0

    def __post_init__(self) -> None:
        for name, w in self.tenant_weights:
            if not w > 0:
                raise ValueError(
                    f"tenant_weights[{name!r}] = {w}: weights must be > 0 "
                    "(a zero-weight tenant would never accrue DRR deficit "
                    "and its requests could never be served)")
        if self.quantum < 0:
            raise ValueError("quantum must be >= 0")
        if self.admit_lookahead < 1:
            raise ValueError("admit_lookahead must be >= 1")
        if self.max_predicted_ttft_s < 0:
            raise ValueError("max_predicted_ttft_s must be >= 0")
        if self.max_waiting < 0:
            raise ValueError("max_waiting must be >= 0")

    def weight(self, tenant: str) -> float:
        for name, w in self.tenant_weights:
            if name == tenant:
                return w
        return 1.0


class TenantScheduler:
    """Deficit round robin over tenants, cost unit = prompt tokens.

    ``pick(candidates)`` takes ``{tenant: cost_of_its_head_item}`` and
    returns the tenant whose head item is served next, charging its
    deficit. One call serves one item. Tenants keep their deficit across
    calls (a cost larger than one quantum accumulates over rounds);
    tenants absent from ``candidates`` are idle — their deficit resets
    and they drop out of the rotation, per classic DRR, so a tenant
    cannot bank credit while it has nothing to run.
    """

    def __init__(self, config: Optional[QoSConfig], quantum: int):
        self._cfg = config or QoSConfig()
        self._quantum = max(int(quantum), 1)
        self._deficit: Dict[str, float] = {}
        self._order: List[str] = []      # first-appearance rotation order
        self._ptr = 0
        self._visiting: Optional[str] = None   # tenant granted this visit's
        #                                      # quantum (one grant per visit)

    def _sync(self, candidates: Mapping[str, int]) -> None:
        # prune idle tenants (reset deficit), keeping the pointer aimed
        # at the same surviving tenant; enrol new ones at the rotation end
        keep = [t for t in self._order if t in candidates]
        if len(keep) != len(self._order):
            at = self._order[self._ptr] if self._ptr < len(self._order) \
                else None
            for t in self._order:
                if t not in candidates:
                    self._deficit.pop(t, None)
            self._order = keep
            self._ptr = self._order.index(at) if at in self._order else 0
            if self._visiting not in candidates:
                self._visiting = None
        for t in candidates:
            if t not in self._deficit:
                self._deficit[t] = 0.0
                self._order.append(t)
        if self._order and self._ptr >= len(self._order):
            self._ptr = 0

    def pick(self, candidates: Mapping[str, int]) -> Optional[str]:
        """Next tenant to serve, or None when no candidates exist."""
        if not candidates:
            return None
        self._sync(candidates)
        # Bounded loop: each full rotation adds >= quantum * min_weight
        # (> 0, enforced by QoSConfig) to every candidate's deficit, so
        # some tenant's deficit reaches its head cost in finitely many
        # rounds. Cap defensively anyway.
        max_rounds = len(self._order) * (
            2 + max(candidates.values()) // self._quantum)
        for _ in range(max(max_rounds, 1) * len(self._order)):
            t = self._order[self._ptr]
            # one quantum grant per *visit*: the rotation stays on a
            # tenant while its banked deficit covers further head items,
            # and moves on the moment it cannot — re-granting on every
            # pick would hand the heaviest tenant the whole line
            if self._visiting != t:
                self._deficit[t] += self._quantum * self._cfg.weight(t)
                self._visiting = t
            cost = candidates[t]
            if self._deficit[t] >= cost:
                self._deficit[t] -= cost
                return t
            self._ptr = (self._ptr + 1) % len(self._order)
            self._visiting = None
        raise AssertionError("DRR failed to converge")  # pragma: no cover

    def refund(self, tenant: str, cost: int) -> None:
        """Return a charge taken by ``pick`` whose item was not served.

        ``pick`` debits the head item's cost before the caller knows the
        admit will succeed (slot or pool pressure can still refuse it);
        refunding keeps a tenant's long-run share independent of how
        often its head request bounces.
        """
        if tenant in self._deficit:
            self._deficit[tenant] += cost


def predict_ttft(backlog_tokens: int, chunk: int, step_s: float) -> float:
    """First-order TTFT estimate for a new arrival.

    Every prompt token queued or still prefilling ahead of the arrival
    flows through the per-step chunk budget (one chunk per step), so the
    arrival's first token is about ``ceil(backlog / chunk)`` steps away
    at the observed (EWMA) step time. Deliberately simple — the point is
    a load-shedding signal that tracks the backlog, not a simulator.
    """
    chunk = max(int(chunk), 1)
    steps = -(-int(backlog_tokens) // chunk) + 1     # +1: own first chunk
    return steps * max(step_s, 0.0)


@dataclass
class ParkedState:
    """Host-side record of one preempted (parked) request.

    ``mode`` is "swap" or "recompute". Either way the request keeps its
    prefix-cache references (``pinned``) so shared blocks cannot be
    evicted while it is parked — the resume re-acquires them through the
    normal match path and the pin is dropped then.

    For "swap", ``payload`` holds the host copies of every un-tracked
    (private) block's pool rows plus the slot's direct (non-paged) cache
    leaves, ``private`` the logical order those blocks had in the block
    table, and ``pos``/``last_tok`` the decode cursor; resume allocates
    fresh physical blocks, scatters the payload back, and re-occupies a
    slot with no prefill at all. For "recompute" only the pin survives:
    resume re-enters chunked prefill over prompt + generated tokens.
    """
    req: Any
    mode: str
    pinned: Tuple[int, ...] = ()          # cache-tracked blocks (ref held)
    shared: Tuple[Tuple[int, int], ...] = ()   # (logical idx, phys block)
    private: Tuple[Tuple[int, int], ...] = ()  # (logical idx, phys block)
    payload: Optional[Dict[str, Any]] = None   # swap: host-side contents
    pos: int = 0
    last_tok: int = 0
    n_alloc: int = 0
    extras: Dict[str, Any] = field(default_factory=dict)  # e.g. weights


def tenant_of(req: Any) -> str:
    """Tenant identity of a request (scheduler ``Request`` or raw)."""
    params = getattr(req, "params", None)
    return getattr(params, "tenant", None) or "default"


def priority_of(req: Any) -> int:
    params = getattr(req, "params", None)
    return int(getattr(params, "priority", 0) or 0)
