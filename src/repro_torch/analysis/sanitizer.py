"""PoolSanitizer — a race detector for the paged KV block pool (a copy of
``repro.analysis.sanitizer``; the port imports nothing of ``repro``, and
its ``_SlotTable`` keeps the fields this checker reads).

The paged serving stack keeps four views of block ownership that must
agree every step: the allocator's free list, each slot's block table, the
prefix cache's refcounts/LRU, and (since the generation counters) each
table entry's allocation generation.  A refcount-0 eviction aliasing
— a cached block evicted to the free list while a live request's table
still mapped it, then handed to a second request — was exactly a
disagreement between these views that nothing cross-checked at runtime.

Enabled via ``EngineConfig(sanitize=True)`` / ``--sanitize``, the
sanitizer shadows ``_SlotTable`` around every dispatch:

* ``begin_step``  — records the step's write *plan*: one decode write per
  decoding slot at each position of its step span (vanilla steps write
  one position; a speculative step writes ``_SlotTable._step_span ==
  spec_len`` candidate positions), plus the scheduled prefill chunk's
  position span (replaying the scheduler's own chunk admission
  decision).
* ``check_step``  — resolves the plan through the (post-growth) block
  tables and asserts: every write lands in an owned, non-scratch block;
  no decode write touches a cache-tracked block (cached blocks are
  immutable — a write corrupts every future prefix hit); no chunk write
  touches a shared (refcount > 1) block; the chunk and decode write sets
  are disjoint.  Then runs the full pool scan.
* ``check_pool``  — conservation over the whole pool: every block is free
  XOR owned; a block mapped by two slots must be cache-tracked with a
  refcount equal to its holder count; refcount-0 tracked blocks sit on
  the LRU (and only those); no block is leaked (non-free, untracked,
  unmapped); every mapped entry's generation matches the allocator's
  (use-after-free).  Also called at ``abort``/retirement boundaries.

Violations raise ``PoolSanitizerError`` naming the offending slot/block.
Cost is pure host numpy over (n_slots × nb_slot) tables — small next to a
device dispatch; tier-1 runs a subset with it enabled (``-m sanitize``).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Set, Tuple

import numpy as np


class PoolSanitizerError(AssertionError):
    """A paged-pool ownership invariant was violated."""


class PoolSanitizer:
    """Shadow checker over one ``_SlotTable`` (see module docstring)."""

    def __init__(self, table):
        if not getattr(table, "paged", False):
            raise ValueError("PoolSanitizer shadows the paged block pool — "
                             "the table is not paged")
        self.table = table
        self.checked_steps = 0
        self.violations = 0
        self.owned_blocks = 0
        self._decode_plan: List[Tuple[int, int, int]] = []  # slot, rid, pos
        self._chunk_plan: Optional[Tuple[int, int, int, int]] = None

    # ------------------------------------------------------------------
    # step protocol
    # ------------------------------------------------------------------

    def begin_step(self) -> None:
        t = self.table
        self._decode_plan = [(s, t.slot_req[s].rid, int(t.pos[s]))
                             for s in t.decoding]
        self._chunk_plan = None
        if t.chunked and t.prefill_order and t._schedule_chunk():
            # _pick_chunk_slot caches its pick for the step, so this
            # shadow replay and the dispatch see the same slot without
            # double-charging the QoS tenant scheduler
            slot = t._pick_chunk_slot()
            start = int(t.prefill_pos[slot])
            length = min(t.chunk, int(t.prefill_width[slot]) - start)
            self._chunk_plan = (slot, t.slot_req[slot].rid, start, length)

    def check_step(self) -> None:
        t = self.table
        tracked = t.prefix.refcounts if t.prefix is not None else {}
        decode_writes: Set[int] = set()
        span = int(getattr(t, "_step_span", 1))
        s_log = t.nb_slot * t.block_size
        for slot, rid, pos in self._decode_plan:
            req = t.slot_req[slot]
            if req is None or req.rid != rid:
                continue            # retired this step; blocks already freed
            for p in range(pos, pos + span):
                if not t.ring and p >= s_log:
                    # a speculative span past the logical capacity writes
                    # the scratch block by construction (the verify scatter
                    # routes out-of-horizon positions there)
                    continue
                lb = self._logical_block(p)
                pb = self._owned_entry(slot, rid, lb, p,
                                       kind="decode write")
                if pb in tracked:
                    self._violate(
                        f"slot {slot} (request {rid}) decode write at "
                        f"position {p} lands in cache-tracked block {pb} "
                        f"(refcount {tracked[pb]}) — cached blocks are "
                        "immutable; this write would corrupt every future "
                        "prefix hit")
                decode_writes.add(pb)
        if self._chunk_plan is not None:
            slot, rid, start, length = self._chunk_plan
            req = t.slot_req[slot]
            if req is not None and req.rid == rid and length > 0:
                bs = t.block_size
                for lb in range(start // bs, (start + length - 1) // bs + 1):
                    pb = self._owned_entry(slot, rid, lb, start,
                                           kind="prefill-chunk write")
                    ref = tracked.get(pb)
                    if ref is not None and ref > 1:
                        self._violate(
                            f"slot {slot} (request {rid}) prefill chunk "
                            f"[{start}, {start + length}) writes shared "
                            f"prefix block {pb} (refcount {ref}) — "
                            "matched blocks are read-only; prefill must "
                            "start past the cached run")
                    if pb in decode_writes:
                        self._violate(
                            f"prefill-chunk/decode write overlap on block "
                            f"{pb}: slot {slot} (request {rid}) chunks "
                            "into a block another slot decodes into this "
                            "step")
        self.check_pool()
        self.checked_steps += 1

    # ------------------------------------------------------------------
    # pool-wide conservation scan
    # ------------------------------------------------------------------

    def check_pool(self) -> None:
        t = self.table
        alloc = t.allocator
        free = alloc._free_set
        tracked = t.prefix.refcounts if t.prefix is not None else {}
        lru = t.prefix.evictable_blocks if t.prefix is not None else {}
        holders: Dict[int, List[int]] = {}
        for slot in range(t.n_slots):
            n = int(t.n_alloc[slot])
            row = t.block_tables[slot, :n]
            for i, pb in enumerate(row.tolist()):
                if pb == 0:
                    self._violate(
                        f"slot {slot} maps the reserved scratch block 0 at "
                        f"table entry {i} inside its active region "
                        f"(n_alloc={n})")
                holders.setdefault(pb, []).append(slot)
                gen_held = int(t.block_gens[slot, i])
                gen_now = alloc.gen[pb]
                if gen_held != gen_now:
                    self._violate(
                        f"use-after-free: slot {slot} table entry {i} maps "
                        f"block {pb} at generation {gen_held} but the "
                        f"allocator is at generation {gen_now} — the block "
                        "was freed (and possibly reissued) while still "
                        "mapped")
        for pb, slots in holders.items():
            if pb in free:
                self._violate(
                    f"block {pb} is on the free list but still mapped by "
                    f"slot(s) {slots} — a free/realloc would alias two "
                    "requests onto one physical block")
            if len(slots) > 1 and pb not in tracked:
                self._violate(
                    f"block {pb} mapped writable into {len(slots)} slots "
                    f"({slots}) without a prefix-cache refcount — "
                    "write-aliasing between requests")
        # preemption-parked requests hold prefix references with no slot
        # table mapping them (the pin that keeps their prefix resident
        # across the park) — phantom holders for the drift check below
        pins: Dict[int, int] = {}
        for st in getattr(t, "_parked", {}).values():
            for pb in st.pinned:
                pins[pb] = pins.get(pb, 0) + 1
        for pb, ref in tracked.items():
            n_hold = len(holders.get(pb, ())) + pins.get(pb, 0)
            if pb in free:
                self._violate(
                    f"cache-tracked block {pb} (refcount {ref}) is on the "
                    "free list — eviction/release bookkeeping is corrupt")
            if ref != n_hold:
                self._violate(
                    f"refcount drift on cached block {pb}: refcount {ref} "
                    f"but {n_hold} holder(s) — slot table(s) "
                    f"{holders.get(pb, [])} + {pins.get(pb, 0)} parked "
                    "pin(s)")
            if ref == 0 and pb not in lru:
                self._violate(
                    f"cached block {pb} has refcount 0 but is not on the "
                    "LRU list — it can neither be evicted nor freed")
            if ref > 0 and pb in lru:
                self._violate(
                    f"cached block {pb} has refcount {ref} but sits on "
                    "the LRU list — pool pressure could evict a block a "
                    "live request still maps (eviction aliasing)")
        leaked = [pb for pb in range(1, alloc.n_blocks)
                  if pb not in free and pb not in holders
                  and pb not in tracked]
        if leaked:
            self._violate(
                f"leaked block(s) {leaked}: not free, not mapped by any "
                "slot, not cache-tracked — lost to the pool until restart")
        self.owned_blocks = alloc.n_blocks - 1 - alloc.n_free

    # ------------------------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        return {"sanitize_checked_steps": self.checked_steps,
                "sanitize_owned_blocks": self.owned_blocks,
                "sanitize_violations": self.violations}

    def _logical_block(self, pos: int) -> int:
        t = self.table
        if t.ring:
            return (pos % (t.nb_slot * t.block_size)) // t.block_size
        return pos // t.block_size

    def _owned_entry(self, slot: int, rid: int, lb: int, pos: int, *,
                     kind: str) -> int:
        t = self.table
        n = int(t.n_alloc[slot])
        if lb >= n:
            self._violate(
                f"slot {slot} (request {rid}) {kind} at position {pos} "
                f"needs logical block {lb} but the slot owns only {n} "
                "block(s) — the write would land outside its reservation")
        pb = int(t.block_tables[slot, lb])
        if pb == 0:
            self._violate(
                f"slot {slot} (request {rid}) {kind} at position {pos} "
                "resolves to the reserved scratch block 0 — the table row "
                "was masked or never reserved")
        return pb

    def _violate(self, msg: str) -> None:
        self.violations += 1
        raise PoolSanitizerError(f"PoolSanitizer: {msg}")
