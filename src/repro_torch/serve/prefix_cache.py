"""Radix prefix cache: shared-prefix KV reuse over the paged block pool (a
copy of ``repro.serve.prefix_cache``; the port imports nothing of
``repro``, and its keys equal the reference's bit for bit).

Most production traffic shares long common prefixes — system prompts,
few-shot templates, fixed multimodal instruction preambles — and the
per-expert routing of the decentralized deployment concentrates similar
requests on the same pods, which makes prefix reuse *more* likely under
the Eq. 27 mixture than in a centralized server. Yet without this module
every admission re-prefills its full prompt into freshly allocated blocks.

The cache makes paged KV blocks content-addressed and shareable:

* **Keying** — a radix tree over *full-block* token chunks
  (``block_keys``): the key of logical block ``i`` is the tuple of token
  ids occupying its ``block_size`` positions, rooted at a digest of the
  request's modality extras (image patches / audio frames), since every
  decoder position's KV depends on them. A block is only ever cached once
  its whole extent is prompt content, so cached blocks are immutable —
  decode writes always land past the prompt, in private blocks.
* **Sharing** — ``match`` walks the tree for the longest cached run of
  full-block keys, capped at ``(width - 1) // block_size`` so at least one
  position is always re-prefilled (the last position's logits produce the
  first token, and — when a block-aligned prompt is fully cached — the
  re-prefilled suffix recomputes the final block into a fresh private
  block instead of writing a shared one: the copy-on-write rule, realized
  as recompute-into-private since the suffix is recomputed anyway).
  Matched blocks are spliced read-only into the request's block table
  (``acquire`` → refcount++) and chunked prefill starts at the first
  uncached position, so a hit's TTFT is roughly one chunk.
* **Insertion** — when a request's prefill completes, its full prompt
  blocks enter the tree (``insert``); the private ones become tracked with
  the owner's reference. Two requests racing the same new prefix both
  prefill privately; the first insert wins the tree slot, the loser's
  blocks stay untracked and return to the free list at retirement.
* **Eviction** — a tracked block whose last reference drops joins an LRU
  list instead of the free list (``release``); under pool pressure
  ``evict`` returns least-recently-used *leaf* blocks to the allocator
  (a non-leaf still backs longer cached prefixes; live holders of a child
  always hold its parent, so leaves-first eviction never strands a path).

The tree, refcounts, and LRU are host state, exactly like the block
tables: the only device-visible artifact is the block table each step
already uploads.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from types import MappingProxyType
from typing import Any, Dict, Hashable, List, Mapping, Optional

import numpy as np

from repro_torch.obs.metrics import MetricsRegistry


def block_keys(tokens: np.ndarray, extras: Dict[str, np.ndarray],
               block_size: int, n_blocks: int, *,
               n_prefix: int = 0) -> List[Hashable]:
    """Content keys for the first ``n_blocks`` full blocks of a prompt.

    ``n_prefix`` is the modality-prefix width (VLM image patches occupy
    decoder positions before the tokens); positions inside it contribute no
    token ids — their content is pinned by the extras digest, which roots
    the key path (key 0), so prompts with different patches/frames can
    never share a block even when their token ids agree.
    """
    if n_blocks <= 0:
        return []
    ext = tuple(sorted(
        (name, hashlib.sha1(np.ascontiguousarray(v).tobytes()).hexdigest())
        for name, v in extras.items()))
    keys: List[Hashable] = []
    for i in range(n_blocks):
        lo = max(i * block_size - n_prefix, 0)
        hi = max((i + 1) * block_size - n_prefix, 0)
        chunk = tuple(int(t) for t in tokens[lo:hi])
        keys.append((ext, chunk) if i == 0 else chunk)
    return keys


class _Node:
    __slots__ = ("key", "parent", "children", "block")

    def __init__(self, key: Optional[Hashable], parent: Optional["_Node"],
                 block: int = -1):
        self.key = key
        self.parent = parent
        self.children: Dict[Hashable, "_Node"] = {}
        self.block = block


class PrefixCache:
    """Host-side radix tree + refcounts + LRU over one ``BlockAllocator``.

    The scheduler owns the protocol: ``match`` at admission (pure),
    ``acquire`` once the reservation succeeds, ``record`` for the stats,
    ``insert`` when the prefill completes, ``release`` per block at
    retirement (True → the cache keeps the block; False → free it), and
    ``evict`` when the allocator runs dry.
    """

    def __init__(self, allocator, block_size: int,
                 registry: Optional[MetricsRegistry] = None):
        self.allocator = allocator
        self.block_size = block_size
        self._root = _Node(None, None)
        self._by_block: Dict[int, _Node] = {}
        self._ref: Dict[int, int] = {}
        self._lru: "OrderedDict[int, None]" = OrderedDict()  # oldest first
        # hit/evict counters live in the engine's metrics registry
        # so the exposition endpoints see them; the legacy int attributes
        # (``lookups``, ``skipped_tokens``, …) remain as read properties
        # over the same series. A standalone cache gets a private registry.
        reg = registry if registry is not None else MetricsRegistry()
        self._c_lookups = reg.counter(
            "serve_prefix_lookups_total", "admissions matched vs the tree")
        self._c_lookup_tokens = reg.counter(
            "serve_prefix_lookup_tokens_total",
            "prompt positions those admissions carried")
        self._c_hit_blocks = reg.counter(
            "serve_prefix_hit_blocks_total",
            "cached blocks spliced read-only into admissions")
        self._c_skipped_tokens = reg.counter(
            "serve_prefix_skipped_tokens_total",
            "prompt positions served from cache (prefill skipped)")
        self._c_inserted = reg.counter(
            "serve_prefix_inserted_blocks_total",
            "blocks newly tracked at prefill completion")
        self._c_evicted = reg.counter(
            "serve_prefix_evicted_blocks_total",
            "LRU blocks returned to the pool under pressure")

    # legacy counter surface — read-only views over the registry series
    @property
    def lookups(self) -> int:
        return int(self._c_lookups.value)

    @property
    def lookup_tokens(self) -> int:
        return int(self._c_lookup_tokens.value)

    @property
    def hit_blocks(self) -> int:
        return int(self._c_hit_blocks.value)

    @property
    def skipped_tokens(self) -> int:
        return int(self._c_skipped_tokens.value)

    @property
    def inserted_blocks(self) -> int:
        return int(self._c_inserted.value)

    @property
    def evicted_blocks(self) -> int:
        return int(self._c_evicted.value)

    # ------------------------------------------------------------------
    # Tree
    # ------------------------------------------------------------------

    @property
    def n_cached(self) -> int:
        return len(self._by_block)

    @property
    def n_evictable(self) -> int:
        return len(self._lru)

    @property
    def refcounts(self) -> Mapping[int, int]:
        """Read-only ``block -> refcount`` view over every cache-tracked
        block — the PoolSanitizer's contract for cross-checking slot
        tables against cache ownership without reaching into the tree."""
        return MappingProxyType(self._ref)

    @property
    def evictable_blocks(self) -> Mapping[int, None]:
        """Read-only view of the LRU set (refcount-0 blocks, oldest
        first). The conservation invariant the sanitizer enforces:
        a block is here if and only if its refcount is 0."""
        return MappingProxyType(self._lru)

    def match(self, keys: List[Hashable], width: int) -> List[int]:
        """Longest cached run of full-block keys, capped so at least one
        prompt position is always re-prefilled. Pure — admission may retry
        after a failed reservation without skewing the stats; call
        ``acquire`` + ``record`` once the blocks are actually mapped."""
        limit = (width - 1) // self.block_size
        node, blocks = self._root, []
        for key in keys[:limit]:
            child = node.children.get(key)
            if child is None:
                break
            blocks.append(child.block)
            node = child
        return blocks

    def insert(self, keys: List[Hashable], blocks) -> int:
        """Walk/extend the tree with a completed prefill's full prompt
        blocks. Existing nodes (the matched prefix, or a concurrent
        identical prefill that inserted first) are kept — the caller's
        block for such a position stays untracked and is freed at
        retirement. Newly created nodes take the caller's block with one
        reference (the caller still maps it). Returns blocks tracked."""
        node, created = self._root, 0
        for key, b in zip(keys, blocks):
            child = node.children.get(key)
            if child is None:
                b = int(b)
                child = _Node(key, node, b)
                node.children[key] = child
                self._by_block[b] = child
                self._ref[b] = 1
                created += 1
                self._c_inserted.inc()
            node = child
        return created

    # ------------------------------------------------------------------
    # References / LRU
    # ------------------------------------------------------------------

    def acquire(self, blocks: List[int]) -> None:
        """A request mapped these cached blocks into its table."""
        for b in blocks:
            self._ref[b] += 1
            self._lru.pop(b, None)

    def release(self, block: int) -> bool:
        """Drop one reference. True → the cache tracks the block (it stays
        in the pool; refcount 0 parks it on the LRU list, most recent
        last). False → untracked: the caller returns it to the free list."""
        if block not in self._ref:
            return False
        self._ref[block] -= 1
        assert self._ref[block] >= 0, block
        if self._ref[block] == 0:
            self._lru[block] = None
        return True

    def record(self, width: int, cached: int) -> None:
        """Stats for one successful admission: ``cached`` of the request's
        ``width`` prompt positions were served from the tree."""
        self._c_lookups.inc()
        self._c_lookup_tokens.inc(width)
        self._c_hit_blocks.inc(cached // self.block_size)
        self._c_skipped_tokens.inc(cached)

    # ------------------------------------------------------------------
    # Eviction
    # ------------------------------------------------------------------

    def _pop_node(self, node: _Node) -> None:
        del self._by_block[node.block]
        del self._lru[node.block]
        del self._ref[node.block]
        node.parent.children.pop(node.key)
        self._c_evicted.inc()

    def evict(self, n: int) -> int:
        """Return up to ``n`` least-recently-used unreferenced cached
        blocks to the allocator, pruning their tree nodes. Only leaves are
        eligible (an interior node still backs longer cached prefixes, and
        any live holder of a child also holds its parent — so leaves
        always free up first). One walk over the LRU list in recency
        order: each leaf met is evicted, then its parent chain follows
        while parents become childless and are themselves unreferenced —
        a parent enters the LRU list immediately before its last-released
        child, so chain-following keeps the old strictly-LRU order while
        staying linear (no head-rescan per freed block)."""
        freed: List[int] = []
        for victim in list(self._lru):
            if len(freed) >= n:
                break
            node = self._by_block.get(victim)
            if node is None or node.children:   # chain-evicted / interior
                continue
            self._pop_node(node)
            freed.append(victim)
            parent = node.parent
            while len(freed) < n and parent is not self._root \
                    and not parent.children and parent.block in self._lru:
                self._pop_node(parent)
                freed.append(parent.block)
                parent = parent.parent
        if freed:
            self.allocator.free(freed)
        return len(freed)

    # ------------------------------------------------------------------
    # Observability
    # ------------------------------------------------------------------

    @property
    def hit_rate(self) -> float:
        """Fraction of admitted prompt tokens served from the cache."""
        return self.skipped_tokens / self.lookup_tokens \
            if self.lookup_tokens else 0.0

    def stats(self) -> Dict[str, Any]:
        return {
            "prefix_lookups": self.lookups,
            "prefix_hit_rate": round(self.hit_rate, 4),
            "prefix_skipped_tokens": self.skipped_tokens,
            "prefix_cached_blocks": self.n_cached,
            "prefix_evictable_blocks": self.n_evictable,
            "prefix_inserted_blocks": self.inserted_blocks,
            "prefix_evicted_blocks": self.evicted_blocks,
        }
