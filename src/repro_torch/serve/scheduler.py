"""Continuous batching (port of the §5.2 serving path of
``repro.serve.scheduler``).

``make_engine(model, experts=[...], router=r, config=cfg, device="cuda")``
builds the paper's decentralized deployment: the Eq. 28 centroid router
runs at submission on each request's features and sends it to its top-1
expert's pod, a ``SlotServer``. A pod admits requests FCFS into free slots
and decodes every decoding slot in lockstep with the fused step
(``Model.fused_decode_step``). Its KV state is either contiguous per-slot
cache rows or, with ``paged``, a shared pool of blocks reached through
per-slot block tables. Its admission either prefills the whole prompt at
once (``Model.prefill``, then a splice into the slot's cache row or
blocks) or, with ``chunked_prefill`` (paged only), reserves the prompt's
blocks and consumes it ``chunk`` positions per step
(``Model.prefill_chunk``) co-scheduled with the decode under a token
budget; a recurrent family's per-slot state rides in the request's carry
and is spliced into its slot after the last chunk
(``CacheSpec.insert_direct``). With ``speculative="ngram"`` (paged only)
a pod's decode-only steps verify a span of ``spec_len`` positions per
slot, the committed token plus host n-gram drafts (``serve.speculate``),
in one forward (``Model.fused_verify_step``) and emit the accepted run:
the same tokens as vanilla decode, up to ``spec_len`` of them per step.
A request with ``temperature > 0`` is sampled, seeded per request
(``serve.fused``): its first token at admission (or inside its final
chunk's step) and every later one, on every path above.

With ``strategy="mixture"`` the deployment is one ``MixtureSlotServer``
instead of the pods: the K experts stacked on one tensor dim
(``core.ensemble``), every request routed at admission to an (n_slots,
K) row of router weights, and each step one stacked forward whose K
experts' next-token distributions are mixed by Eq. 27 before the pick,
in each of the three configurations above. Its speculation verifies the
span on all K experts in one stacked forward, with n-gram drafts or
(``speculative="expert"``) drafts from expert 0's own greedy decode on
the device (``core.ensemble.make_stacked_verify``).

**The single-dispatch contract.** Each step is one forward (decode or
span verify, plus at most one prefill chunk beside a decode) and its
on-device epilogue, followed by ONE host readback: ``(next_tok, done)``,
or ``(toks, n_emit, done)`` for a verify — plus the chunk's first token
on a prompt's final chunk, read in the same transfer. A monolithic
admission reads back its first token once. The per-slot device state is
rebuilt from the host mirrors only on admission, retirement or
block-table growth. No ``.item()`` sits in the layer loop.

What this port does not run yet is refused by ``EngineConfig.validate``:
QoS and preemption, the prefix cache, the sanitizer, tracing and metrics
export, and the unfused step (see ROADMAP.md).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.ensemble import (make_stacked_fused,
                                       make_stacked_verify,
                                       mix_expert_logits,
                                       stack_experts_for_decode)
from repro_torch.device import resolve_device
from repro_torch.models.model import Model
from repro_torch.serve.api import (EngineConfig, RequestOutput,
                                   SamplingParams, TokenDelta,
                                   effective_page_block, stop_id_row)
from repro_torch.serve.fused import DONE_REASONS, pick_first
from repro_torch.serve.speculate import NGramProposer
from repro_torch.tree import tree_map

Tensor = torch.Tensor

#: Admission skip-ahead past a queue head the pool cannot take yet.
DEFAULT_ADMIT_LOOKAHEAD = 8


@dataclass
class Request:
    """One in-flight request; ``params`` is the canonical carrier of the
    decoding controls (the flat fields mirror it)."""

    rid: int
    tokens: np.ndarray            # (prompt_len,) int32
    max_new: int
    features: Optional[np.ndarray] = None   # frozen-encoder routing features
    extras: Dict[str, np.ndarray] = field(default_factory=dict)
    #                             # unbatched modality inputs: "patches"
    #                             # (vlm)
    params: Optional[SamplingParams] = None
    out: List[int] = field(default_factory=list)
    finish_reason: Optional[str] = None
    t_submit: float = 0.0
    t_admit: float = 0.0
    t_first: float = 0.0
    t_done: float = 0.0
    t_tok: List[float] = field(default_factory=list)
    emitted: int = 0

    def __post_init__(self):
        if self.params is None:
            self.params = SamplingParams(max_new=self.max_new)
        else:
            self.max_new = self.params.max_new

    @property
    def done(self) -> bool:
        return len(self.out) >= self.max_new

    @property
    def hit_stop(self) -> bool:
        s = self.params.stop_set
        return bool(s) and bool(self.out) and self.out[-1] in s

    def reason_now(self) -> Optional[str]:
        if self.hit_stop:
            return "stop"
        if self.done:
            return "length"
        return None

    def record(self, tok: int, t: Optional[float] = None) -> None:
        t = time.perf_counter() if t is None else t
        self.out.append(int(tok))
        self.t_tok.append(t)
        self.t_first = self.t_first or t

    def batch(self, device, pad_to: int = 0) -> Dict[str, Tensor]:
        """Single-row prefill batch (tokens + modality extras, each with a
        leading batch dim), the token row right-padded to ``pad_to``
        (padded rows are masked by the chunk length)."""
        toks = self.tokens
        if pad_to > len(toks):
            toks = np.concatenate(
                [toks, np.zeros(pad_to - len(toks), np.int32)])
        b = {"tokens": torch.as_tensor(toks[None, :].astype(np.int64),
                                       device=device)}
        for name, v in self.extras.items():
            b[name] = torch.as_tensor(np.asarray(v)[None], device=device)
        return b


_FEATURES_MSG = ("request {rid}: this engine routes on frozen-encoder "
                 "features — pass features= to add_request")


def _as_request(prompt, params: Optional[SamplingParams], extras,
                features, rid: int) -> Request:
    if isinstance(prompt, Request):
        return prompt
    sp = params if params is not None else SamplingParams()
    return Request(rid, np.asarray(prompt, dtype=np.int32), sp.max_new,
                   features=features, extras=dict(extras or {}), params=sp)


class BlockAllocator:
    """Free-list allocator over the shared pool of KV blocks. Block 0 is the
    reserved scratch block (idle and mid-prefill rows of the lockstep
    decode write there); ``alloc`` is all-or-nothing; ``free`` rejects
    out-of-range ids and double frees; each block carries a generation
    counter bumped at free, so a stale reference is caught
    (``assert_live``)."""

    def __init__(self, n_blocks: int):
        if n_blocks < 2:
            raise ValueError(f"pool needs >= 2 blocks (one is the reserved "
                             f"scratch block), got {n_blocks}")
        self.n_blocks = n_blocks
        self._free = list(range(n_blocks - 1, 0, -1))   # pop() → low ids
        self._free_set = set(self._free)
        self.gen = [0] * n_blocks

    @property
    def n_free(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> Optional[List[int]]:
        if n > len(self._free):
            return None
        out = [self._free.pop() for _ in range(n)]
        self._free_set.difference_update(out)
        return out

    def free(self, blocks: List[int]) -> None:
        if len(set(blocks)) != len(blocks):
            raise ValueError(f"double free within one call: {blocks}")
        for b in blocks:
            if not 0 < b < self.n_blocks:
                raise ValueError(
                    f"freeing block {b} outside the pool range "
                    f"1..{self.n_blocks - 1} (block 0 is the reserved "
                    f"scratch block)")
            if b in self._free_set:
                raise ValueError(
                    f"double free of block {b} — it is already on the free "
                    f"list; block bookkeeping is corrupt")
        self._free.extend(blocks)
        self._free_set.update(blocks)
        for b in blocks:
            self.gen[b] += 1

    def assert_live(self, block: int, gen: int, *, owner: str = "") -> None:
        cur = self.gen[block]
        if cur != gen:
            who = f" held by {owner}" if owner else ""
            raise ValueError(
                f"use-after-free: block {block}{who} was freed since its "
                f"reservation (generation {cur} != held {gen})")


class _SlotTable:
    """Slot bookkeeping and the drive loop. With ``block_size > 0`` it also
    owns the paged block tables and allocator (a sliding-window model's
    slot reserves its whole ring of ``window`` positions at admission);
    with ``chunk > 0`` each step co-schedules one prefill chunk (FCFS over
    mid-prefill slots) with the lockstep decode of every decoding slot,
    subject to ``token_budget`` (decoding slots count 1 each, the chunk
    counts ``chunk``)."""

    def __init__(self, model: Model, config: EngineConfig, device):
        """The table of ``config`` (validated against ``model``) on
        ``device``."""
        config.validate(model)
        self.config = config
        n_slots, cache_len = config.n_slots, config.cache_len
        block_size = effective_page_block(
            model, config.page_block if config.paged else 0)
        n_blocks, window = config.pool_blocks, model.cfg.sliding_window
        chunk = config.chunk if config.chunked_prefill else 0
        token_budget = config.token_budget
        self.n_slots, self.cache_len = n_slots, cache_len
        self.device = resolve_device(device)
        self.pos = np.zeros(n_slots, dtype=np.int32)      # next position
        self.slot_req: List[Optional[Request]] = [None] * n_slots
        self.last_tok = np.zeros(n_slots, dtype=np.int32)
        self.waiting: List[Request] = []
        self.admit_retired: List[Request] = []   # retired without decoding
        self._next_rid = 0
        self.n_aborted = 0
        self.n_stopped = 0
        self.n_chunks = 0          # prefill chunks consumed
        self.chunk = chunk
        self.chunked = chunk > 0
        self.token_budget = token_budget if token_budget > 0 \
            else n_slots + chunk
        self.prefilling = [False] * n_slots
        self.prefill_pos = np.zeros(n_slots, dtype=np.int32)
        self.prefill_width = np.zeros(n_slots, dtype=np.int32)
        self.prefill_x: List[Any] = [None] * n_slots   # per-chunk tensors
        self.prefill_carry: List[Any] = [None] * n_slots
        self.prefill_order: List[int] = []
        self._dstate = None        # persistent per-slot device state
        self._tables_dirty = False
        self._stop_width = 1       # stop-id matrix width (monotone, pow2)
        self._step_span = 1        # positions the current step writes
        self.speculative = None    # set by _init_speculation
        self.spec_len = 1
        self._can_spec = False
        self.n_spec_steps = 0      # slot-steps of speculative verify
        self.n_spec_tokens = 0     # tokens they emitted
        self.block_size = block_size
        self.paged = block_size > 0
        self.ring = self.paged and window > 0
        if self.paged:
            if self.ring:
                s_kv = min(cache_len, window)
                if s_kv % block_size:
                    raise ValueError(
                        f"sliding-window ring length {s_kv} must be a "
                        f"multiple of page_block={block_size}")
                self.nb_slot = s_kv // block_size
            else:
                self.nb_slot = -(-cache_len // block_size)
            if n_blocks <= 0:      # full capacity + scratch
                n_blocks = n_slots * self.nb_slot + 1
            self.allocator = BlockAllocator(n_blocks)
            self.block_tables = np.zeros((n_slots, self.nb_slot), np.int32)
            self.n_alloc = np.zeros(n_slots, dtype=np.int32)
            self.block_gens = np.zeros((n_slots, self.nb_slot), np.int64)

    def free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.slot_req) if r is None]

    @property
    def active(self) -> List[int]:
        return [i for i, r in enumerate(self.slot_req) if r is not None]

    @property
    def decoding(self) -> List[int]:
        return [i for i, r in enumerate(self.slot_req)
                if r is not None and not self.prefilling[i]]

    # ------------------------------------------------------------------
    # The incremental request-lifecycle API
    # ------------------------------------------------------------------

    def add_request(self, prompt, params: Optional[SamplingParams] = None,
                    extras: Optional[Dict[str, np.ndarray]] = None, *,
                    features: Optional[np.ndarray] = None,
                    rid: Optional[int] = None) -> int:
        """Submit a prompt (token ids) with its modality ``extras`` (a vlm
        request's ``"patches"``, (n_patches, vision_dim)) — or a prebuilt
        ``Request`` — to the waiting queue and return its rid. Never
        dispatches device work. A request no capacity could ever admit
        raises ValueError here."""
        req = _as_request(prompt, params, extras, features,
                          self._next_rid if rid is None else rid)
        self._reject_unservable(req)
        self._next_rid = max(self._next_rid, req.rid + 1)
        req.t_submit = req.t_submit or time.perf_counter()
        self.waiting.append(req)
        return req.rid

    def _reject_unservable(self, req: Request) -> None:
        """Fail at submission on a request no idle server could admit."""
        width = self._prefill_width(req)
        self._reject_overlong(req, width)
        # a monolithic context-filling prompt retires at admission without
        # reserving; every other paged admission reserves the whole prompt
        if self.paged and (self.chunked or width < self.cache_len):
            need = self._blocks_for(width)
            usable = self.allocator.n_blocks - 1
            if need > usable:
                raise ValueError(
                    f"request {req.rid}: its prompt reservation needs "
                    f"{need} KV blocks but the pool has only {usable} "
                    f"usable (pool_blocks={self.allocator.n_blocks}, "
                    f"page_block={self.block_size})")

    def _prefill_width(self, req: Request) -> int:
        """Decoder positions a request's prefill consumes: its prompt, plus
        the vlm family's image prefix of ``n_patches`` rows. (The
        reference also counts a resumed request's regenerated tokens; the
        port has no preemption, so a prefill is always the prompt.)"""
        cfg = self.model.cfg
        return len(req.tokens) + (cfg.n_patches if cfg.family == "vlm"
                                  else 0)

    def _reject_overlong(self, req: Request, width: int) -> None:
        if width > self.cache_len:
            raise ValueError(
                f"request {req.rid}: prompt needs {width} positions but the "
                f"serving context is cache_len={self.cache_len} — reject "
                f"the request or raise cache_len")

    def step(self) -> List[RequestOutput]:
        """Admit from the waiting queue, then run one co-scheduled prefill
        chunk / lockstep decode dispatch. Streams back an output for every
        request that progressed: this step's retirements first, then the
        live deltas in slot order."""
        self._admit_waiting()
        finished, self.admit_retired = self.admit_retired, []
        if self.active:
            finished += self._decode_step_fused()
        outs = [self._output(r) for r in finished]
        for req in self.slot_req:
            if req is not None and req.emitted < len(req.out):
                outs.append(self._output(req))
        return outs

    def abort(self, rid: int) -> Optional[RequestOutput]:
        """Cancel a request wherever it is (queued, mid-prefill or
        mid-decode); frees its slot and blocks. None for an unknown or
        finished rid."""
        for i, req in enumerate(self.waiting):
            if req.rid == rid:
                self.waiting.pop(i)
                return self._finish_aborted(req)
        for slot, req in enumerate(self.slot_req):
            if req is None or req.rid != rid:
                continue
            if self.prefilling[slot]:
                self.prefill_order.remove(slot)
                self.prefilling[slot] = False
                self.prefill_x[slot] = None
                self.prefill_carry[slot] = None
                self.prefill_pos[slot] = 0
                self.prefill_width[slot] = 0
            self._release(slot)
            return self._finish_aborted(req)
        return None

    def has_unfinished(self) -> bool:
        return bool(self.waiting) or bool(self.active)

    def _finish_aborted(self, req: Request) -> RequestOutput:
        req.finish_reason = "aborted"
        req.t_done = time.perf_counter()
        self.n_aborted += 1
        return self._output(req)

    def _admit_waiting(self) -> None:
        """FCFS admission with a bounded skip-ahead past a queue head the
        pool cannot take yet; raises when even an idle server cannot."""
        while self.waiting and self.free_slots():
            for i in range(min(len(self.waiting), DEFAULT_ADMIT_LOOKAHEAD)):
                req = self.waiting[i]
                t0 = time.perf_counter()
                if self.admit(req):
                    self.waiting.pop(i)
                    req.t_admit = req.t_admit or t0
                    break            # restart the scan from the head
            else:
                break                # wait for blocks to free up
        if self.waiting and not self.active:
            raise RuntimeError(
                f"cannot admit request {self.waiting[0].rid} even on an "
                f"idle server — the KV block pool is too small for it")

    def admit(self, req: Request) -> bool:
        raise NotImplementedError

    def _output(self, req: Request) -> RequestOutput:
        new = req.out[req.emitted:]
        stamps = req.t_tok[req.emitted:]
        deltas = [TokenDelta(tok, req.emitted + i, t)
                  for i, (tok, t) in enumerate(zip(new, stamps))]
        req.emitted = len(req.out)
        return RequestOutput(
            rid=req.rid, deltas=deltas, token_ids=list(req.out),
            finished=req.finish_reason is not None,
            finish_reason=req.finish_reason, t_submit=req.t_submit,
            t_first=req.t_first, t_done=req.t_done, t_admit=req.t_admit)

    # ------------------------------------------------------------------
    # Monolithic admission
    # ------------------------------------------------------------------

    def _admission_precheck(self, req: Request, slot: int,
                            width: int) -> bool:
        """Runs before the prefill is paid for. False → the pool has no
        blocks for it right now (the request stays waiting)."""
        self._reject_overlong(req, width)
        return not (self.paged and width < self.cache_len
                    and not self._reserve(slot, width))

    def _admit_prefilled(self, slot: int, req: Request, first: int,
                         width: int, row_cache) -> None:
        """Splice an admitted request's prefill cache into its slot (row or
        blocks) and occupy the slot. A request whose whole budget is the
        prefill token (max_new == 1), or whose first token stops it,
        retires at once."""
        if self.paged:
            blocks = torch.as_tensor(
                self.block_tables[slot, :int(self.n_alloc[slot])],
                device=self.device)
            self.cache = self.spec.insert_paged(self.cache, row_cache, slot,
                                                blocks)
        else:
            self.cache = self.spec.insert(self.cache, row_cache, slot)
        self._occupy(slot, req, first, width)
        reason = req.reason_now()
        if reason:
            self._retire_from_slot(slot, req, reason)
            self.admit_retired.append(req)

    def _retire_at_admission(self, req: Request, first_tok: int) -> None:
        """The prompt already fills the context bound: the request keeps its
        single prefill token and retires without ever holding a slot."""
        req.record(first_tok)
        req.t_done = time.perf_counter()
        self._set_reason(req, req.reason_now() or "truncated")
        self.admit_retired.append(req)

    # ------------------------------------------------------------------
    # Paged-cache bookkeeping
    # ------------------------------------------------------------------

    def _blocks_for(self, upto: int) -> int:
        """Blocks covering positions [0, upto): a ring slot always holds
        its whole span."""
        if self.ring:
            return self.nb_slot
        return max(min(-(-upto // self.block_size), self.nb_slot), 1)

    def _reserve(self, slot: int, upto: int) -> bool:
        """Grow ``slot``'s reservation to cover positions [0, upto);
        all-or-nothing, False when the pool can't satisfy it."""
        need = self._blocks_for(upto)
        have = int(self.n_alloc[slot])
        if need <= have:
            return True
        blocks = self.allocator.alloc(need - have)
        if blocks is None:
            return False
        self.block_tables[slot, have:need] = blocks
        self.n_alloc[slot] = need
        gen = self.allocator.gen
        for i in range(have, need):
            self.block_gens[slot, i] = gen[int(self.block_tables[slot, i])]
        self._tables_dirty = True     # only the table changed
        return True

    def _grow_active(self) -> None:
        """Before a lockstep decode: every decoding slot must own the block
        its next write lands in (a ring slot already holds its span)."""
        if not self.paged or self.ring:
            return
        need = np.minimum(-(-(self.pos + 1) // self.block_size),
                          self.nb_slot)
        if not np.any((need > self.n_alloc) & (self.n_alloc > 0)):
            return
        for slot in self.decoding:
            if not self._reserve(slot, int(self.pos[slot]) + 1):
                req = self.slot_req[slot]
                raise RuntimeError(
                    f"KV block pool exhausted growing slot {slot} (request "
                    f"{req.rid}): {self.allocator.n_free} free of "
                    f"{self.allocator.n_blocks} blocks — provision more "
                    f"pool_blocks or fewer slots")

    def _grow_active_span(self, span: int) -> bool:
        """Span variant of ``_grow_active``: every decoding slot must own
        the blocks of all ``span`` positions a speculative step may write.
        False → the pool cannot cover the span now; the caller takes the
        vanilla one-token step instead of raising. Slots reserved before
        the failing one keep their blocks (they would need them within
        ``span`` vanilla steps anyway). Never a ring: windowed models are
        not ``speculative_capable``."""
        need = np.minimum(-(-(self.pos + span) // self.block_size),
                          self.nb_slot)
        if not np.any((need > self.n_alloc) & (self.n_alloc > 0)):
            return True
        for slot in self.decoding:
            if not self._reserve(slot, int(self.pos[slot]) + span):
                return False
        return True

    def _init_speculation(self, config: EngineConfig, model,
                          vstep) -> None:
        """Arm speculative decoding when the config asks for it and the
        server can roll a span back: paged, ``spec_len > 1``, a
        ``speculative_capable`` model (windowed and hybrid ones degrade
        silently to vanilla decode). ``vstep`` is the verify step
        (``make_verify_fns``, or ``make_stacked_verify`` over an expert
        stack); the host drafts only for ``"ngram"``."""
        self.speculative = config.speculative
        self.spec_len = config.spec_len
        self._can_spec = (config.speculative is not None
                          and config.spec_len > 1 and self.paged
                          and model.speculative_capable)
        if self._can_spec:
            self._vstep = vstep
            self._ngram = NGramProposer(self.spec_len) \
                if config.speculative == "ngram" else None

    def _release(self, slot: int) -> None:
        self.slot_req[slot] = None
        self.pos[slot] = 0           # free slots write the scratch block
        self.last_tok[slot] = 0
        self._dstate = None
        if not self.paged:
            return
        n = int(self.n_alloc[slot])
        if n:
            blocks = self.block_tables[slot, :n].tolist()
            for i, b in enumerate(blocks):
                self.allocator.assert_live(
                    b, int(self.block_gens[slot, i]),
                    owner=f"slot {slot} entry {i}")
            self.allocator.free(blocks)
        self.block_tables[slot, :] = 0
        self.block_gens[slot, :] = 0
        self.n_alloc[slot] = 0

    def _set_reason(self, req: Request, reason: str) -> None:
        req.finish_reason = reason
        self.n_stopped += reason == "stop"

    def _occupy(self, slot: int, req: Request, first_tok: int,
                prompt_len: int) -> None:
        req.record(first_tok)
        self.slot_req[slot] = req
        self.pos[slot] = prompt_len
        self.last_tok[slot] = first_tok
        self._dstate = None

    def _retire_from_slot(self, slot: int, req: Request,
                          reason: str) -> None:
        self._set_reason(req, reason)
        req.t_done = time.perf_counter()
        self._release(slot)

    # ------------------------------------------------------------------
    # The fused step
    # ------------------------------------------------------------------

    def _device_state(self) -> Dict[str, Tensor]:
        """Per-slot device state for the fused dispatch, rebuilt from the
        host mirrors only after admission/retirement; pure table growth
        re-uploads the tables alone. Between those events the state the
        previous dispatch returned is passed straight back in. Unpaged
        state has no tables."""
        dev = self.device
        if self._dstate is not None:
            if self.paged:
                nbl = self._nb_live()
                if self._tables_dirty or \
                        self._dstate["tables"].shape[1] != nbl:
                    self._dstate = dict(self._dstate, tables=torch.as_tensor(
                        self._decode_tables()[:, :nbl], device=dev))
                    self._tables_dirty = False
            return self._dstate
        self._tables_dirty = False
        n = self.n_slots
        temps = np.zeros(n, np.float32)
        top_ks = np.zeros(n, np.int32)
        seeds = np.zeros(n, np.int64)      # uint32 values (torch has no
        counts = np.zeros(n, np.int32)     # full uint32 arithmetic)
        max_new = np.full(n, np.iinfo(np.int32).max, np.int32)
        active = np.zeros(n, np.bool_)
        dec = self.decoding
        for s in dec:
            need = len(self.slot_req[s].params.stop_set)
            while need > self._stop_width:
                self._stop_width *= 2
        stops = np.full((n, self._stop_width), -1, np.int32)
        for s in dec:
            r = self.slot_req[s]
            active[s] = True
            temps[s], top_ks[s] = r.params.temperature, r.params.top_k
            # & wraps a negative seed into the uint32 range, as the
            # reference does
            seeds[s], counts[s] = r.params.seed & 0xFFFFFFFF, len(r.out)
            max_new[s] = r.max_new
            stops[s] = stop_id_row(r.params, self._stop_width)
        # a host bool, known without a device sync: an all-greedy step
        # takes the argmax epilogue, launches no sampling and uploads no
        # sampling parameters
        sampled = bool((temps > 0).any())
        host = {"tok": self.last_tok, "pos": self.pos, "active": active,
                "counts": counts, "max_new": max_new, "stop_ids": stops}
        if sampled:
            host.update(temps=temps, top_ks=top_ks, seeds=seeds)
        if self.paged:
            host["tables"] = self._decode_tables()[:, :self._nb_live()]
        st = {k: torch.as_tensor(np.ascontiguousarray(v), device=dev)
              for k, v in host.items()}
        st["sampled"] = sampled
        self._dstate = self._state_extras(st)
        return self._dstate

    def _state_extras(self, st: Dict[str, Tensor]) -> Dict[str, Tensor]:
        """Extra per-slot device state the fused step needs (the mixture
        server adds its router weights)."""
        return st

    def _pick_args(self, req: Request):
        """``(temp, top_k, seed)`` (1,) device rows for a first-token pick
        (count 0: the pick is token 0), or () for a greedy request, whose
        pick is the argmax alone."""
        sp = req.params
        if sp.temperature <= 0:
            return ()
        dev = self.device
        return (torch.tensor([sp.temperature], dtype=torch.float32,
                             device=dev),
                torch.tensor([sp.top_k], dtype=torch.int32, device=dev),
                torch.tensor([sp.seed & 0xFFFFFFFF], dtype=torch.int64,
                             device=dev))

    def _new_cache(self, model: Model, experts: int = 0):
        """The zeroed serving cache: the paged pool or contiguous rows,
        with ``experts`` = K at axis 1 of every leaf for an expert
        stack."""
        if self.paged:
            return model.init_paged_cache(
                self.n_slots, self.allocator.n_blocks, self.block_size,
                self.cache_len, device=self.device, experts=experts)
        return model.init_cache(self.n_slots, self.cache_len,
                                device=self.device, experts=experts)

    def _advance_fused(self, dec: List[int], nxt: np.ndarray,
                       done: np.ndarray) -> List[Request]:
        """Host half of the fused step: record each decoding slot's token
        and retire the slots the device-side ``done`` bitmap flagged."""
        retired = []
        t = time.perf_counter()
        for slot in dec:
            req = self.slot_req[slot]
            req.record(int(nxt[slot]), t)
            self.pos[slot] += 1
            self.last_tok[slot] = nxt[slot]
            d = int(done[slot])
            if d:
                reason = DONE_REASONS[d]
                if reason != (req.reason_now() or "truncated"):
                    raise RuntimeError(
                        f"slot {slot}: device finish reason {reason} "
                        f"disagrees with the host's {req.reason_now()}")
                self._retire_from_slot(slot, req, reason)
                retired.append(req)
        return retired

    def _decode_step_fused(self) -> List[Request]:
        """One scheduler step: the fused decode of every decoding slot plus,
        when the budget allows, one prefill chunk — then ONE readback."""
        dec = self.decoding
        self._step_span = 1          # chunk and vanilla steps write one
        do_chunk = self.chunked and self._schedule_chunk()
        if not dec and not do_chunk:
            return []
        if do_chunk:
            slot, xc, start, length, cbt = self._chunk_args()
            pick = self._pick_args(self.slot_req[slot])
            if not dec:
                first = self._run_chunk_only(slot, xc, start, length, cbt,
                                             pick)
                return self._after_chunk_tok(
                    slot, length, lambda: int(first.cpu()[0]))
            self._grow_active()
            st = self._device_state()
            nxt, done, first = self._run_fused_chunk(st, slot, xc, start,
                                                     length, cbt, pick)
            host = torch.cat([nxt, done, first]).cpu().numpy()
            n = self.n_slots
            retired = self._advance_fused(dec, host[:n], host[n:2 * n])
            retired += self._after_chunk_tok(slot, length,
                                             lambda: int(host[2 * n]))
            return retired
        if self._can_spec:
            retired = self._decode_step_spec(dec)
            if retired is not None:
                return retired
            # the pool cannot cover the span this step: one vanilla token
        self._grow_active()
        st = self._device_state()
        nxt, done = self._run_fused(st)
        host = torch.stack([nxt, done]).cpu().numpy()
        return self._advance_fused(dec, host[0], host[1])

    # ------------------------------------------------------------------
    # Speculative decoding: drafts + one span verify
    # ------------------------------------------------------------------

    def _decode_step_spec(self, dec: List[int]) -> Optional[List[Request]]:
        """One speculative step, still one readback: reserve every decoding
        slot's span blocks, draft (on the host for n-gram; None when
        expert 0 drafts on the device), run the fused verify and advance
        each slot by its accepted run. None → the pool cannot cover the
        span; the caller takes the vanilla step (the trajectory is the
        same either way)."""
        span = self.spec_len
        if not self._grow_active_span(span):
            return None
        self._step_span = span       # widens the _nb_live horizon
        st = self._device_state()
        drafts = self._draft_tokens(dec) if self._ngram is not None else None
        toks, n_emit, done = self._run_verify(st, drafts)
        n = self.n_slots
        host = torch.cat([toks.reshape(-1), n_emit, done]).cpu().numpy()
        return self._advance_span(dec, host[:n * span].reshape(n, span),
                                  host[n * span:n * span + n],
                                  host[n * span + n:])

    def _draft_tokens(self, dec: List[int]) -> Tensor:
        """Host n-gram drafts, one row per slot; idle and mid-prefill rows
        stay zero (their writes land in the scratch block and the epilogue
        masks their outputs)."""
        drafts = np.zeros((self.n_slots, self.spec_len - 1), np.int32)
        drafts[dec] = self._ngram.propose_batch(
            [np.concatenate([self.slot_req[s].tokens,
                             np.asarray(self.slot_req[s].out, np.int32)])
             for s in dec])
        return torch.as_tensor(drafts, device=self.device)

    def _run_verify(self, st, drafts):
        """One fused verify step; returns the device ``(toks, n_emit,
        done)`` and keeps the new cache and state. ``drafts`` is None when
        the verify step drafts on the device."""
        raise NotImplementedError

    def _advance_span(self, dec: List[int], toks: np.ndarray,
                      n_emit: np.ndarray, done: np.ndarray
                      ) -> List[Request]:
        """Host half of the speculative step: record each decoding slot's
        accepted run (1..spec_len tokens) and retire the slots the device
        ``done`` bitmap flagged. The device already cut each span at its
        first stop, budget or context halt, so a request finishing
        mid-span records nothing past its last token and retires once."""
        retired = []
        t = time.perf_counter()
        for slot in dec:
            req = self.slot_req[slot]
            n = int(n_emit[slot])
            for j in range(n):
                req.record(int(toks[slot, j]), t)
            self.pos[slot] += n
            if n:
                self.last_tok[slot] = toks[slot, n - 1]
            self.n_spec_steps += 1
            self.n_spec_tokens += n
            d = int(done[slot])
            if d:
                reason = DONE_REASONS[d]
                if reason != (req.reason_now() or "truncated"):
                    raise RuntimeError(
                        f"slot {slot}: device finish reason {reason} "
                        f"disagrees with the host's {req.reason_now()}")
                self._retire_from_slot(slot, req, reason)
                retired.append(req)
        return retired

    # ------------------------------------------------------------------
    # Chunked prefill
    # ------------------------------------------------------------------

    def _admit_chunked(self, req: Request, slot: int, width: int,
                       prep) -> bool:
        """Reserve the whole prompt's blocks, embed it, pre-split it into
        per-chunk tensors and park the slot mid-prefill. False → the pool
        can't reserve right now."""
        if not self._reserve(slot, width):
            return False
        pad = -width % self.chunk     # the token row pads; x is width + pad
        x, carry = prep(req.batch(self.device,
                                  pad_to=len(req.tokens) + pad))
        self.slot_req[slot] = req
        self.prefilling[slot] = True
        self.prefill_pos[slot] = 0
        self.prefill_width[slot] = width
        self.prefill_x[slot] = x.split(self.chunk, dim=1)
        self.prefill_carry[slot] = carry
        self.prefill_order.append(slot)
        self.pos[slot] = 0
        self.last_tok[slot] = 0
        self._dstate = None          # table masking changed for this slot
        return True

    def _decode_tables(self) -> np.ndarray:
        """Block tables as the decode dispatch sees them: mid-prefill slots
        masked to the scratch block."""
        if not self.prefill_order:
            return self.block_tables
        bt = self.block_tables.copy()
        bt[self.prefill_order] = 0
        return bt

    def _nb_live(self) -> int:
        """Logical-block horizon of the decode dispatch: the tables are cut
        to the block of ``max(pos)`` plus the positions the step writes
        past it (``_step_span - 1`` on a speculative step); no slot
        attends past it. A ring addresses its whole span and is never
        cut."""
        if self.ring:
            return self.nb_slot
        mx = int(self.pos.max(initial=0)) + self._step_span - 1
        return min(mx // self.block_size + 1, self.nb_slot)

    def _schedule_chunk(self) -> bool:
        if not self.prefill_order:
            return False
        n_dec = len(self.decoding)
        return n_dec == 0 or n_dec + self.chunk <= self.token_budget

    def _chunk_args(self):
        """(slot, x_chunk, start, length, block_table) of the FCFS head of
        the mid-prefill slots."""
        slot = self.prefill_order[0]
        start = int(self.prefill_pos[slot])
        length = min(self.chunk, int(self.prefill_width[slot]) - start)
        xc = self.prefill_x[slot][start // self.chunk]
        cbt = torch.as_tensor(self.block_tables[slot], device=self.device)
        return slot, xc, start, length, cbt

    def _after_chunk_tok(self, slot: int, length: int,
                         first_fn) -> List[Request]:
        """Advance a slot's prefill by one chunk; on the final chunk take
        the first token from ``first_fn``, splice the carry's direct-leaf
        state into the batched cache and move the slot to decode (or retire
        it: context-filling prompts, max_new == 1, a stop token)."""
        self.n_chunks += 1
        self.prefill_pos[slot] += length
        if int(self.prefill_pos[slot]) < int(self.prefill_width[slot]):
            return []
        req = self.slot_req[slot]
        first = int(first_fn())
        width = int(self.prefill_width[slot])
        self.prefill_order.remove(slot)
        self.prefilling[slot] = False
        self.prefill_x[slot] = None
        carry, self.prefill_carry[slot] = self.prefill_carry[slot], None
        if width >= self.cache_len:      # prompt fills the context bound
            req.record(first)
            self._retire_from_slot(slot, req,
                                   req.reason_now() or "truncated")
            return [req]
        # the carry's direct leaves (recurrent state) become the slot's
        self.cache = self.spec.insert_direct(self.cache, carry, slot)
        self._occupy(slot, req, first, width)
        reason = req.reason_now()        # max_new == 1, or first tok stops
        if reason:
            self._retire_from_slot(slot, req, reason)
            return [req]
        return []

    def stats(self) -> Dict[str, Any]:
        out = {"active": len(self.active), "waiting": len(self.waiting),
               "aborted": self.n_aborted, "stopped": self.n_stopped,
               "prefill_chunks": self.n_chunks}
        if self.paged:
            out["pool_free_blocks"] = self.allocator.n_free
            out["pool_blocks"] = self.allocator.n_blocks
        if self.speculative is not None:
            out["spec_steps"] = self.n_spec_steps
            out["spec_tokens"] = self.n_spec_tokens
            out["spec_tokens_per_step"] = (
                self.n_spec_tokens / self.n_spec_steps
                if self.n_spec_steps else 0.0)
        return out


def make_chunk_fns(model: Model, cache_len: int):
    """Admission prep for chunked prefill: embed the padded prompt and build
    the carry (the port's chunk steps live in ``make_fused_fns``)."""
    def prep(p, b):
        return model.embed_prompt(p, b), model.init_chunk_carry(p, b,
                                                                cache_len)
    return prep


def make_fused_fns(model: Model, cache_len: int, *, paged: bool):
    """``(step, step_chunk, chunk_only)`` — plain functions one SlotServer
    runs on (shared by the pods of a top-1 deployment); the chunk steps
    run on the paged pool only:

    * ``step(params, cache, state)`` → ``(cache, state, next_tok, done)``;
    * ``step_chunk(params, cache, state, carry, xc, start, length, cbt,
      temp, top_k, seed)`` → the same plus ``first`` (the chunk's
      first-token pick: count 0 of the request's seeded stream, or the
      argmax when ``temp, top_k, seed`` are left out) and the carry — the
      decode and one prefill chunk in one step;
    * ``chunk_only(params, cache, carry, xc, start, length, cbt, temp,
      top_k, seed)`` → ``(first, carry, cache)`` when nothing is
      decoding.
    """
    def step(p, c, st):
        return model.fused_decode_step(p, c, st, cache_len=cache_len,
                                       paged=paged)

    def step_chunk(p, c, st, carry, xc, start, ln, cbt, *pick):
        c, st, nxt, done = model.fused_decode_step(p, c, st,
                                                   cache_len=cache_len,
                                                   paged=True)
        c_out, carry, c = model.prefill_chunk(p, c, carry, xc, start, ln, cbt)
        return c, st, nxt, done, pick_first(c_out, *pick), carry

    def chunk_only(p, c, carry, xc, start, ln, cbt, *pick):
        c_out, carry, c = model.prefill_chunk(p, c, carry, xc, start, ln, cbt)
        return pick_first(c_out, *pick), carry, c

    return step, step_chunk, chunk_only


def make_verify_fns(model: Model, cache_len: int):
    """The speculative verify step a SlotServer runs on:
    ``verify(params, cache, state, drafts)``
    → ``(cache, state, toks, n_emit, done)``, the span forward over
    ``[committed token, drafts]`` plus the accept/reject epilogue
    (``Model.fused_verify_step``)."""
    def verify(p, c, st, drafts):
        return model.fused_verify_step(p, c, st, drafts, cache_len=cache_len)
    return verify


class SlotServer(_SlotTable):
    """Continuous batching over ONE expert with the fused decode step.
    ``config.paged`` puts the KV cache in a pool of
    ``page_block``-position blocks (``pool_blocks`` of them, 0 → full
    capacity) instead of contiguous per-slot rows; ``config.
    chunked_prefill`` (paged only) consumes prompts ``chunk`` positions per
    step instead of prefilling each whole at admission; ``config.
    speculative="ngram"`` (paged only) verifies ``spec_len``-position
    spans on decode-only steps."""

    def __init__(self, model: Model, params, *, config: EngineConfig,
                 device="cuda", fused_fns=None):
        super().__init__(model, config, device)
        self.model, self.params = model, params
        self.cache = self._new_cache(model)
        self.spec = model.cache_spec(self.block_size)
        self._prep = make_chunk_fns(model, self.cache_len)
        self._fstep, self._fstep_chunk, self._fchunk_only = \
            fused_fns or make_fused_fns(model, self.cache_len,
                                        paged=self.paged)
        self._init_speculation(config, model,
                               make_verify_fns(model, self.cache_len))

    def admit(self, req: Request) -> bool:
        """Admit a request into a free slot. Chunked: reserve its blocks
        and park the slot mid-prefill. Monolithic: prefill the whole prompt
        (``Model.prefill``), pick its first token, and splice its cache into
        the slot — or retire it at once when the prompt fills the context.
        False when no slot, or (paged) not enough free blocks."""
        free = self.free_slots()
        if not free:
            return False
        slot, width = free[0], self._prefill_width(req)
        if self.chunked:
            return self._admit_chunked(req, slot, width,
                                       lambda b: self._prep(self.params, b))
        if not self._admission_precheck(req, slot, width):
            return False
        logits, row_cache = self.model.prefill(
            self.params, req.batch(self.device), self.cache_len)
        first = int(pick_first(logits[0, -1:],
                               *self._pick_args(req)).cpu()[0])
        if width == self.cache_len:
            self._retire_at_admission(req, first)
            return True
        self._admit_prefilled(slot, req, first, width, row_cache)
        return True

    def _run_fused(self, st):
        self.cache, self._dstate, nxt, done = self._fstep(
            self.params, self.cache, st)
        return nxt, done

    def _run_verify(self, st, drafts):
        self.cache, self._dstate, toks, n_emit, done = self._vstep(
            self.params, self.cache, st, drafts)
        return toks, n_emit, done

    def _run_fused_chunk(self, st, slot, xc, start, length, cbt, pick):
        (self.cache, self._dstate, nxt, done, first,
         self.prefill_carry[slot]) = self._fstep_chunk(
            self.params, self.cache, st, self.prefill_carry[slot], xc,
            start, length, cbt, *pick)
        return nxt, done, first

    def _run_chunk_only(self, slot, xc, start, length, cbt, pick):
        first, self.prefill_carry[slot], self.cache = self._fchunk_only(
            self.params, self.cache, self.prefill_carry[slot], xc, start,
            length, cbt, *pick)
        return first


class MixtureSlotServer(_SlotTable):
    """Continuous batching over the stacked expert ensemble (port of
    ``repro.serve.scheduler.MixtureSlotServer``): one cache carrying the
    expert (K) dim at axis 1 of every leaf, one stacked decode step per
    scheduler step with the Eq. 27 mixture and the serving epilogue fused
    in (``core.ensemble.make_stacked_fused``), and per-slot router weights
    fixed at admission. Speculation verifies the span on the whole stack
    at once (``core.ensemble.make_stacked_verify``), drafted by the
    host's n-gram lookup or by expert 0 on the device. In the paged layout the pool carries the K dim too,
    and all K experts of a slot share ONE block table. A request is routed
    when admission pays for its prefill: after its blocks are reserved, so
    a request blocked on free KV blocks does not run the router again each
    retry."""

    def __init__(self, model: Model, expert_params: List[Any], router, *,
                 config: EngineConfig, device="cuda"):
        super().__init__(model, config, device)
        self.model, self.router = model, router.to(self.device)
        self.K = len(expert_params)
        self.stacked = stack_experts_for_decode(
            [tree_map(lambda t: t.to(self.device), p)
             for p in expert_params])
        self.cache = self._new_cache(model, experts=self.K)
        self.spec = model.cache_spec(self.block_size).shifted(1)
        self.weights = np.zeros((self.n_slots, self.K), np.float32)
        self._prep = make_chunk_fns(model, self.cache_len)
        self._fstep, self._fstep_chunk, self._fchunk_only = \
            make_stacked_fused(model, self.cache_len, paged=self.paged)
        self._init_speculation(
            config, model,
            make_stacked_verify(model, self.cache_len, config.spec_len))

    def _route(self, req: Request) -> np.ndarray:
        """The request's (K,) top-k-filtered Eq. 28 weights: one router
        launch, read back once (the host keeps the weights mirror)."""
        feats = torch.as_tensor(np.asarray(req.features, np.float32)[None],
                                device=self.device)
        return self.router.route(
            feats.to(self.router.centroids.dtype)).float().cpu().numpy()[0]

    def admit(self, req: Request) -> bool:
        """Admit a request into a free slot, as ``SlotServer.admit`` does,
        over the expert stack: chunked, reserve its blocks, park the slot
        mid-prefill and route it; monolithic, prefill it on every expert,
        route it and pick its first token (the request's own sampling
        parameters, count 0) from the Eq. 27 mixture of the experts' last
        rows."""
        free = self.free_slots()
        if not free:
            return False
        if req.features is None:
            raise ValueError("mixture admission routes on request features")
        slot, width = free[0], self._prefill_width(req)
        if self.chunked:
            if not self._admit_chunked(
                    req, slot, width, lambda b: self._prep(self.stacked, b)):
                return False
            self.weights[slot] = self._route(req)
            return True
        if not self._admission_precheck(req, slot, width):
            return False
        w = self._route(req)
        logits, row_cache = self.model.prefill(
            self.stacked, req.batch(self.device), self.cache_len)
        probs = mix_expert_logits(logits[:, :, -1], torch.as_tensor(
            w[None], device=self.device))                       # (1, V)
        first = int(pick_first(probs, *self._pick_args(req),
                               from_probs=True).cpu()[0])
        if width == self.cache_len:
            self._retire_at_admission(req, first)
            return True
        self.weights[slot] = w
        self._admit_prefilled(slot, req, first, width, row_cache)
        return True

    def _state_extras(self, st):
        st["weights"] = torch.as_tensor(self.weights, device=self.device)
        return st

    def _weights_row(self, slot: int) -> Tensor:
        return torch.as_tensor(self.weights[slot:slot + 1],
                               device=self.device)

    def _run_fused(self, st):
        self.cache, self._dstate, nxt, done = self._fstep(
            self.stacked, self.cache, st)
        return nxt, done

    def _run_verify(self, st, drafts):
        self.cache, self._dstate, toks, n_emit, done = self._vstep(
            self.stacked, self.cache, st, drafts)
        return toks, n_emit, done

    def _run_fused_chunk(self, st, slot, xc, start, length, cbt, pick):
        (self.cache, self._dstate, nxt, done, first,
         self.prefill_carry[slot]) = self._fstep_chunk(
            self.stacked, self.cache, st, self.prefill_carry[slot], xc,
            start, length, cbt, self._weights_row(slot), *pick)
        return nxt, done, first

    def _run_chunk_only(self, slot, xc, start, length, cbt, pick):
        first, self.prefill_carry[slot], self.cache = self._fchunk_only(
            self.stacked, self.cache, self.prefill_carry[slot], xc, start,
            length, cbt, self._weights_row(slot), *pick)
        return first


class DecentralizedSlotServer:
    """Front-end centroid router over continuously batched expert pods.

    strategy="top1"    — one ``SlotServer`` per expert; the router runs at
                         submission and each request decodes on exactly
                         the expert it assigns.
    strategy="mixture" — one ``MixtureSlotServer`` (``core``, and the only
                         entry of ``pods``) over the stacked experts; the
                         router runs at admission.
    """

    def __init__(self, model: Model, expert_params: List[Any], router, *,
                 config: EngineConfig, device="cuda"):
        config.validate(model)
        self.config = config
        self.device = resolve_device(device)
        self.model = model
        self.router = router.to(self.device)
        self.K = len(expert_params)
        if self.K != router.K:
            raise ValueError(f"{self.K} experts but the router has "
                             f"{router.K} centroids")
        self.strategy = config.strategy
        self._next_rid = 0
        if self.strategy == "mixture":
            self.core = MixtureSlotServer(model, expert_params, self.router,
                                          config=config, device=self.device)
            self.pods = [self.core]
            return
        fns = make_fused_fns(model, config.cache_len, paged=config.paged)
        self.pods = [SlotServer(model,
                                tree_map(lambda t: t.to(self.device), p),
                                config=config, device=self.device,
                                fused_fns=fns)
                     for p in expert_params]

    def _features(self, feats: np.ndarray) -> Tensor:
        return torch.as_tensor(np.asarray(feats, np.float32),
                               device=self.device).to(
                                   self.router.centroids.dtype)

    def route(self, queue: List[Request]) -> np.ndarray:
        """Top-1 pod of each request, one batched router launch."""
        feats = np.stack([r.features for r in queue])
        return self.router.top1(self._features(feats)).cpu().numpy()

    def add_request(self, prompt, params: Optional[SamplingParams] = None,
                    extras: Optional[Dict[str, np.ndarray]] = None, *,
                    features: Optional[np.ndarray] = None,
                    rid: Optional[int] = None) -> int:
        """Submit a request with its modality ``extras``: the Eq. 28 router
        (B = 1) picks its pod (top-1), or the request joins the mixture
        core's queue and is routed at admission."""
        req = _as_request(prompt, params, extras, features,
                          self._next_rid if rid is None else rid)
        if req.features is None:
            raise ValueError(_FEATURES_MSG.format(rid=req.rid))
        self._next_rid = max(self._next_rid, req.rid + 1)
        # submission is now: the routing dispatch counts toward TTFT
        req.t_submit = req.t_submit or time.perf_counter()
        if self.strategy == "mixture":
            return self.core.add_request(req)
        k = int(self.router.top1(self._features(req.features[None])).cpu()[0])
        return self.pods[k].add_request(req)

    def step(self) -> List[RequestOutput]:
        """One step of every pod, in pod order."""
        outs: List[RequestOutput] = []
        for pod in self.pods:
            outs += pod.step()
        return outs

    def abort(self, rid: int) -> Optional[RequestOutput]:
        for pod in self.pods:
            out = pod.abort(rid)
            if out is not None:
                return out
        return None

    def has_unfinished(self) -> bool:
        return any(pod.has_unfinished() for pod in self.pods)

    def occupancy(self) -> List[Dict[str, Any]]:
        return [p.stats() for p in self.pods]


def make_engine(model: Model, params: Any = None, *,
                experts: Optional[List[Any]] = None, router=None,
                config: Optional[EngineConfig] = None, device="cuda"):
    """Build the serving engine from ONE validated ``EngineConfig``:
    ``make_engine(model, params, config=cfg)`` → a ``SlotServer``;
    ``make_engine(model, experts=[...], router=r, config=cfg)`` → the
    decentralized deployment, top-1 pods or (``strategy="mixture"``) the
    stacked Eq. 27 core. Runs on ``device`` (the card unless the caller
    passes ``device="cpu"``); params and router move there."""
    config = config if config is not None else EngineConfig()
    config.validate(model)
    if experts is not None:
        if router is None:
            raise ValueError(
                "decentralized serving routes on the centroid router — "
                "pass router= alongside experts=")
        return DecentralizedSlotServer(model, experts, router, config=config,
                                       device=device)
    if params is None:
        raise ValueError(
            "single-model serving needs the model's params (or pass "
            "experts= and router= for the decentralized deployment)")
    dev = resolve_device(device)
    return SlotServer(model, tree_map(lambda t: t.to(dev), params),
                      config=config, device=dev)
