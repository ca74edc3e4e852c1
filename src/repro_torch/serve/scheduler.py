"""Continuous batching (port of the §5.2 serving path of
``repro.serve.scheduler``).

``make_engine(model, experts=[...], router=r, config=cfg, device="cuda")``
builds the paper's decentralized deployment: the Eq. 28 centroid router
runs at submission on each request's features and sends it to its top-1
expert's pod, a ``SlotServer``. A pod admits requests into free slots
(FCFS with a bounded skip-ahead, or deficit round robin over tenants with
a ``QoSConfig``) and decodes every decoding slot in lockstep with the
fused step (``Model.fused_decode_step``), or with ``fused_step=False``
the reference's unfused one: the forward returns the scores and the host
epilogue picks from them (``_next_tokens``: ``serve.fused.argmax_tokens``
for an all-greedy step, else ``sample_tokens``), then checks stop ids,
budgets and the context bound on the host (``_advance``). Its KV state is
either contiguous per-slot cache rows or, with ``paged``, a shared pool of
blocks reached through per-slot block tables (a family with no pageable
leaves, ssm, keeps its per-slot states: ``effective_page_block`` is 0).
Its admission either prefills the whole prompt at once (``Model.prefill``,
then a splice into the slot's cache row or blocks) or, with
``chunked_prefill`` (paged, or a family with no pageable leaves), reserves
the prompt's blocks and consumes it ``chunk`` positions per step
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

The serving host layer rides on those paths:

* ``prefix_cache`` (paged + chunked): the radix prefix cache
  (``serve.prefix_cache``) maps a prompt's cached full blocks read-only
  into its table and starts its chunked prefill at the first uncached
  position; the hybrid family, whose recurrent state is not in the pool,
  takes the uncached path (``Model.prefix_cacheable``).
* ``preemption`` (paged): under pool pressure a strictly lower-priority
  request is parked — ``"swap"`` moves its private blocks' contents to
  host memory (``CacheSpec.swap_out``) and scatters them back into fresh
  blocks at resume, ``"recompute"`` drops them and replays prompt plus
  output through chunked prefill. A resumed request's tokens are the ones
  it would have produced unparked.
* ``qos`` (``serve.qos``): tenant fair shares, admission control
  (``finish_reason="rejected"``) and the per-tenant breakdown of
  ``stats()``.
* telemetry (``obs``): every engine's private metrics registry (always
  on; ``stats()`` is a view over it), span tracing with ``trace=True``
  and the pod step's phases (``admit``, ``prepare``, the dispatch's
  ``decode_dispatch`` and ``chunk_dispatch`` halves, ``device_get``,
  ``finish``; ``EngineObs.step_begin``), taken with no device
  synchronisation of their own and named as ``repro.serve.<phase>``
  ranges while a ``torch.profiler`` records; ``sanitize=True`` shadows
  the pool with the ``analysis.sanitizer.PoolSanitizer``.
* ``serve(queue, max_steps=...)``: the drain loop over the incremental
  API.

With ``strategy="mixture"`` the deployment is one ``MixtureSlotServer``
instead of the pods: the K experts stacked on one tensor dim
(``core.ensemble``), every request routed at admission to an (n_slots,
K) row of router weights, and each step one stacked forward whose K
experts' next-token distributions are mixed by Eq. 27 before the pick,
in each of the three configurations above. Its speculation verifies the
span on all K experts in one stacked forward, with n-gram drafts or
(``speculative="expert"``) drafts from expert 0's own greedy decode on
the device (``core.ensemble.make_stacked_verify``). Its one prefix cache
and its parks cover the K stacked experts at once: the pool carries K at
axis 1, and expert k's table is offset by k·P.

**The single-dispatch contract.** Each fused step is one forward (decode
or span verify, plus at most one prefill chunk beside a decode) and its
on-device epilogue, followed by ONE host readback: ``(next_tok, done)``,
or ``(toks, n_emit, done)`` for a verify — plus the chunk's first token
on a prompt's final chunk, read in the same transfer. A monolithic
admission reads back its first token once, a swap park its payload once.
The per-slot device state is rebuilt from the host mirrors only on
admission, retirement, park, resume or block-table growth. No ``.item()``
sits in the layer loop. The unfused step uploads the tokens, positions
and tables each step and reads back the picked tokens, and a final
chunk's first token in a second readback, as the reference does. Both
steps record the registry's ``dispatch`` / ``device_get`` split
(``EngineObs.phase``, ``EngineObs.step_timing``).
"""
from __future__ import annotations

import json
import logging
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.analysis.sanitizer import PoolSanitizer
from repro_torch.core.ensemble import (make_stacked_chunk_fns,
                                       make_stacked_fused,
                                       make_stacked_serving,
                                       make_stacked_verify,
                                       mix_expert_logits)
from repro_torch.device import resolve_device
from repro_torch.models.model import Model
from repro_torch.obs import metrics as _obs_metrics
from repro_torch.obs.engine import SERVE_RANGE, EngineObs, host_range
from repro_torch.obs.trace import ADMIT_TID, merge_chrome
from repro_torch.serve.api import (EngineConfig, RequestOutput,
                                   SamplingParams, TokenDelta,
                                   effective_page_block, stop_id_row)
from repro_torch.serve.fused import (DONE_REASONS, argmax_tokens,
                                     pick_first, sample_tokens,
                                     sample_tokens_probs)
from repro_torch.serve.prefix_cache import PrefixCache, block_keys
from repro_torch.serve.qos import (DEFAULT_ADMIT_LOOKAHEAD, ParkedState,
                                   TenantScheduler, predict_ttft,
                                   priority_of, tenant_of)
from repro_torch.serve.speculate import NGramProposer
from repro_torch.tree import tree_map

Tensor = torch.Tensor

logger = logging.getLogger(__name__)


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
    #                             # (vlm), "frames" (audio)
    params: Optional[SamplingParams] = None
    out: List[int] = field(default_factory=list)
    finish_reason: Optional[str] = None
    t_submit: float = 0.0
    t_admit: float = 0.0
    t_first: float = 0.0
    t_done: float = 0.0
    t_tok: List[float] = field(default_factory=list)
    emitted: int = 0
    spec_req_steps: int = 0       # this request's speculative verify steps
    spec_req_accepted: int = 0    # draft tokens those steps accepted
    preemptions: int = 0          # times this request was parked/requeued
    resuming: bool = False        # parked by recompute: the next admission
    #                             # re-prefills prompt + output

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

    @property
    def prefill_tokens(self) -> np.ndarray:
        """Token ids a (re-)prefill consumes: the prompt, or for a
        recompute-parked request's resume the prompt plus all but its last
        output token (that one is the next decode input)."""
        if self.resuming and len(self.out) > 1:
            return np.concatenate(
                [self.tokens, np.asarray(self.out[:-1], np.int32)])
        return self.tokens

    def batch(self, device, pad_to: int = 0) -> Dict[str, Tensor]:
        """Single-row prefill batch (``prefill_tokens`` + modality extras,
        each with a leading batch dim), the token row right-padded to
        ``pad_to`` (padded rows are masked by the chunk length)."""
        toks = self.prefill_tokens
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


def _raise_dropped(dropped: List[str], n_finished: int,
                   max_steps: int) -> None:
    """A drain loop that ran out of steps with unfinished requests never
    drops them silently: log each one's progress, then raise."""
    logger.error(
        "serve() exhausted max_steps=%d: dropping %d unfinished "
        "request(s) %s (%d finished)", max_steps, len(dropped), dropped,
        n_finished)
    raise RuntimeError(
        f"serve() exhausted max_steps={max_steps} with {len(dropped)} "
        f"request(s) {dropped} unfinished — raise max_steps or shrink "
        f"budgets")


def _drain(engine, queue: List[Request], max_steps: int
           ) -> Dict[int, List[int]]:
    """The drain loop of ``serve``: reset the run counters, submit the
    queue, step until nothing is unfinished and collect the finished
    outputs; raise (``_raise_dropped``) when ``max_steps`` runs out."""
    engine.reset_stats()
    for req in queue:
        engine.add_request(req)
    finished: Dict[int, List[int]] = {}
    reasons: Dict[int, str] = {}
    for _ in range(max_steps):
        for out in engine.step():
            if out.finished:
                finished[out.rid] = out.token_ids
                reasons[out.rid] = out.finish_reason
        if not engine.has_unfinished():
            break
    tables = engine._engines()
    dropped = [f"{r.rid} (queued)" for t in tables for r in t.waiting] + \
        [d for t in tables for d in t._drop_details()]
    if dropped:
        _raise_dropped(dropped, len(finished), max_steps)
    logger.info("serve: %d finished (finish_reasons %s), stats %s",
                len(finished), reasons, [t.stats() for t in tables])
    return finished


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
    slot reserves its whole ring of ``window`` positions at admission),
    and, as the config asks, the prefix cache, the preemption parks and
    the PoolSanitizer; with ``chunk > 0`` each step co-schedules one
    prefill chunk (FCFS over mid-prefill slots, or DRR over tenants with a
    ``QoSConfig``) with the lockstep decode of every decoding slot,
    subject to ``token_budget`` (decoding slots count 1 each, the chunk
    counts ``chunk``). ``pod`` labels its telemetry (the registry's
    ``pod`` label, the trace's pid)."""

    _needs_features = False       # the mixture core routes at admission
    _from_probs = False           # the mixture core's scores are Eq. 27
    #                             # probabilities

    def __init__(self, model: Model, config: EngineConfig, device,
                 pod: int = 0):
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
        self.fused = config.fused_step
        self.device = resolve_device(device)
        # multi-tenant QoS (serve.qos): None / "off" keeps FCFS with the
        # bounded admission skip-ahead
        qos = self.qos = config.qos
        self.preemption = config.preemption
        quantum = (qos.quantum if qos is not None and qos.quantum > 0
                   else (chunk if chunk > 0 else 16))
        self._drr_admit = TenantScheduler(qos, quantum)
        self._drr_chunk = TenantScheduler(qos, quantum)
        self._parked: Dict[int, ParkedState] = {}   # rid -> parked state
        self._chunk_pick: Optional[int] = None      # this step's chunk slot
        self._step_ewma = 0.0        # EWMA step() wall time (TTFT model)
        self._tenant_stats: Dict[str, Dict[str, int]] = {}
        # telemetry: the always-on registry (stats() is a view over it)
        # and the span recorder (a no-op unless config.trace)
        self.obs = EngineObs(pod=pod, trace=config.trace,
                             trace_ring=config.trace_ring,
                             publish=config.metrics)
        self.obs.name_tracks(n_slots, f"pod {self.obs.pod}")
        self.pos = np.zeros(n_slots, dtype=np.int32)      # next position
        self.slot_req: List[Optional[Request]] = [None] * n_slots
        self.last_tok = np.zeros(n_slots, dtype=np.int32)
        self.waiting: List[Request] = []
        self.admit_retired: List[Request] = []   # retired without decoding
        self._next_rid = 0
        self.n_chunks = 0          # prefill chunks consumed
        self.chunk = chunk
        self.chunked = chunk > 0
        self.token_budget = token_budget if token_budget > 0 \
            else n_slots + chunk
        self.prefilling = [False] * n_slots
        self.prefill_pos = np.zeros(n_slots, dtype=np.int32)
        self.prefill_base = np.zeros(n_slots, dtype=np.int32)  # cached run
        self.prefill_width = np.zeros(n_slots, dtype=np.int32)
        self.prefill_x: List[Any] = [None] * n_slots   # per-chunk tensors
        self.prefill_carry: List[Any] = [None] * n_slots
        self.prefill_keys: List[Any] = [None] * n_slots  # full-block keys
        self.prefill_order: List[int] = []
        self._dstate = None        # persistent per-slot device state
        self._tables_dirty = False
        self._stop_width = 1       # stop-id matrix width (monotone, pow2)
        self._step_span = 1        # positions the current step writes
        self.speculative = None    # set by _init_speculation
        self.spec_len = 1
        self._can_spec = False
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
            self.obs.pool_total_g.set(self.allocator.n_blocks)
            self.obs.pool_free_g.set(self.allocator.n_free)
            self.block_tables = np.zeros((n_slots, self.nb_slot), np.int32)
            self.n_alloc = np.zeros(n_slots, dtype=np.int32)
            self.block_gens = np.zeros((n_slots, self.nb_slot), np.int64)
        # validate() vetted the flags: prefix_cache means paged + chunked;
        # a family whose state is not in the pool takes the uncached path
        self.prefix: Optional[PrefixCache] = PrefixCache(
            self.allocator, block_size, registry=self.obs.registry) \
            if config.prefix_cache and model.prefix_cacheable else None
        self.sanitizer: Optional[PoolSanitizer] = \
            PoolSanitizer(self) if config.sanitize and self.paged else None
        if not self.paged:
            self.preemption = "off"

    def free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.slot_req) if r is None]

    # lifetime counters: views over the registry, so the exposition and
    # stats() never disagree
    @property
    def n_aborted(self) -> int:
        return self.obs.n_aborted

    @property
    def n_stopped(self) -> int:
        return self.obs.n_stopped

    @property
    def n_spec_steps(self) -> int:
        return self.obs.n_spec_steps

    @property
    def n_spec_tokens(self) -> int:
        return self.obs.n_spec_tokens

    @property
    def active(self) -> List[int]:
        return [i for i, r in enumerate(self.slot_req) if r is not None]

    @property
    def decoding(self) -> List[int]:
        return [i for i, r in enumerate(self.slot_req)
                if r is not None and not self.prefilling[i]]

    def _engines(self) -> List["_SlotTable"]:
        return [self]

    # ------------------------------------------------------------------
    # The incremental request-lifecycle API
    # ------------------------------------------------------------------

    def add_request(self, prompt, params: Optional[SamplingParams] = None,
                    extras: Optional[Dict[str, np.ndarray]] = None, *,
                    features: Optional[np.ndarray] = None,
                    rid: Optional[int] = None) -> int:
        """Submit a prompt (token ids) with its modality ``extras`` (a vlm
        request's ``"patches"``, (n_patches, vision_dim); an audio
        request's ``"frames"``, (n_audio_frames, audio_dim)) — or a prebuilt
        ``Request`` — to the waiting queue and return its rid. Never
        dispatches device work. A request no capacity could ever admit
        raises ValueError here; one admission control sheds retires with
        ``finish_reason="rejected"`` at the next ``step()``."""
        req = _as_request(prompt, params, extras, features,
                          self._next_rid if rid is None else rid)
        if self._needs_features and req.features is None:
            raise ValueError(_FEATURES_MSG.format(rid=req.rid))
        self._reject_unservable(req)
        self._next_rid = max(self._next_rid, req.rid + 1)
        req.t_submit = req.t_submit or time.perf_counter()
        self.obs.submitted.inc()
        if self.qos is not None:
            why = self._admission_control(req)
            if why is not None:
                self._finish_rejected(req, why)
                return req.rid
        self.waiting.append(req)
        return req.rid

    def _admission_control(self, req: Request) -> Optional[str]:
        """Load shedding at submission (``QoSConfig``): None → accept;
        else the reason to reject. The predicted TTFT is first order:
        every prompt token queued or still prefilling ahead of the arrival
        flows through the per-step chunk at the EWMA step time."""
        q = self.qos
        if q.max_waiting and len(self.waiting) >= q.max_waiting:
            return (f"queue depth {len(self.waiting)} at the "
                    f"max_waiting={q.max_waiting} bound")
        if q.max_predicted_ttft_s > 0 and self.chunked \
                and self._step_ewma > 0:
            backlog = sum(self._prefill_width(r) for r in self.waiting)
            backlog += sum(
                int(self.prefill_width[s] - self.prefill_pos[s])
                for s in self.prefill_order)
            eta = predict_ttft(backlog + self._prefill_width(req),
                               self.chunk, self._step_ewma)
            if eta > q.max_predicted_ttft_s:
                return (f"predicted TTFT {eta:.3f}s over the "
                        f"max_predicted_ttft_s={q.max_predicted_ttft_s} "
                        f"SLO ({backlog} backlog tokens)")
        return None

    def _finish_rejected(self, req: Request, why: str) -> None:
        """Retire a shed submission without a slot (zero tokens); its
        terminal output streams from the next ``step()``."""
        logger.info("reject request %d (tenant %s): %s", req.rid,
                    tenant_of(req), why)
        req.t_done = time.perf_counter()
        self._set_reason(req, "rejected")
        tenant = tenant_of(req)
        self._tenant(tenant)["rejections"] += 1
        self.obs.rejected(tenant).inc()
        self._obs_retired(None, req)
        self.admit_retired.append(req)

    def _tenant(self, tenant: str) -> Dict[str, int]:
        st = self._tenant_stats.get(tenant)
        if st is None:
            st = {"tokens": 0, "preemptions": 0, "resumes": 0,
                  "rejections": 0}
            self._tenant_stats[tenant] = st
        return st

    def _reject_unservable(self, req: Request) -> None:
        """Fail at submission on a request no idle server could admit."""
        width = self._prefill_width(req)
        self._reject_overlong(req, width)
        # a monolithic context-filling prompt retires at admission without
        # reserving; every other paged admission reserves the whole prompt
        # (prefix-shared blocks live in the same pool: sharing cannot
        # shrink the need below the table's span)
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
        """Decoder positions a request's prefill consumes: its
        ``prefill_tokens`` (a recompute resume's output too), plus the vlm
        family's image prefix of ``n_patches`` rows."""
        cfg = self.model.cfg
        return len(req.prefill_tokens) + (cfg.n_patches
                                          if cfg.family == "vlm" else 0)

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
        obs = self.obs
        obs.step_begin()
        try:
            self._chunk_pick = None  # this step's chunk pick, not made yet
            self._admit_waiting()
            finished, self.admit_retired = self.admit_retired, []
            if self.active:
                obs.phase("prepare")
                if self.sanitizer is not None:
                    self.sanitizer.begin_step()
                finished += self._decode_step()
                if self.sanitizer is not None:
                    self.sanitizer.check_step()
            obs.phase("finish")      # none where the readback began it
            outs = [self._output(r) for r in finished]
            for req in self.slot_req:
                if req is not None and req.emitted < len(req.out):
                    outs.append(self._output(req))
            self._obs_step()
        except BaseException:
            obs.abort_step()
            raise
        # the EWMA step time feeds the admission-control TTFT model
        dt = obs.step_end()
        self._step_ewma = dt if self._step_ewma == 0.0 \
            else 0.9 * self._step_ewma + 0.1 * dt
        return outs

    def abort(self, rid: int) -> Optional[RequestOutput]:
        """Cancel a request wherever it is (queued, parked, mid-prefill or
        mid-decode); frees its slot and blocks and drops its prefix-cache
        references and parked state. None for an unknown or finished
        rid."""
        for i, req in enumerate(self.waiting):
            if req.rid == rid:
                self.waiting.pop(i)
                parked = self._parked.pop(rid, None)
                if parked is not None:
                    self._drop_parked(parked)
                    if self.sanitizer is not None:
                        self.sanitizer.check_pool()
                return self._finish_aborted(req)
        for slot, req in enumerate(self.slot_req):
            if req is None or req.rid != rid:
                continue
            if self.prefilling[slot]:
                self._clear_prefill(slot)
            self._release(slot)
            if self.sanitizer is not None:
                self.sanitizer.check_pool()
            return self._finish_aborted(req)
        return None

    def has_unfinished(self) -> bool:
        return bool(self.waiting) or bool(self.active)

    def _finish_aborted(self, req: Request) -> RequestOutput:
        req.finish_reason = "aborted"
        req.t_done = time.perf_counter()
        obs = self.obs
        obs.aborted.inc()
        self._account_retired(req)
        tr = obs.trace
        if tr.enabled:
            slot = getattr(req, "_obs_slot", None)
            tid = obs.slot_tid(slot) if slot is not None else ADMIT_TID
            t0 = getattr(req, "_obs_t_phase", 0.0)
            if t0:                  # close the phase the abort interrupted
                tr.complete(getattr(req, "_obs_phase", "decode"), t0,
                            req.t_done, tid, args={"rid": req.rid})
            elif req.t_admit == 0.0:   # aborted straight out of the queue
                tr.async_begin("queued", req.t_submit, req.rid)
                tr.async_end("queued", req.t_done, req.rid)
            tr.instant("abort", req.t_done, tid, args={"rid": req.rid})
        return self._output(req)

    def _admit_waiting(self) -> None:
        """Admission from the waiting queue: FCFS with a bounded
        skip-ahead (``DEFAULT_ADMIT_LOOKAHEAD``) past a head the pool
        cannot take yet, or with a ``QoSConfig`` deficit round robin
        between tenants (FCFS within each). A request even an idle server
        cannot admit raises, after the parked requests' pins are released
        once."""
        if self.qos is None:
            self._admit_fcfs()
        else:
            self._admit_drr()
        if self.waiting and not self.active:
            req = self.waiting[0]
            if self._parked and self._unpin_parked():
                t0 = time.perf_counter()
                if self._try_admit(req):
                    self._dequeue(req)
                    self._on_admitted(req, t0)
                    return
            raise RuntimeError(
                f"cannot admit request {req.rid} even on an "
                f"idle server — the KV block pool is too small for it")

    def _dequeue(self, req: Request) -> None:
        # identity scan: Request.__eq__ compares ndarray fields
        i = next(i for i, r in enumerate(self.waiting) if r is req)
        self.waiting.pop(i)

    def _admit_fcfs(self) -> None:
        while self.waiting and self.free_slots():
            for i in range(min(len(self.waiting), DEFAULT_ADMIT_LOOKAHEAD)):
                req = self.waiting[i]
                t0 = time.perf_counter()
                if self._try_admit(req):
                    self._dequeue(req)
                    self._on_admitted(req, t0)
                    break            # restart the scan from the head
            else:
                break                # wait for blocks to free up

    def _admit_drr(self) -> None:
        """DRR admission: each round offers every tenant's head request at
        the cost of its prefill width; a tenant whose head cannot be
        admitted now is refunded and stood aside for this step."""
        blocked: set = set()
        while self.waiting and self.free_slots():
            heads: Dict[str, Request] = {}
            for r in self.waiting:
                t = tenant_of(r)
                if t not in heads and t not in blocked:
                    heads[t] = r
            if not heads:
                break
            cand = {t: self._prefill_width(r) for t, r in heads.items()}
            pick = self._drr_admit.pick(cand)
            req = heads[pick]
            t0 = time.perf_counter()
            if not self._try_admit(req):
                self._drr_admit.refund(pick, cand[pick])
                blocked.add(pick)
                continue
            self._dequeue(req)
            self._on_admitted(req, t0)

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
    # Preemption: park / resume over the paged pool (serve.qos)
    # ------------------------------------------------------------------

    def _try_admit(self, req: Request) -> bool:
        """One admission attempt: a swap-parked request resumes by
        swap-in (no prefill), anything else (a recompute resume re-enters
        chunked prefill over prompt + output) through ``admit``. On pool
        pressure, with preemption on, park one strictly lower-priority
        victim and retry until the request fits or no victim is left."""
        parked = self._parked.get(req.rid)
        while True:
            if parked is not None and parked.mode == "swap":
                ok = self._admit_swapped(parked)
            else:
                ok = self.admit(req)
            if ok:
                if parked is not None and parked.mode == "recompute":
                    # the resume's prefix match re-acquired what it still
                    # shares; the park's pin is redundant now
                    self._parked.pop(req.rid, None)
                    if self.prefix is not None:
                        for b in parked.pinned:
                            self.prefix.release(b)
                    parked.pinned = ()
                return True
            if self.preemption == "off":
                return False
            victim = self._pick_victim(priority_of(req))
            if victim is None:
                return False
            self._preempt(victim)

    def _pick_victim(self, floor: int,
                     exclude: Tuple[Optional[int], ...] = ()
                     ) -> Optional[int]:
        """Slot of the best victim with priority strictly below ``floor``:
        lowest priority first, youngest admission first among equals.
        Mid-prefill slots are eligible; under recompute a decoding victim
        whose resume could never fit the pool again is skipped."""
        best, best_key = None, None
        usable = self.allocator.n_blocks - 1 if self.paged else 0
        for slot in self.active:
            if slot in exclude:
                continue
            req = self.slot_req[slot]
            p = priority_of(req)
            if p >= floor:
                continue
            if self.preemption == "recompute" and not self.prefilling[slot]:
                need = -(-int(self.pos[slot]) // self.block_size)
                if min(need, self.nb_slot) > usable:
                    continue
            key = (p, -req.t_admit)
            if best_key is None or key < best_key:
                best, best_key = slot, key
        return best

    def _can_park(self, slot: int) -> bool:
        """A decoding slot may be parked only if its resume could ever be
        admitted again: always for swap, and for recompute if its whole
        position span fits the pool."""
        if self.preemption != "recompute" or self.prefilling[slot]:
            return True
        need = -(-int(self.pos[slot]) // self.block_size)
        return min(need, self.nb_slot) <= self.allocator.n_blocks - 1

    def _clear_prefill(self, slot: int) -> None:
        """Drop a mid-prefill slot's chunk state (abort, requeue)."""
        self.prefill_order.remove(slot)
        self.prefilling[slot] = False
        self.prefill_x[slot] = None
        self.prefill_carry[slot] = None
        self.prefill_keys[slot] = None
        self.prefill_pos[slot] = 0
        self.prefill_base[slot] = 0
        self.prefill_width[slot] = 0

    def _preempt(self, slot: int) -> None:
        """Evict the request holding ``slot``: a mid-prefill victim
        requeues (its chunk state is cheap to rebuild); a decoding one
        parks by swap or recompute. The victim re-enters the queue at its
        front; sampling is seeded per token index, so its resumed output
        is the one it would have produced unparked."""
        req = self.slot_req[slot]
        mode = self.preemption
        if self.prefilling[slot]:
            mode = "requeue"
            self._clear_prefill(slot)
            self._release(slot)
        elif mode == "swap":
            self._park_swap(slot, req)
        else:
            self._park_recompute(slot, req)
        self._obs_preempted(slot, req, mode)
        req.preemptions += 1
        tenant = tenant_of(req)
        self._tenant(tenant)["preemptions"] += 1
        self.obs.preempted(tenant, mode).inc()
        self.waiting.insert(0, req)
        logger.info("preempt request %d (tenant %s, priority %d, mode %s)",
                    req.rid, tenant, priority_of(req), mode)

    def _park_recompute(self, slot: int, req: Request) -> None:
        """Drop the victim's blocks, keeping pins on its cache-tracked
        ones; the resume replays ``prompt + out[:-1]`` through chunked
        prefill (largely from the cache while the pins hold)."""
        n = int(self.n_alloc[slot])
        refs = self.prefix.refcounts if self.prefix is not None else {}
        pinned = tuple(
            b for b in (int(x) for x in self.block_tables[slot, :n])
            if b in refs)
        if pinned:
            self.prefix.acquire(list(pinned))    # pin across the park
        req.resuming = True
        self._parked[req.rid] = ParkedState(
            req=req, mode="recompute", pinned=pinned,
            pos=int(self.pos[slot]), last_tok=int(self.last_tok[slot]))
        self._release(slot)

    def _swap_out_host(self, slot: int, blocks: List[int]
                       ) -> Dict[str, Tensor]:
        """``CacheSpec.swap_out`` moved to host memory: the park's one
        readback."""
        # repro: allow-host-sync swap-out to host memory
        return {name: t.cpu() for name, t in
                self.spec.swap_out(self.cache, slot, blocks).items()}

    def _park_swap(self, slot: int, req: Request) -> None:
        """Copy the victim's private blocks (and its direct cache leaves)
        to host memory, then free them; its cache-tracked blocks stay in
        the pool under a pin. The resume scatters the payload into fresh
        blocks — no recompute."""
        n = int(self.n_alloc[slot])
        blocks = [int(b) for b in self.block_tables[slot, :n]]
        refs = self.prefix.refcounts if self.prefix is not None else {}
        shared = tuple((i, b) for i, b in enumerate(blocks) if b in refs)
        private = tuple((i, b) for i, b in enumerate(blocks)
                        if b not in refs)
        payload = self._swap_out_host(slot, [b for _, b in private])
        pinned = tuple(b for _, b in shared)
        if pinned:
            self.prefix.acquire(list(pinned))    # pin across the park
        self._parked[req.rid] = ParkedState(
            req=req, mode="swap", pinned=pinned, shared=shared,
            private=private, payload=payload, pos=int(self.pos[slot]),
            last_tok=int(self.last_tok[slot]), n_alloc=n,
            extras=self._park_extras(slot))
        self._release(slot)

    def _admit_swapped(self, st: ParkedState) -> bool:
        """Resume a swap-parked request: fresh blocks for its private rows,
        its table rebuilt (pinned shared rows map back in place; the pin
        becomes the table's reference), the payload scattered back, and a
        slot re-occupied at the parked decode cursor."""
        free = self.free_slots()
        if not free:
            return False
        req = st.req
        slot = free[0]
        fresh: List[int] = []
        if st.private:
            got = self._alloc_blocks(len(st.private))
            if got is None:
                return False
            fresh = got
        for i, b in st.shared:
            self.block_tables[slot, i] = b
        for (i, _), b in zip(st.private, fresh):
            self.block_tables[slot, i] = b
        self.n_alloc[slot] = st.n_alloc
        self._stamp_gens(slot, 0, st.n_alloc)
        self._tables_dirty = True
        self.cache = self.spec.swap_in(self.cache, st.payload, slot, fresh)
        self.slot_req[slot] = req
        self.pos[slot] = st.pos
        self.last_tok[slot] = st.last_tok
        self._restore_extras(slot, st.extras)
        self._dstate = None
        self._parked.pop(req.rid, None)
        return True

    def _drop_parked(self, st: ParkedState) -> None:
        """Free a parked request's held resources exactly: its pins go
        back to the cache's accounting, its host payload is dropped."""
        if self.prefix is not None:
            for b in st.pinned:
                self.prefix.release(b)
        st.pinned = ()
        st.payload = None

    def _unpin_parked(self) -> bool:
        """Deadlock relief on an otherwise idle server: drop every parked
        request's pins so the LRU can evict those blocks. A swap park first
        folds its pinned rows into its host payload. True if any pin was
        released."""
        released = False
        for st in self._parked.values():
            if not st.pinned:
                continue
            if st.mode == "swap" and st.shared:
                extra = self._swap_out_host(0, [b for _, b in st.shared])
                st.payload = self._merge_payload(st.payload, extra)
                st.private = st.private + st.shared
                st.shared = ()
            for b in st.pinned:
                self.prefix.release(b)
            st.pinned = ()
            released = True
        return released

    def _merge_payload(self, a, b):
        """Append payload ``b``'s pool rows after ``a``'s on the block axis;
        direct leaves keep ``a``'s slot copy (``b`` was gathered with a
        dummy slot)."""
        seq = self.spec.paged.seq_axes
        return {name: a[name] if seq[name] < 0 else
                torch.cat([a[name], b[name]], dim=ax)
                for name, ax in self.spec.batch_axes.items()}

    def _park_extras(self, slot: int) -> Dict[str, Any]:
        """Extra per-slot host state a swap park carries (the mixture
        server's router-weight row)."""
        return {}

    def _restore_extras(self, slot: int, extras: Dict[str, Any]) -> None:
        """Restore ``_park_extras`` state at a swap resume."""
        return None

    # ------------------------------------------------------------------
    # Telemetry boundaries
    # ------------------------------------------------------------------

    def _obs_preempted(self, slot: int, req: Request, mode: str) -> None:
        """Close the victim's open phase span and mark the preemption on
        its slot track; its queued span re-opens from this stamp."""
        t = time.perf_counter()
        req._obs_queued_from = t
        tr = self.obs.trace
        if tr.enabled:
            tid = self.obs.slot_tid(slot)
            t0 = getattr(req, "_obs_t_phase", 0.0)
            if t0:
                tr.complete(getattr(req, "_obs_phase", "decode"), t0, t,
                            tid, args={"rid": req.rid})
            tr.instant("preempt", t, tid,
                       args={"rid": req.rid, "mode": mode,
                             "tenant": tenant_of(req)})
        req._obs_t_phase = 0.0

    def _on_admitted(self, req: Request, t0: float) -> None:
        """One successful admission: stamp ``t_admit``, close the queued
        span and open the slot-resident phase. A request that retired
        inside ``admit()`` clamps its admission span to its ``t_done``, so
        a request's spans always sum to its end-to-end latency."""
        t1 = req.t_done if req.finish_reason is not None \
            else time.perf_counter()
        resumed_from = getattr(req, "_obs_queued_from", 0.0)
        if not req.t_admit:          # a resume keeps its first admission
            req.t_admit = t0
        obs = self.obs
        obs.admitted.inc()
        # a resumed request's queue delay is measured from its preemption
        obs.queued_s.observe(t0 - (resumed_from or req.t_submit))
        slot = next((s for s, r in enumerate(self.slot_req) if r is req),
                    None)
        if req.finish_reason is None and slot is not None:
            req._obs_slot = slot
            req._obs_phase = "prefill" if self.prefilling[slot] \
                else "decode"
            req._obs_t_phase = t1
        tr = obs.trace
        if tr.enabled:
            tr.async_begin("queued", resumed_from or req.t_submit, req.rid,
                           args={"rid": req.rid})
            tr.async_end("queued", t0, req.rid)
            tid = obs.slot_tid(slot) if slot is not None else ADMIT_TID
            tr.complete("admission", t0, t1, tid, args={"rid": req.rid})
        if resumed_from:
            tenant = tenant_of(req)
            self._tenant(tenant)["resumes"] += 1
            obs.resumed(tenant).inc()
            if tr.enabled and slot is not None:
                tr.instant("resume", t0, obs.slot_tid(slot),
                           args={"rid": req.rid, "tenant": tenant})
            req._obs_queued_from = 0.0

    def _obs_step(self) -> None:
        """Per-step epilogue: the step counter and the occupancy and pool
        gauges (plus one trace counter sample)."""
        obs = self.obs
        obs.steps.inc()
        n_act, n_wait = len(self.active), len(self.waiting)
        obs.active_g.set(n_act)
        obs.waiting_g.set(n_wait)
        if self.paged:
            obs.pool_free_g.set(self.allocator.n_free)
        tr = obs.trace
        if tr.enabled:
            vals = {"active": n_act, "waiting": n_wait}
            if self.paged:
                vals["pool_free_blocks"] = self.allocator.n_free
            tr.counter("engine", time.perf_counter(), vals)

    def _obs_retired(self, slot: Optional[int], req: Request) -> None:
        """One retirement (``t_done`` stamped): the latency histograms, the
        request's speculative accept rate, and the close of its open phase
        span plus a ``retire`` instant with its finish reason."""
        obs = self.obs
        obs.e2e_s.observe(req.t_done - req.t_submit)
        if req.t_first > 0:
            obs.ttft_s.observe(req.t_first - req.t_submit)
        if req.spec_req_steps and self.spec_len > 1:
            obs.req_accept_rate.observe(
                req.spec_req_accepted
                / (req.spec_req_steps * (self.spec_len - 1)))
        tr = obs.trace
        if tr.enabled:
            tid = obs.slot_tid(slot) if slot is not None else ADMIT_TID
            t0 = getattr(req, "_obs_t_phase", 0.0)
            if t0:
                tr.complete(getattr(req, "_obs_phase", "decode"), t0,
                            req.t_done, tid, args={"rid": req.rid})
            tr.instant("retire", req.t_done, tid,
                       args={"rid": req.rid,
                             "finish_reason": req.finish_reason})

    def _obs_chunk_span(self, slot: int, start: int, t0: float,
                        t1: float) -> None:
        """(tracing) The ``prefill_chunk[i]`` span of a step's chunk half,
        ``t0`` to ``t1``, on the slot's track."""
        tr = self.obs.trace
        if tr.enabled:
            req = self.slot_req[slot]
            tr.complete(f"prefill_chunk[{start // self.chunk}]", t0, t1,
                        self.obs.slot_tid(slot),
                        args={"rid": req.rid, "start": start})

    def _obs_phase_flip(self, slot: int, req: Request) -> None:
        """Prefill → decode: close the ``prefill`` span and open the
        ``decode`` phase at the same stamp."""
        t = time.perf_counter()
        t0 = getattr(req, "_obs_t_phase", 0.0)
        tr = self.obs.trace
        if tr.enabled and t0:
            tr.complete("prefill", t0, t, self.obs.slot_tid(slot),
                        args={"rid": req.rid})
        req._obs_phase = "decode"
        req._obs_t_phase = t

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
        self._obs_retired(None, req)
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

    def _alloc_blocks(self, n: int) -> Optional[List[int]]:
        """Pool allocation that evicts LRU unreferenced cached blocks when
        the free list cannot satisfy it."""
        blocks = self.allocator.alloc(n)
        if blocks is None and self.prefix is not None:
            self.prefix.evict(n - self.allocator.n_free)
            blocks = self.allocator.alloc(n)
        return blocks

    def _reserve(self, slot: int, upto: int,
                 shared: Optional[List[int]] = None) -> bool:
        """Grow ``slot``'s reservation to cover positions [0, upto);
        all-or-nothing, False when the pool can't satisfy it. ``shared``
        (admission only, table empty) maps prefix-cache hit blocks
        read-only into the leading entries: the run is pinned before the
        rest is allocated (an allocation may evict LRU blocks, which the
        unpinned run still is) and unpinned again if that fails."""
        need = self._blocks_for(upto)
        have = int(self.n_alloc[slot])
        if need <= have:
            return True
        if shared:
            assert have == 0, (slot, have)
            self.prefix.acquire(shared)
            blocks = self._alloc_blocks(need - len(shared))
            if blocks is None:
                for b in shared:
                    self.prefix.release(b)
                return False
            self.block_tables[slot, :len(shared)] = shared
            self.block_tables[slot, len(shared):need] = blocks
            self.n_alloc[slot] = need
            self._stamp_gens(slot, 0, need)
            self._tables_dirty = True    # only the table changed
            return True
        blocks = self._alloc_blocks(need - have)
        if blocks is None:
            return False
        self.block_tables[slot, have:need] = blocks
        self.n_alloc[slot] = need
        self._stamp_gens(slot, have, need)
        self._tables_dirty = True     # only the table changed
        return True

    def _stamp_gens(self, slot: int, lo: int, hi: int) -> None:
        """Record the allocation generation of table entries [lo, hi)."""
        gen = self.allocator.gen
        for i in range(lo, hi):
            self.block_gens[slot, i] = gen[int(self.block_tables[slot, i])]

    def _grow_active(self) -> None:
        """Before a lockstep decode: every decoding slot must own the block
        its next write lands in (a ring slot already holds its span). With
        preemption on, a slot that cannot grow parks a strictly
        lower-priority victim (else an equal one, youngest first; never
        this step's chunk slot), else parks itself when others remain,
        else releases the parked pins; a slot that cannot grow even alone
        raises."""
        if not self.paged or self.ring:
            return
        need = np.minimum(-(-(self.pos + 1) // self.block_size),
                          self.nb_slot)
        if not np.any((need > self.n_alloc) & (self.n_alloc > 0)):
            return
        for slot in self.decoding:
            if self.slot_req[slot] is None:
                continue             # parked as a victim in this loop
            while not self._reserve(slot, int(self.pos[slot]) + 1):
                if self.preemption != "off":
                    p = priority_of(self.slot_req[slot])
                    victim = self._pick_victim(
                        p, exclude=(slot, self._chunk_pick))
                    if victim is None:
                        victim = self._pick_victim(
                            p + 1, exclude=(slot, self._chunk_pick))
                    if victim is not None:
                        self._preempt(victim)
                        continue
                    if len(self.active) > 1 and self._can_park(slot):
                        self._preempt(slot)
                        break
                    if self._parked and self._unpin_parked():
                        continue
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
        vanilla one-token step instead of raising (span growth never
        preempts). Slots reserved before the failing one keep their blocks
        (they would need them within ``span`` vanilla steps anyway). Never
        a ring: windowed models are not ``speculative_capable``."""
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
            # repro: allow-host-sync host numpy table
            blocks = self.block_tables[slot, :n].tolist()
            for i, b in enumerate(blocks):
                self.allocator.assert_live(
                    b, int(self.block_gens[slot, i]),
                    owner=f"slot {slot} entry {i}")
            if self.prefix is not None:
                # cache-tracked blocks stay resident (shared, or on the
                # LRU list); only untracked ones go back to the free list
                blocks = [b for b in blocks if not self.prefix.release(b)]
            if blocks:
                self.allocator.free(blocks)
        self.block_tables[slot, :] = 0
        self.block_gens[slot, :] = 0
        self.n_alloc[slot] = 0

    def _set_reason(self, req: Request, reason: str) -> None:
        req.finish_reason = reason
        self.obs.retired(reason).inc()
        self._account_retired(req)

    def _account_retired(self, req: Request) -> None:
        """Fold a terminal request into its tenant's token accounting."""
        tenant = tenant_of(req)
        self._tenant(tenant)["tokens"] += len(req.out)
        self.obs.tenant_tokens(tenant).inc(len(req.out))

    def _occupy(self, slot: int, req: Request, first_tok: int,
                prompt_len: int) -> None:
        self.slot_req[slot] = req
        self.pos[slot] = prompt_len
        self._dstate = None
        if req.resuming:
            # a recompute resume: the prefill's pick re-predicted the last
            # recorded token (a sampled one from a count-0 draw); discard
            # it and put the cursor back where the park left it
            req.resuming = False
            self.last_tok[slot] = int(req.out[-1])
            return
        req.record(first_tok)
        self.last_tok[slot] = first_tok

    def _retire_from_slot(self, slot: int, req: Request,
                          reason: str) -> None:
        self._set_reason(req, reason)
        req.t_done = time.perf_counter()
        self._obs_retired(slot, req)
        self._release(slot)

    # ------------------------------------------------------------------
    # The fused step
    # ------------------------------------------------------------------

    def _device_state(self) -> Dict[str, Tensor]:
        """Per-slot device state for the fused dispatch, rebuilt from the
        host mirrors only after admission, retirement, park or resume;
        pure table growth re-uploads the tables alone. Between those events
        the state the previous dispatch returned is passed straight back
        in. Unpaged state has no tables."""
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

    def _decode_step(self) -> List[Request]:
        """One scheduler step: the fused one (``_decode_step_fused``) or,
        with ``fused_step=False``, the reference's unfused one. Unfused,
        the forward (the lockstep decode of every decoding slot, beside
        one prefill chunk when the budget allows) returns the scores, and
        the host epilogue picks the tokens from them (``_next_tokens``) and
        checks stop ids, budgets and the context bound (``_advance``); a
        final chunk's first token is picked from its scores
        (``_after_chunk``). The step's ``dispatch`` time ends when the
        forward's launches are queued, its decode half (``_run_decode``)
        then its chunk half (``_run_chunk``); its ``device_get`` time
        covers the pick and its readback."""
        if self.fused:
            return self._decode_step_fused()
        dec = self.decoding
        do_chunk = self.chunked and self._schedule_chunk()
        if not dec and not do_chunk:
            return []
        obs = self.obs
        if do_chunk:
            slot, xc, start, length, cbt = self._chunk_args()
            if not dec:
                t0 = obs.phase("chunk_dispatch")
                c_out = self._run_chunk(slot, xc, start, length, cbt)
                self._obs_chunk_span(slot, start, t0,
                                     obs.phase("device_get"))
                retired = self._after_chunk(slot, length, c_out)
                obs.step_timing("chunk")
                return retired
            self._grow_active()
            args = self._decode_args()
            obs.phase("decode_dispatch")
            scores = self._run_decode(args)
            t0 = obs.phase("chunk_dispatch")
            c_out = self._run_chunk(slot, xc, start, length, cbt)
            self._obs_chunk_span(slot, start, t0, obs.phase("device_get"))
            nxt = self._next_tokens(scores, from_probs=self._from_probs)
            obs.step_timing("decode+chunk")
            retired = self._advance(nxt)
            return retired + self._after_chunk(slot, length, c_out)
        self._grow_active()
        args = self._decode_args()
        obs.phase("decode_dispatch")
        scores = self._run_decode(args)
        obs.phase("device_get")
        nxt = self._next_tokens(scores, from_probs=self._from_probs)
        obs.step_timing("decode")
        return self._advance(nxt)

    def _decode_args(self) -> Tuple[Tensor, ...]:
        """The unfused decode's per-step inputs, uploaded from the host
        mirrors: ``(tokens, positions)``, plus the decode tables (mid-
        prefill slots masked to scratch, cut to the live horizon) when
        paged."""
        dev = self.device
        args = (torch.tensor(self.last_tok, device=dev),
                torch.tensor(self.pos, device=dev))
        if self.paged:
            args += (torch.tensor(self._decode_tables()[:, :self._nb_live()],
                                  device=dev),)
        return args

    def _run_decode(self, args) -> Tensor:
        """The unfused lockstep decode: (n_slots, V) scores (mixture
        probabilities for the mixture core); keeps the new cache."""
        raise NotImplementedError

    def _run_chunk(self, slot, xc, start, length, cbt) -> Tensor:
        """One prefill chunk with nothing decoding: its (1, V) scores."""
        raise NotImplementedError

    def _advance(self, next_tok: np.ndarray) -> List[Request]:
        """Host half of the unfused step: record one token per decoding
        slot and retire finished requests — budget exhausted (``length``),
        a generated stop id (``stop``), or the capacity bound
        (``truncated``; position cache_len − 1 is decodable). next_tok:
        (n_slots,) int32, inactive and mid-prefill rows ignored."""
        retired = []
        t = time.perf_counter()
        for slot in self.decoding:
            req = self.slot_req[slot]
            req.record(int(next_tok[slot]), t)
            self.pos[slot] += 1
            self.last_tok[slot] = next_tok[slot]
            reason = req.reason_now() or \
                ("truncated" if self.pos[slot] >= self.cache_len else None)
            if reason:
                self._retire_from_slot(slot, req, reason)
                retired.append(req)
        return retired

    def _pick_first(self, req: Request, row: Tensor, *,
                    from_probs: bool = False) -> int:
        """First token from a prefill's last-position scores ((V,) row),
        the unfused epilogue's pick: token ``len(req.out)`` of the
        request's seeded stream, or the argmax for a greedy request
        (``sample_tokens``' greedy rows; floor and log first for
        probabilities). One readback."""
        sp = req.params
        if sp.temperature <= 0:
            # repro: allow-host-sync admission's first token
            return int(pick_first(row[None], from_probs=from_probs).cpu()[0])
        fn = sample_tokens_probs if from_probs else sample_tokens
        dev = row.device
        # repro: allow-host-sync admission's first token
        return int(fn(
            row[None],
            torch.tensor([sp.temperature], dtype=torch.float32, device=dev),
            torch.tensor([sp.top_k], dtype=torch.int32, device=dev),
            torch.tensor([sp.seed & 0xFFFFFFFF], dtype=torch.int64,
                         device=dev),
            torch.tensor([len(req.out)], dtype=torch.int32, device=dev))
            .cpu()[0])

    def _next_tokens(self, scores: Tensor, *,
                     from_probs: bool = False) -> np.ndarray:
        """Next token per slot from the unfused step's (n_slots, V) scores,
        read back once. An all-greedy step takes ``argmax_tokens`` of the
        scores as they are (probabilities too, as the reference does); any
        sampled slot routes the whole step through the seeded sampler,
        whose greedy rows take their argmax inside it (floor and log first
        for probabilities)."""
        dec = self.decoding
        if all(self.slot_req[s].params.temperature <= 0 for s in dec):
            return argmax_tokens(scores).cpu().numpy()
        n = self.n_slots
        temps = np.zeros(n, np.float32)
        top_ks = np.zeros(n, np.int32)
        seeds = np.zeros(n, np.int64)
        counts = np.zeros(n, np.int32)
        for s in dec:
            req = self.slot_req[s]
            temps[s], top_ks[s] = req.params.temperature, req.params.top_k
            # & wraps a negative seed into the uint32 range
            seeds[s] = req.params.seed & 0xFFFFFFFF
            counts[s] = len(req.out)
        fn = sample_tokens_probs if from_probs else sample_tokens
        dev = scores.device
        return fn(scores, *(torch.tensor(a, device=dev)
                            for a in (temps, top_ks, seeds, counts))
                  ).cpu().numpy()

    def _decode_step_fused(self) -> List[Request]:
        """One scheduler step: the fused decode of every decoding slot plus,
        when the budget allows, one prefill chunk — then ONE readback. The
        step's ``dispatch`` time ends when its launches are queued, its
        decode half (``_run_fused``) then its chunk half
        (``_run_chunk_only``); its
        ``device_get`` time is the readback (``EngineObs.step_timing``)."""
        dec = self.decoding
        self._step_span = 1          # chunk and vanilla steps write one
        do_chunk = self.chunked and self._schedule_chunk()
        if not dec and not do_chunk:
            return []
        obs = self.obs
        if do_chunk:
            slot, xc, start, length, cbt = self._chunk_args()
            pick = self._pick_args(self.slot_req[slot])
            if not dec:
                t0 = obs.phase("chunk_dispatch")
                first = self._run_chunk_only(slot, xc, start, length, cbt,
                                             pick)
                self._obs_chunk_span(slot, start, t0,
                                     obs.phase("device_get"))
                retired = self._after_chunk_tok(
                    # repro: allow-host-sync the chunk step's readback
                    slot, length, lambda: int(first.cpu()[0]))
                obs.step_timing("chunk")
                return retired
            self._grow_active()
            dec = self.decoding      # growth may have parked a victim
            st = self._device_state()
            obs.phase("decode_dispatch")
            nxt, done = self._run_fused(st)
            t0 = obs.phase("chunk_dispatch")
            first = self._run_chunk_only(slot, xc, start, length, cbt, pick)
            self._obs_chunk_span(slot, start, t0, obs.phase("device_get"))
            host = torch.cat([nxt, done, first]).cpu().numpy()
            obs.step_timing("decode+chunk")
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
        dec = self.decoding          # growth may have parked a victim
        st = self._device_state()
        obs.phase("decode_dispatch")
        nxt, done = self._run_fused(st)
        obs.phase("device_get")
        host = torch.stack([nxt, done]).cpu().numpy()
        obs.step_timing("decode")
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
        self.obs.phase("decode_dispatch")
        toks, n_emit, done = self._run_verify(st, drafts)
        self.obs.phase("device_get")
        n = self.n_slots
        host = torch.cat([toks.reshape(-1), n_emit, done]).cpu().numpy()
        self.obs.step_timing("spec_verify")
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
        obs = self.obs
        accepted = 0
        for slot in dec:
            req = self.slot_req[slot]
            n = int(n_emit[slot])
            for j in range(n):
                req.record(int(toks[slot, j]), t)
            self.pos[slot] += n
            if n:
                self.last_tok[slot] = toks[slot, n - 1]
            obs.spec_steps.inc()
            obs.spec_tokens.inc(n)
            obs.accept_len.observe(n)
            # n - 1 of the step's spec_len - 1 drafts were accepted (the
            # first token is the committed one)
            req.spec_req_steps += 1
            req.spec_req_accepted += max(n - 1, 0)
            accepted += max(n - 1, 0)
            d = int(done[slot])
            if d:
                reason = DONE_REASONS[d]
                if reason != (req.reason_now() or "truncated"):
                    raise RuntimeError(
                        f"slot {slot}: device finish reason {reason} "
                        f"disagrees with the host's {req.reason_now()}")
                self._retire_from_slot(slot, req, reason)
                retired.append(req)
        if dec and self.spec_len > 1:
            src = self.speculative or "ngram"
            obs.drafts(src, "proposed").inc(len(dec) * (self.spec_len - 1))
            obs.drafts(src, "accepted").inc(accepted)
        return retired

    # ------------------------------------------------------------------
    # Chunked prefill
    # ------------------------------------------------------------------

    def _admit_chunked(self, req: Request, slot: int, width: int,
                       prep) -> bool:
        """Match the prompt against the prefix cache (hit blocks map
        read-only into the table and their positions are skipped), reserve
        the rest of the prompt's blocks, embed it, slice off the cached
        run, pre-split the suffix into per-chunk tensors and park the slot
        mid-prefill at the first uncached position. False → the pool can't
        reserve right now (the match re-runs on the retry)."""
        self._reject_overlong(req, width)
        toks = req.prefill_tokens    # a resume: prompt + output
        base, shared, keys = 0, [], None
        if self.prefix is not None:
            # memoized per request and span length (a pool-blocked
            # admission retries every step; a resume's span differs)
            cached = getattr(req, "_prefix_keys", None)
            memo_key = (self.block_size, len(toks))
            if cached is None or cached[0] != memo_key:
                keys = block_keys(toks, req.extras, self.block_size,
                                  width // self.block_size,
                                  n_prefix=width - len(toks))
                req._prefix_keys = (memo_key, keys)
            else:
                keys = cached[1]
            tr = self.obs.trace
            t_m0 = time.perf_counter() if tr.enabled else 0.0
            shared = self.prefix.match(keys, width)
            if tr.enabled:
                tr.complete("prefix_match", t_m0, time.perf_counter(),
                            self.obs.slot_tid(slot),
                            args={"rid": req.rid,
                                  "hit_blocks": len(shared)})
            base = len(shared) * self.block_size
        if self.paged and not self._reserve(slot, width, shared=shared):
            return False
        if self.prefix is not None:
            self.prefix.record(width, base)
        pad = -(width - base) % self.chunk   # the token row pads; x is
        x, carry = prep(req.batch(self.device,  # width + pad
                                  pad_to=len(toks) + pad))
        if base:
            x = x[:, base:]
        self.slot_req[slot] = req
        self.prefilling[slot] = True
        self.prefill_pos[slot] = base
        self.prefill_base[slot] = base
        self.prefill_width[slot] = width
        self.prefill_x[slot] = x.split(self.chunk, dim=1)
        self.prefill_carry[slot] = carry
        self.prefill_keys[slot] = keys
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

    def _pick_chunk_slot(self) -> int:
        """This step's prefill-chunk slot: the FCFS head of the mid-prefill
        slots, or with a ``QoSConfig`` deficit round robin over the tenants
        that have one (one chunk = one charge), FCFS within a tenant.
        Cached for the step, so the sanitizer's shadow replay and the
        dispatch see the same pick and the DRR is charged once."""
        pick = self._chunk_pick
        if pick is not None and self.prefilling[pick]:
            return pick
        pick = self.prefill_order[0]
        if self.qos is not None and len(self.prefill_order) > 1:
            heads: Dict[str, int] = {}
            for s in self.prefill_order:
                t = tenant_of(self.slot_req[s])
                if t not in heads:
                    heads[t] = s
            if len(heads) > 1:
                chosen = self._drr_chunk.pick(
                    {t: self.chunk for t in heads})
                pick = heads[chosen]
        self._chunk_pick = pick
        return pick

    def _chunk_args(self):
        """(slot, x_chunk, start, length, block_table) of this step's
        mid-prefill slot (``_pick_chunk_slot``)."""
        slot = self._pick_chunk_slot()
        start = int(self.prefill_pos[slot])
        length = min(self.chunk, int(self.prefill_width[slot]) - start)
        xc = self.prefill_x[slot][
            (start - int(self.prefill_base[slot])) // self.chunk]
        cbt = torch.as_tensor(self.block_tables[slot], device=self.device) \
            if self.paged else torch.zeros((1,), dtype=torch.int32,
                                           device=self.device)
        return slot, xc, start, length, cbt

    def _after_chunk(self, slot: int, length: int,
                     c_out: Tensor) -> List[Request]:
        """Unfused ``_after_chunk_tok``: a final chunk's first token is
        picked from its (1, V) scores (``_pick_first``)."""
        req = self.slot_req[slot]
        return self._after_chunk_tok(
            slot, length, lambda: self._pick_first(
                req, c_out[0], from_probs=self._from_probs))

    def _after_chunk_tok(self, slot: int, length: int,
                         first_fn) -> List[Request]:
        """Advance a slot's prefill by one chunk; on the final chunk take
        the first token from ``first_fn``, register the prompt's full
        blocks with the prefix cache, splice the carry's direct-leaf state
        into the batched cache and move the slot to decode (or retire it:
        context-filling prompts, max_new == 1, a stop token)."""
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
        if self.prefix is not None:
            # the prompt's full blocks are whole and immutable now (decode
            # writes land past the prompt): make them shareable, before
            # any retirement below releases them to the LRU list
            n_full = width // self.block_size
            self.prefix.insert(self.prefill_keys[slot] or [],
                               self.block_tables[slot, :n_full])
        self.prefill_keys[slot] = None
        self.prefill_base[slot] = 0
        if width >= self.cache_len:      # prompt fills the context bound
            req.record(first)
            self._retire_from_slot(slot, req,
                                   req.reason_now() or "truncated")
            return [req]
        # the carry's direct leaves (recurrent state) become the slot's
        self.cache = self.spec.insert_direct(self.cache, carry, slot)
        self._obs_phase_flip(slot, req)
        self._occupy(slot, req, first, width)
        reason = req.reason_now()        # max_new == 1, or first tok stops
        if reason:
            self._retire_from_slot(slot, req, reason)
            return [req]
        return []

    def _drop_details(self) -> List[str]:
        """Progress of every request still holding a slot (a mid-prefill
        one with its partial position)."""
        out = []
        for slot, r in enumerate(self.slot_req):
            if r is None:
                continue
            if self.prefilling[slot]:
                out.append(f"{r.rid} (prefill {int(self.prefill_pos[slot])}"
                           f"/{int(self.prefill_width[slot])})")
            else:
                out.append(f"{r.rid} (decode pos {int(self.pos[slot])})")
        return out

    def serve(self, queue: List[Request], *, max_steps: int = 10_000
              ) -> Dict[int, List[int]]:
        """Drive a queue to completion — a drain loop over the incremental
        API (``add_request`` everything, ``step`` until nothing is
        unfinished, collect the finished outputs). Each run starts with
        ``reset_stats()``, so the ``aborted``/``stopped`` counts are this
        run's. Running out of ``max_steps`` with unfinished requests
        raises, naming each one's progress."""
        return _drain(self, queue, max_steps)

    # ------------------------------------------------------------------
    # Observability
    # ------------------------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        """Serving stats, the reference's keys: a view over the engine's
        metrics registry (``metrics``) plus the pool, the prefix cache,
        the sanitizer and, with QoS or preemption, the parks and the
        tenant breakdown. ``aborted``/``stopped`` are per ``serve()`` run
        (``reset_stats``)."""
        out: Dict[str, Any] = {"active": len(self.active),
                               "waiting": len(self.waiting),
                               "aborted": self.n_aborted,
                               "stopped": self.n_stopped}
        if self.paged:
            out["pool_free_blocks"] = self.allocator.n_free
            out["pool_blocks"] = self.allocator.n_blocks
        if self.speculative is not None:
            out["spec_steps"] = self.n_spec_steps
            out["spec_tokens"] = self.n_spec_tokens
            out["spec_tokens_per_step"] = (
                self.n_spec_tokens / self.n_spec_steps
                if self.n_spec_steps else 0.0)
        if self.prefix is not None:
            out.update(self.prefix.stats())
        if self.sanitizer is not None:
            out.update(self.sanitizer.stats())
        if self.qos is not None or self.preemption != "off":
            out["parked"] = len(self._parked)
            out["tenants"] = self._tenant_breakdown()
        return out

    def _tenant_breakdown(self) -> Dict[str, Dict[str, int]]:
        """Per tenant: the cumulative counters (tokens at retirement,
        preemptions, resumes, rejections) and the live picture (active
        slots, their pool blocks, parked requests, their pinned blocks,
        tokens of running requests)."""
        def zero() -> Dict[str, int]:
            return {"tokens": 0, "preemptions": 0, "resumes": 0,
                    "rejections": 0, "active_slots": 0, "pool_blocks": 0,
                    "parked": 0, "pinned_blocks": 0, "tokens_live": 0}
        tenants: Dict[str, Dict[str, int]] = {}
        for t, st in self._tenant_stats.items():
            tenants[t] = dict(zero(), **st)
        for slot in self.active:
            req = self.slot_req[slot]
            d = tenants.setdefault(tenant_of(req), zero())
            d["active_slots"] += 1
            d["pool_blocks"] += int(self.n_alloc[slot])
            d["tokens_live"] += len(req.out)
        for st in self._parked.values():
            d = tenants.setdefault(tenant_of(st.req), zero())
            d["parked"] += 1
            d["pinned_blocks"] += len(st.pinned)
        return tenants

    @property
    def metrics(self) -> _obs_metrics.MetricsRegistry:
        """The engine's metrics registry (always live; published to
        ``obs.default_registry()`` with ``EngineConfig(metrics=True)``)."""
        return self.obs.registry

    def reset_stats(self) -> None:
        """Zero the per-run request counters (``aborted`` and the
        retirement counters behind ``stopped``); the cumulative series are
        left to ``metrics.reset()``."""
        self.obs.reset_run_counters()

    def export_trace(self, path: Optional[str] = None) -> dict:
        """The span trace as a Chrome/Perfetto ``trace_event`` JSON object
        (empty unless built with ``EngineConfig(trace=True)``), written to
        ``path`` when given."""
        doc = self.obs.trace.to_chrome()
        if path is not None:
            with open(path, "w") as f:
                json.dump(doc, f)
        return doc

    def export_metrics(self, path: Optional[str] = None) -> dict:
        """JSON snapshot of the registry, written to ``path`` when given."""
        doc = self.obs.registry.to_dict()
        if path is not None:
            with open(path, "w") as f:
                json.dump(doc, f, indent=1)
        return doc

    def prometheus_metrics(self) -> str:
        """Prometheus text exposition of this engine's registry."""
        return self.obs.registry.to_prometheus()


def make_serve_fns(model: Model, cache_len: int, *, paged: bool = False):
    """The ``(prefill, decode)`` pair one SlotServer runs on: ``prefill(
    params, batch)`` → ``(logits, cache)`` and the unfused step's
    ``decode(params, cache, tokens, pos)`` → ``(logits, cache)``, which
    with ``paged`` takes the per-slot block tables as its last
    argument."""
    def prefill(p, b):
        return model.prefill(p, b, cache_len)

    if paged:
        def decode(p, c, t, pos, bt):
            return model.decode_step_paged(p, c, t, pos, bt)
    else:
        def decode(p, c, t, pos):
            return model.decode_step(p, c, t, pos)
    return prefill, decode


def make_chunk_fns(model: Model, cache_len: int):
    """``(prep, chunk_only)`` of chunked prefill: ``prep(params, batch)``
    embeds the padded prompt and builds the carry; the unfused step's
    ``chunk_only(params, cache, carry, xc, start, length, cbt)`` →
    ``(chunk logits, carry, cache)`` runs one prefill chunk, alone or
    after the lockstep decode. The two touch disjoint state: decode writes
    land in the decoding slots' own blocks (the chunk slot's table row is
    masked to scratch), the chunk's in its reserved blocks and its
    carry."""
    def prep(p, b):
        return model.embed_prompt(p, b), model.init_chunk_carry(p, b,
                                                                cache_len)

    def chunk_only(p, c, carry, xc, start, ln, cbt):
        return model.prefill_chunk(p, c, carry, xc, start, ln, cbt)

    return prep, chunk_only


def make_fused_fns(model: Model, cache_len: int, *, paged: bool):
    """``(step, chunk_only)`` — plain functions one SlotServer runs on
    (shared by the pods of a top-1 deployment); a decode + chunk step runs
    the one, then the other:

    * ``step(params, cache, state)`` → ``(cache, state, next_tok, done)``;
    * ``chunk_only(params, cache, carry, xc, start, length, cbt, temp,
      top_k, seed)`` → ``(first, carry, cache)``: one prefill chunk and
      its first-token pick (count 0 of the request's seeded stream, or
      the argmax when ``temp, top_k, seed`` are left out).
    """
    def step(p, c, st):
        return model.fused_decode_step(p, c, st, cache_len=cache_len,
                                       paged=paged)

    def chunk_only(p, c, carry, xc, start, ln, cbt, *pick):
        c_out, carry, c = model.prefill_chunk(p, c, carry, xc, start, ln, cbt)
        return pick_first(c_out, *pick), carry, c

    return step, chunk_only


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
    """Continuous batching over ONE expert with the fused decode step, or
    with ``config.fused_step=False`` the unfused one. ``config.paged``
    puts the KV cache in a pool of ``page_block``-position blocks
    (``pool_blocks`` of them, 0 → full capacity) instead of contiguous
    per-slot rows; ``config.chunked_prefill`` (paged, or a family with no
    pageable leaves) consumes prompts ``chunk`` positions per step
    instead of prefilling each whole at admission; ``config.
    speculative="ngram"`` (paged, fused) verifies ``spec_len``-position
    spans on decode-only steps."""

    def __init__(self, model: Model, params, *, config: EngineConfig,
                 device="cuda", fused_fns=None, pod: int = 0):
        super().__init__(model, config, device, pod)
        self.model, self.params = model, params
        self.cache = self._new_cache(model)
        self.spec = model.cache_spec(self.block_size)
        self._prefill, self._decode = make_serve_fns(
            model, self.cache_len, paged=self.paged)
        self._prep, self._chunk_only = make_chunk_fns(model, self.cache_len)
        if self.fused:
            self._fstep, self._fchunk_only = fused_fns or make_fused_fns(
                model, self.cache_len, paged=self.paged)
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
        logits, row_cache = self._prefill(self.params,
                                          req.batch(self.device))
        # repro: allow-host-sync admission's first token
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

    def _run_chunk_only(self, slot, xc, start, length, cbt, pick):
        first, self.prefill_carry[slot], self.cache = self._fchunk_only(
            self.params, self.cache, self.prefill_carry[slot], xc, start,
            length, cbt, *pick)
        return first

    def _run_decode(self, args):
        logits, self.cache = self._decode(self.params, self.cache, *args)
        return logits

    def _run_chunk(self, slot, xc, start, length, cbt):
        c_logits, self.prefill_carry[slot], self.cache = self._chunk_only(
            self.params, self.cache, self.prefill_carry[slot], xc, start,
            length, cbt)
        return c_logits


class MixtureSlotServer(_SlotTable):
    """Continuous batching over the stacked expert ensemble (port of
    ``repro.serve.scheduler.MixtureSlotServer``): one cache carrying the
    expert (K) dim at axis 1 of every leaf, one stacked decode step per
    scheduler step with the Eq. 27 mixture and the serving epilogue fused
    in (``core.ensemble.make_stacked_fused``; unfused, the stacked decode
    and the mixture of ``make_stacked_serving`` and the host epilogue over
    the mixed probabilities), and per-slot router weights fixed at
    admission. Speculation verifies the span on the whole stack
    at once (``core.ensemble.make_stacked_verify``), drafted by the
    host's n-gram lookup or by expert 0 on the device. In the paged layout the pool carries the K dim too,
    and all K experts of a slot share ONE block table. A request is routed
    when admission pays for its prefill: after its blocks are reserved, so
    a request blocked on free KV blocks does not run the router again each
    retry. Its one prefix cache serves all K experts (a shared block id b
    is block b of every expert's segment of the pool), and a swap park
    carries all K segments and the slot's router-weight row."""

    _needs_features = True        # admission routes on the features
    _from_probs = True            # the mixed scores are probabilities

    def __init__(self, model: Model, expert_params: List[Any], router, *,
                 config: EngineConfig, device="cuda", pod: int = 0):
        super().__init__(model, config, device, pod)
        self.model, self.router = model, router.to(self.device)
        self.K = len(expert_params)
        self.stacked, self._prefill_all, self._mix_decode = \
            make_stacked_serving(
                model, [tree_map(lambda t: t.to(self.device), p)
                        for p in expert_params],
                self.cache_len, paged=self.paged)
        self.cache = self._new_cache(model, experts=self.K)
        self.spec = model.cache_spec(self.block_size).shifted(1)
        self.weights = np.zeros((self.n_slots, self.K), np.float32)
        self._prep, self._chunk_all = make_stacked_chunk_fns(
            model, self.cache_len)
        if self.fused:
            self._fstep, self._fchunk_only = make_stacked_fused(
                model, self.cache_len, paged=self.paged)
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
        logits, row_cache = self._prefill_all(self.stacked,
                                              req.batch(self.device))
        probs = mix_expert_logits(logits[:, :, -1], torch.as_tensor(
            w[None], device=self.device))                       # (1, V)
        # repro: allow-host-sync admission's first token
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

    def _park_extras(self, slot: int) -> Dict[str, Any]:
        # the router-weight row is per-slot host state a swap resume
        # cannot rebuild (a recompute resume re-routes on the features)
        return {"weights": self.weights[slot].copy()}

    def _restore_extras(self, slot: int, extras: Dict[str, Any]) -> None:
        if "weights" in extras:
            self.weights[slot] = extras["weights"]

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

    def _run_chunk_only(self, slot, xc, start, length, cbt, pick):
        first, self.prefill_carry[slot], self.cache = self._fchunk_only(
            self.stacked, self.cache, self.prefill_carry[slot], xc, start,
            length, cbt, self._weights_row(slot), *pick)
        return first

    def _run_decode(self, args):
        tok, pos, *tables = args
        probs, self.cache = self._mix_decode(
            self.stacked, self.cache, tok, pos,
            torch.tensor(self.weights, device=self.device), *tables)
        return probs

    def _run_chunk(self, slot, xc, start, length, cbt):
        c_probs, self.prefill_carry[slot], self.cache = self._chunk_all(
            self.stacked, self.cache, self.prefill_carry[slot], xc, start,
            length, cbt, self._weights_row(slot))
        return c_probs


class DecentralizedSlotServer:
    """Front-end centroid router over continuously batched expert pods.

    strategy="top1"    — one ``SlotServer`` per expert; the router runs at
                         submission and each request decodes on exactly
                         the expert it assigns.
    strategy="mixture" — one ``MixtureSlotServer`` (``core``, and the only
                         entry of ``pods``) over the stacked experts; the
                         router runs at admission.

    Pod k's telemetry carries ``pod=k`` (its registry label and its pid in
    the merged trace); every pod has its own prefix cache and parks.
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
                                          config=config, device=self.device,
                                          pod=0)
            self.pods = [self.core]
            return
        # a family with no pageable leaves serves its paged config on the
        # direct path; the fused fns exist only for the fused step
        paged = effective_page_block(
            model, config.page_block if config.paged else 0) > 0
        fns = make_fused_fns(model, config.cache_len, paged=paged) \
            if config.fused_step else None
        self.pods = [SlotServer(model,
                                tree_map(lambda t: t.to(self.device), p),
                                config=config, device=self.device,
                                fused_fns=fns, pod=k)
                     for k, p in enumerate(expert_params)]

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
        # repro: allow-host-sync routing at submission
        k = int(self.router.top1(self._features(req.features[None])).cpu()[0])
        return self.pods[k].add_request(req)

    def step(self) -> List[RequestOutput]:
        """One step of every pod, in pod order (one profiler range over
        them while a profiler records)."""
        outs: List[RequestOutput] = []
        with host_range(SERVE_RANGE + "engine_step"):
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

    def serve(self, queue: List[Request], *, max_steps: int = 10_000
              ) -> Dict[int, List[int]]:
        """The drain loop (``_SlotTable.serve``) over every pod; requests
        are routed at submission."""
        if not queue:
            return {}
        return _drain(self, queue, max_steps)

    # ------------------------------------------------------------------
    # Observability (the reference's docs/observability.md)
    # ------------------------------------------------------------------

    def _engines(self) -> List[_SlotTable]:
        return self.pods

    def reset_stats(self) -> None:
        """Per-run counter hygiene on every pod (``serve()`` calls it)."""
        for p in self.pods:
            p.reset_stats()

    def export_trace(self, path: Optional[str] = None) -> Dict[str, Any]:
        """Merged Chrome/Perfetto trace over every pod, each with its own
        ``pid``; written to ``path`` when given."""
        doc = merge_chrome([p.obs.trace for p in self.pods])
        if path is not None:
            with open(path, "w") as f:
                json.dump(doc, f)
        return doc

    def export_metrics(self, path: Optional[str] = None) -> Dict[str, Any]:
        """Merged metrics snapshot over every pod's registry (series keep
        their ``pod`` label)."""
        doc = _obs_metrics.snapshot([p.obs.registry for p in self.pods])
        if path is not None:
            with open(path, "w") as f:
                json.dump(doc, f, indent=2)
        return doc

    def prometheus_metrics(self) -> str:
        """Prometheus text exposition over every pod's registry."""
        return _obs_metrics.prometheus([p.obs.registry for p in self.pods])


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
