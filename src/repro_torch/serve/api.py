"""The serving API objects (port of ``repro.serve.api``): per-request
``SamplingParams``, the ``EngineConfig`` with its one ``validate()``, and
the streamed ``TokenDelta``/``RequestOutput``.

``validate()`` keeps the reference's dependency checks, in its order and
with its messages; every family is served. ``qos`` takes the port's
``QoSConfig`` (``serve.qos``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import FrozenSet, List, Optional, Tuple

import numpy as np

from repro_torch.serve.qos import QoSConfig
from repro_torch.tree import flat_leaves

__all__ = ["EngineConfig", "QoSConfig", "RequestOutput", "SamplingParams",
           "TokenDelta", "FINISH_REASONS", "STOP_PAD", "effective_page_block",
           "stop_id_row"]

#: Pad value of the per-slot stop-id matrix (token ids are non-negative).
STOP_PAD = -1

#: The closed set of reasons a request can finish with.
FINISH_REASONS = ("length", "stop", "aborted", "truncated", "rejected")


@dataclass(frozen=True)
class SamplingParams:
    """Per-request decoding controls.

    ``temperature <= 0`` is greedy decoding (the default); otherwise
    sampling is seeded per request — token ``i`` draws from
    ``fold_in(PRNGKey(seed), i)`` with the reference's threefry bits, so a
    request's continuation depends only on (seed, scores), never on slot
    placement or co-scheduled traffic. ``top_k == 0`` samples the full
    vocabulary; ``top_k == 1`` is exactly greedy. ``stop_token_ids`` (plus
    ``eos_token_id``) retire the request as soon as one is *generated*,
    with ``finish_reason == "stop"``; the stop token is kept in the output.
    ``tenant`` names the fair-share accounting bucket and ``priority``
    (higher = more urgent) arms preemption under pool pressure
    (``QoSConfig``, ``EngineConfig.preemption``); neither changes a token:
    a preempted and resumed request replays token for token."""

    max_new: int = 16
    temperature: float = 0.0
    top_k: int = 0
    seed: int = 0
    stop_token_ids: Tuple[int, ...] = ()
    eos_token_id: Optional[int] = None
    priority: int = 0
    tenant: str = "default"

    def __post_init__(self):
        if self.max_new < 1:
            raise ValueError(
                f"max_new must be >= 1 (every request emits at least its "
                f"prefill token), got {self.max_new}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0 (0 = full vocabulary), "
                             f"got {self.top_k}")
        if not self.tenant:
            raise ValueError("tenant must be a non-empty string")
        stops = frozenset(int(t) for t in self.stop_token_ids)
        if self.eos_token_id is not None:
            stops |= {int(self.eos_token_id)}
        object.__setattr__(self, "stop_set", stops)

    stop_set: FrozenSet[int] = field(init=False, repr=False, compare=False,
                                     default=frozenset())


def stop_id_row(params: SamplingParams, width: int) -> np.ndarray:
    """(width,) int32 encoding of ``params.stop_set``: sorted ids, padded
    with ``STOP_PAD``."""
    ids = sorted(params.stop_set)
    if len(ids) > width:
        raise ValueError(
            f"stop-id row width {width} cannot hold {len(ids)} stop ids")
    row = np.full(width, STOP_PAD, np.int32)
    row[:len(ids)] = ids
    return row


@dataclass(frozen=True)
class EngineConfig:
    """Engine deployment knobs (the reference's fields and defaults; the
    reference's ``use_kernel`` is gone — the port dispatches kernels on the
    tensors' device) and the ONE place their dependency matrix is
    enforced."""

    n_slots: int = 8
    cache_len: int = 128
    paged: bool = False
    page_block: int = 16
    pool_blocks: int = 0          # 0 → full capacity
    chunked_prefill: bool = False
    chunk: int = 16
    token_budget: int = 0         # 0 → n_slots + chunk
    prefix_cache: bool = False
    fused_step: bool = True
    sanitize: bool = False
    speculative: Optional[str] = None
    spec_len: int = 4
    trace: bool = False
    trace_ring: int = 65536
    metrics: bool = False
    qos: Optional[QoSConfig] = None
    preemption: str = "off"
    strategy: str = "top1"

    def validate(self, model=None) -> None:
        """Raise ``ValueError`` on an inconsistent configuration. Pass the
        model to also run the model-dependent checks."""
        if self.n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {self.n_slots}")
        if self.cache_len < 2:
            raise ValueError(
                f"cache_len must be >= 2 (one prompt position plus one "
                f"decodable position), got {self.cache_len}")
        if self.paged and self.page_block < 1:
            raise ValueError(
                f"paged serving needs page_block >= 1 positions per KV "
                f"block, got {self.page_block}")
        if self.pool_blocks and not self.paged:
            raise ValueError(
                "pool_blocks sizes the paged block pool — it needs "
                "paged=True (page_block > 0)")
        if self.paged and self.pool_blocks == 1:
            raise ValueError(
                "pool_blocks=1 is only the reserved scratch block — a "
                "paged pool needs >= 2 blocks (or 0 for full capacity)")
        if self.chunked_prefill and self.chunk < 1:
            raise ValueError(
                f"chunked prefill needs chunk >= 1 prompt positions per "
                f"step, got {self.chunk}")
        if self.token_budget < 0:
            raise ValueError(
                f"token_budget must be >= 0, got {self.token_budget}")
        if self.token_budget and not self.chunked_prefill:
            raise ValueError(
                "token_budget bounds the chunked-prefill step loop — it "
                "needs chunked_prefill=True (chunk > 0)")
        if self.prefix_cache and not (self.paged and self.chunked_prefill):
            raise ValueError(
                "the prefix cache shares prompt KV through the paged pool "
                "and fills misses with chunked prefill — enable paging "
                "(page_block > 0) and chunked prefill (chunk > 0)")
        if self.sanitize and not self.paged:
            raise ValueError(
                "sanitize=True runs the PoolSanitizer, which shadows the "
                "paged KV block pool — enable paging (page_block > 0)")
        if self.strategy not in ("top1", "mixture"):
            raise ValueError(
                f"strategy must be 'top1' or 'mixture', got "
                f"{self.strategy!r}")
        if self.speculative is not None:
            if self.speculative not in ("ngram", "expert"):
                raise ValueError(
                    f"speculative must be 'ngram' or 'expert', got "
                    f"{self.speculative!r}")
            if not self.paged:
                raise ValueError(
                    "speculative decoding verifies a multi-token span "
                    "through the paged block pool — enable paging "
                    "(page_block > 0)")
            if not self.fused_step:
                raise ValueError(
                    "speculative decoding runs draft + verify + accept "
                    "inside the fused dispatch — it needs fused_step=True")
            if self.speculative == "expert" and self.strategy != "mixture":
                raise ValueError(
                    "speculative='expert' drafts with the stacked "
                    "mixture's expert 0 — it needs strategy='mixture' "
                    "(single-model and top-1 engines have no expert "
                    "stack to draft from; use speculative='ngram')")
        if self.spec_len < 1:
            raise ValueError(
                f"spec_len must be >= 1 (1 = vanilla decode, L > 1 "
                f"verifies L - 1 drafts per step), got {self.spec_len}")
        if self.trace_ring < 1:
            raise ValueError(
                f"trace_ring must be >= 1 (the span recorder is a bounded "
                f"ring buffer), got {self.trace_ring}")
        if self.preemption not in ("off", "recompute", "swap"):
            raise ValueError(
                f"preemption must be 'off', 'recompute' or 'swap', got "
                f"{self.preemption!r}")
        if self.preemption != "off" and not self.paged:
            raise ValueError(
                "preemption parks/drops a victim's paged KV blocks — "
                "enable paging (page_block > 0)")
        if self.preemption == "recompute" and not self.chunked_prefill:
            raise ValueError(
                "preemption='recompute' resumes victims through chunked "
                "prefill — enable chunked_prefill (chunk > 0), or use "
                "preemption='swap'")
        if self.qos is not None and self.qos.max_predicted_ttft_s > 0 \
                and not self.chunked_prefill:
            raise ValueError(
                "the predicted-TTFT admission model meters the chunked-"
                "prefill token budget — max_predicted_ttft_s needs "
                "chunked_prefill=True (max_waiting works without it)")
        if model is not None:
            self._validate_model(model)

    def _validate_model(self, model) -> None:
        cfg = model.cfg
        eff_block = effective_page_block(
            model, self.page_block if self.paged else 0)
        if self.preemption != "off":
            if cfg.sliding_window > 0:
                raise ValueError(
                    "preemption does not support sliding-window (ring) "
                    "caches — a ring slot's blocks are positionally "
                    "wrapped, not droppable; serve windowed configs with "
                    "preemption='off'")
            if eff_block == 0:
                raise ValueError(
                    f"preemption parks/drops paged KV blocks but family "
                    f"'{cfg.family}' has no pageable cache leaves — serve "
                    f"it with preemption='off'")
        if not self.chunked_prefill:
            return
        if cfg.sliding_window > 0:
            raise ValueError(
                "chunked prefill does not support sliding-window (ring) "
                "caches yet — serve windowed configs with monolithic "
                "admission")
        has_pool = any(a >= 0 for a in
                       flat_leaves(model.cache_spec(1).paged.seq_axes))
        if has_pool and eff_block == 0:
            raise ValueError(
                "chunked prefill writes prompt KV through the paged pool — "
                "enable paging (page_block > 0)")
        if cfg.family in ("ssm", "hybrid") and self.chunk % cfg.ssm.chunk:
            raise ValueError(
                f"prefill chunk {self.chunk} must be a multiple of the "
                f"chunkwise-scan length {cfg.ssm.chunk} for exact "
                f"chunked-vs-monolithic parity on family '{cfg.family}'")


def effective_page_block(model, page_block: int) -> int:
    """0 when the model has no pageable cache leaves (ssm: recurrent state
    only) — paging such a family would run pool accounting that backs no
    memory, so it degrades to the direct path instead."""
    if page_block <= 0:
        return 0
    seq_axes = model.cache_spec(page_block).paged.seq_axes
    return page_block if any(a >= 0 for a in flat_leaves(seq_axes)) else 0


@dataclass(frozen=True)
class TokenDelta:
    """One newly decoded token: id, 0-based index in the request's output,
    and its ``perf_counter`` emission stamp."""

    token: int
    index: int
    t: float


@dataclass
class RequestOutput:
    """One request's streaming update from ``step()`` (or ``abort()``):
    the tokens new since its last update, the cumulative output, and —
    once finished — its ``finish_reason``. TTFT is ``t_first - t_submit``."""

    rid: int
    deltas: List[TokenDelta]
    token_ids: List[int]
    finished: bool
    finish_reason: Optional[str]
    t_submit: float
    t_first: float
    t_done: float
    t_admit: float = 0.0

    @property
    def ttft(self) -> float:
        return self.t_first - self.t_submit if self.t_first > 0 \
            else float("nan")

    @property
    def ttft_s(self) -> float:
        return self.ttft

    @property
    def queued_s(self) -> float:
        return self.t_admit - self.t_submit if self.t_admit > 0 \
            else float("nan")
