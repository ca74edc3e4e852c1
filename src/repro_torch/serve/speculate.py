"""Draft-free speculative proposers (port of ``repro.serve.speculate``).

Speculative decoding splits a decode step into a cheap DRAFT of the next
``spec_len - 1`` tokens and one multi-token VERIFY forward that scores
every candidate position at once (``Model.verify_step_paged``); the accept
rule (``serve.fused.verify_epilogue``) keeps the longest prefix that
matches the vanilla trajectory — greedy or seeded-sampled — so the
output is token for token that of unspeculated decode and drafting is
purely a latency lever.

``NGramProposer`` drafts on the host by prompt lookup: match the
request's most recent n-gram against its own earlier history (prompt +
generated tokens) and propose the tokens that followed the previous
occurrence. It is numpy host code, a copy of the reference's (the
reference package's ``serve`` imports JAX, so the port cannot import it).
The other draft source, expert 0 of the Eq. 27 mixture drafting on the
device (``speculative="expert"``), lives in
``core.ensemble.make_stacked_verify``.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np

__all__ = ["NGramProposer"]


class NGramProposer:
    """Prompt-lookup drafting from a request's own token history.

    To propose, find the most recent EARLIER occurrence of the history's
    final ``n``-gram and replay the ``spec_len - 1`` tokens that followed
    it. No occurrence (or a too-short history) pads by repeating the last
    token — a deliberately bad draft that costs nothing when rejected
    (the verify step always emits at least the vanilla token).
    """

    def __init__(self, spec_len: int, n: int = 2):
        if spec_len < 2:
            raise ValueError(
                f"spec_len must be >= 2 to draft anything, got {spec_len}")
        if n < 1:
            raise ValueError(f"n-gram length must be >= 1, got {n}")
        self.spec_len = spec_len
        self.n = n

    def propose(self, history: Sequence[int]) -> np.ndarray:
        """history: the request's prompt + generated tokens, oldest first.
        Returns (spec_len - 1,) int32 draft tokens."""
        want = self.spec_len - 1
        h = np.asarray(history, dtype=np.int32)
        pad = np.full(want, h[-1] if h.size else 0, np.int32)
        if h.size <= self.n:
            return pad
        tail = h[-self.n:]
        # most recent earlier occurrence wins
        windows = np.lib.stride_tricks.sliding_window_view(h[:-1], self.n)
        hits = np.nonzero((windows == tail).all(axis=1))[0]
        if hits.size == 0:
            return pad
        start = int(hits[-1]) + self.n      # first token AFTER the match
        cont = h[start:start + want]
        if cont.size < want:
            cont = np.concatenate(
                [cont, np.full(want - cont.size,
                               cont[-1] if cont.size else h[-1], np.int32)])
        return cont.astype(np.int32)

    def propose_batch(self, histories: List[Sequence[int]]) -> np.ndarray:
        """Stacked drafts for a batch of histories: (len, spec_len - 1)."""
        return np.stack([self.propose(h) for h in histories]) \
            if histories else np.zeros((0, self.spec_len - 1), np.int32)
