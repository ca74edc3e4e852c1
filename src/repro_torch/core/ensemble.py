"""Expert-ensemble inference (port of ``repro.core.ensemble``; paper §5.2).

At each decode step the global generating velocity is the router-weighted
sum of expert velocities (Eq. 27), which is the same as mixing the experts'
next-token distributions:

    p_mix(a | prefix) = Σ_k r_k(features) · softmax(logits_k)[a]

with r the top-k-filtered Eq. 28 router.

The reference runs the K experts under ``jax.vmap`` over a stacked
``dexpert`` dim. The port stacks the experts the same way
(``stack_experts_for_decode``) and ``Model``'s serving paths take the
stack directly: K rides in the batch of every activation and kernel launch
(``models/model.py``), so a mixture step launches each kernel once, not K
times. ``make_stacked_fused`` is the twin of the reference's
``make_stacked_fused`` (and, with it, of the decode and chunk halves of
``make_stacked_serving`` and ``make_stacked_chunk_fns``, which the port's
fused-only scheduler does not need apart): the mixture step plus the
serving epilogue over the mixed probabilities. ``make_stacked_verify``
is the twin of the reference's: the span verify of all K experts in one
stacked forward, the Eq. 27 mixture at every span offset and the seeded
accept rule, with drafts from the host (n-gram) or from expert 0's own
greedy decode (``speculative="expert"``).
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch
import torch.nn.functional as F

from repro_torch.tree import tree_map

from .decentralize import mix_expert_distributions

Tensor = torch.Tensor

#: Floor applied before taking logs of mixture probabilities — shared by
#: every consumer (the greedy epilogue, the first-token pick) so the clamp
#: is identical everywhere.
PROB_FLOOR = 1e-30


def mix_expert_logits(expert_logits: Tensor, weights: Tensor, *,
                      log_space: bool = False) -> Tensor:
    """Combine expert next-token logits into ensemble probabilities.

    expert_logits: (K, ..., V); weights: (..., K) (already top-k filtered,
    rows summing to 1). Returns probabilities (..., V) — the exact Eq. 27
    recomposition (probability space, not logit averaging), or their logs
    floored at ``PROB_FLOOR`` with ``log_space``."""
    probs = torch.softmax(expert_logits, dim=-1)            # (K, ..., V)
    mixed = mix_expert_distributions(probs, weights.movedim(-1, 0))
    if log_space:
        return torch.log(mixed.clamp_min(PROB_FLOOR))
    return mixed


def stack_experts_for_decode(expert_params: List[Dict[str, Any]]):
    """K experts' parameter trees → one tree in the decode layout: every
    ``blocks`` leaf carries K at axis 1, after its scanned layer dim, (L, K,
    ...); every other leaf (``embed``, ``final_norm``, ``shared_attn``)
    leads with K. The reference stores the layer stacks layer-major so its
    vmapped scan is transpose-free; the port's layer loop slices layer i as
    a (K, ...) view the same way. The stack is a copy: the experts' own
    tensors are left as they are."""
    stacked = {}
    for name in expert_params[0]:
        dim = 1 if name == "blocks" else 0
        stacked[name] = tree_map(lambda *leaves: torch.stack(leaves, dim=dim),
                                 *(p[name] for p in expert_params))
    return stacked


def expert_slice(stacked, k: int):
    """Expert ``k``'s parameters out of a stack in the decode layout
    (``stack_experts_for_decode``), as views: ``blocks`` leaves select
    axis 1, every other leaf axis 0."""
    return {name: tree_map(lambda t: t.select(1 if name == "blocks" else 0,
                                              k), sub)
            for name, sub in stacked.items()}


def make_stacked_fused(model, cache_len: int, *, paged: bool):
    """``(step, step_chunk, chunk_only)`` over an expert stack, the
    mixture's twins of ``serve.scheduler.make_fused_fns``:

    * ``step(stacked, cache, state)`` → ``(cache, state, next_tok, done)``:
      one stacked decode forward (contiguous, or paged through
      ``state["tables"]``), the Eq. 27 mixture under ``state["weights"]``
      ((n_slots, K) router weights) and the serving epilogue over the
      mixed probabilities;
    * ``step_chunk(stacked, cache, state, carry, xc, start, length, cbt,
      w_row, temp, top_k, seed)`` → the same plus the chunk's first-token
      pick from the mixture of its (K, 1, V) logits under ``w_row`` (1,
      K) — count 0 of the request's seeded stream under the (1,)-tensors
      ``temp, top_k, seed``, or the argmax when they are left out (a
      greedy request) — and the carry;
    * ``chunk_only(stacked, cache, carry, xc, start, length, cbt, w_row,
      temp, top_k, seed)`` → ``(first, carry, cache)`` when nothing is
      decoding.
    """
    # function-level import: serve.fused imports PROB_FLOOR from here
    from repro_torch.serve.fused import decode_epilogue, pick_first

    def step(sp, c, st):
        if paged:
            logits, c = model.decode_step_paged(sp, c, st["tok"], st["pos"],
                                                st["tables"])
        else:
            logits, c = model.decode_step(sp, c, st["tok"], st["pos"])
        st, nxt, done = decode_epilogue(
            mix_expert_logits(logits, st["weights"]), st,
            cache_len=cache_len, from_probs=True)
        return c, st, nxt, done

    def chunk_only(sp, c, carry, xc, start, ln, cbt, w_row, *pick):
        logits, carry, c = model.prefill_chunk(sp, c, carry, xc, start, ln,
                                               cbt)
        return (pick_first(mix_expert_logits(logits, w_row), *pick,
                           from_probs=True), carry, c)

    def step_chunk(sp, c, st, carry, xc, start, ln, cbt, w_row, *pick):
        c, st, nxt, done = step(sp, c, st)
        first, carry, c = chunk_only(sp, c, carry, xc, start, ln, cbt, w_row,
                                     *pick)
        return c, st, nxt, done, first, carry

    return step, step_chunk, chunk_only


def make_stacked_verify(model, cache_len: int, spec_len: int):
    """The mixture's speculative step (twin of the reference's
    ``make_stacked_verify``): ``verify(stacked, cache, state, drafts=None)``
    → ``(cache, state, toks, n_emit, done)``.

    One stacked ``verify_step_paged`` scores the span ``[committed token,
    drafts]`` on all K experts — one paged-verify launch a layer for the
    K·B rows — and the Eq. 27 mixture under ``state["weights"]`` mixes
    them at every offset before the seeded accept rule
    (``verify_epilogue(from_probs=True)``).

    ``drafts`` (B, L − 1) int32 are the host's (n-gram); None drafts on
    the device with expert 0: L − 1 greedy ``decode_step_paged``
    micro-steps of expert 0 alone, each feeding the last draft. The
    reference threads a copy of expert 0's slice of the pool through them
    and discards it; here they run on views of expert 0's parameters and
    pool slice and write the real pool, which is exact and copies nothing:
    they write positions ``pos .. pos + L − 2`` of expert 0 only, and the
    verify's scatter rewrites every span position of every expert before
    anything attends to it. Positions past the table horizon (a slot at
    the end of its context) must not land in a live block, so the draft
    tables are padded with scratch entries (block 0) to cover the whole
    span; the decode write would otherwise clamp into the slot's last
    block."""
    # function-level import: serve.fused imports PROB_FLOOR from here
    from repro_torch.serve.fused import argmax_tokens, verify_epilogue

    def expert_drafts(sp, c, st):
        bs = c["k"].shape[3]
        draft_p = expert_slice(sp, 0)
        draft_c = {name: leaf.select(1, 0) for name, leaf in c.items()}
        tables = F.pad(st["tables"], (0, -(-(spec_len - 1) // bs)))
        tok, drafts = st["tok"], []
        for j in range(spec_len - 1):
            logits, _ = model.decode_step_paged(draft_p, draft_c, tok,
                                                st["pos"] + j, tables)
            tok = argmax_tokens(logits)
            drafts.append(tok)
        return torch.stack(drafts, dim=1)                      # (B, L-1)

    def verify(sp, c, st, drafts=None):
        if drafts is None:
            drafts = expert_drafts(sp, c, st)
        tokens = torch.cat([st["tok"][:, None], drafts], dim=1)
        logits, c = model.verify_step_paged(sp, c, tokens, st["pos"],
                                            st["tables"])    # (K, B, L, V)
        probs = mix_expert_logits(logits, st["weights"][:, None, :])
        st, toks, n_emit, done = verify_epilogue(
            probs, drafts, st, cache_len=cache_len, from_probs=True)
        return c, st, toks, n_emit, done

    return verify
