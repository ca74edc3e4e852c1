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
times. ``make_stacked_serving`` and ``make_stacked_chunk_fns`` are the
twins of the reference's: the stacked prefill and the mixed decode, and
the chunked-prefill companions, with no epilogue (the whole-batch
``DecentralizedServer`` and the mixture core's unfused step run on them).
``make_stacked_fused`` is the twin of the reference's
``make_stacked_fused``: the mixture step plus the serving epilogue over
the mixed probabilities. ``make_stacked_verify``
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


def ensemble_next_token_probs(router, features: Tensor,
                              expert_logits: Tensor) -> Tensor:
    """features: (B, D) routing features for each request; expert_logits:
    (K, B, V) per-expert next-token logits → (B, V) mixed probabilities."""
    return mix_expert_logits(expert_logits, router.route(features))


def stack_expert_params(expert_params: List[Dict[str, Any]]):
    """K per-expert parameter trees → one tree with a leading K dim on
    every leaf (``select_expert_params`` takes one back out)."""
    return tree_map(lambda *leaves: torch.stack(leaves), *expert_params)


def select_expert_params(stacked_params, expert_idx: int):
    """One expert's parameters out of a ``stack_expert_params`` tree (views):
    the top-1 fast path gathers the selected expert alone."""
    return tree_map(lambda leaf: leaf[expert_idx], stacked_params)


def stacked_cache_axes(cache_like):
    """The expert axis of every leaf of a stacked decode cache: 1, after
    its layer (or group) dim (``Model.init_cache(..., experts=K)``)."""
    return tree_map(lambda _: 1, cache_like)


def _expert_dims(tree):
    """The expert dim of every leaf of a parameter tree in the decode
    layout: 1 for the layer stacks (``blocks``, and the audio family's
    ``encoder/blocks``), after their layer dim; 0 for every other leaf."""
    return {name: tree_map(lambda _: 1, sub) if name == "blocks"
            else _expert_dims(sub) if isinstance(sub, dict) else 0
            for name, sub in tree.items()}


def stack_experts_for_decode(expert_params: List[Dict[str, Any]]):
    """K experts' parameter trees → one tree in the decode layout: every
    leaf of a layer stack (``blocks``, ``encoder/blocks``) carries K at
    axis 1, after its layer dim, (L, K, ...); every other leaf (``embed``,
    ``final_norm``, ``shared_attn``, the encoder's ``in_proj`` and
    ``norm``) leads with K. The reference stores the layer stacks
    layer-major so its vmapped scan is transpose-free; the port's layer
    loops slice layer i as a (K, ...) view the same way. The stack is a
    copy: the experts' own tensors are left as they are."""
    return tree_map(lambda dim, *leaves: torch.stack(leaves, dim=dim),
                    _expert_dims(expert_params[0]), *expert_params)


def expert_slice(stacked, k: int):
    """Expert ``k``'s parameters out of a stack in the decode layout
    (``stack_experts_for_decode``), as views: layer-stack leaves select
    axis 1, every other leaf axis 0."""
    return tree_map(lambda dim, t: t.select(dim, k), _expert_dims(stacked),
                    stacked)


def make_stacked_serving(model, expert_params, cache_len: int, *,
                         paged: bool = False):
    """The stacked-expert decode core of the mixture servers
    (``DecentralizedServer``, the mixture core's unfused step): the experts
    stacked in the decode layout plus the whole-ensemble steps. Returns
    ``(stacked, prefill_all, mix_decode)``:

    * ``prefill_all(stacked, batch)`` → ``(logits (K, B, S, V), caches)``
      with K at axis 1 of every cache leaf;
    * ``mix_decode(stacked, caches, tok, pos, weights)`` → ``(Eq. 27
      mixed probabilities (B, V), caches)``: one stacked decode forward
      under the (B, K) router ``weights``. With ``paged`` it takes the
      per-slot block tables as a trailing argument, shared by the K
      experts."""
    def prefill_all(sp, batch):
        return model.prefill(sp, batch, cache_len)

    return (stack_experts_for_decode(expert_params), prefill_all,
            _mix_decode(model, paged))


def _mix_decode(model, paged: bool):
    """``mix_decode`` of ``make_stacked_serving``."""
    def mix_decode(sp, caches, tok, pos, weights, *tables):
        if paged:
            logits, caches = model.decode_step_paged(sp, caches, tok, pos,
                                                     *tables)
        else:
            logits, caches = model.decode_step(sp, caches, tok, pos)
        return mix_expert_logits(logits, weights), caches
    return mix_decode


def make_stacked_chunk_fns(model, cache_len: int):
    """Chunked-prefill companions to ``make_stacked_serving``: ``(prep_all,
    chunk_all)``.

    * ``prep_all(stacked, batch)`` → (the embedded prompt (K, W, D), one
      row per expert, and the per-expert chunk carry with K at axis 1 of
      every leaf, where the stacked cache keeps it);
    * ``chunk_all(stacked, caches, carry, xc, start, length, block_table,
      weights)`` → (the Eq. 27 mixed next-token probabilities (1, V) at
      the chunk's last valid position under the (1, K) ``weights``, carry,
      caches): one stacked ``prefill_chunk``, the table shared by the K
      experts."""
    def prep_all(sp, batch):
        return model.embed_prompt(sp, batch), \
            model.init_chunk_carry(sp, batch, cache_len)

    def chunk_all(sp, caches, carry, xc, start, length, block_table,
                  weights):
        logits, carry, caches = model.prefill_chunk(
            sp, caches, carry, xc, start, length, block_table)
        return mix_expert_logits(logits, weights), carry, caches

    return prep_all, chunk_all


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
    mix_decode = _mix_decode(model, paged)
    _, chunk_all = make_stacked_chunk_fns(model, cache_len)

    def step(sp, c, st):
        tables = (st["tables"],) if paged else ()
        probs, c = mix_decode(sp, c, st["tok"], st["pos"], st["weights"],
                              *tables)
        st, nxt, done = decode_epilogue(probs, st, cache_len=cache_len,
                                        from_probs=True)
        return c, st, nxt, done

    def chunk_only(sp, c, carry, xc, start, ln, cbt, w_row, *pick):
        probs, carry, c = chunk_all(sp, c, carry, xc, start, ln, cbt, w_row)
        return pick_first(probs, *pick, from_probs=True), carry, c

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
