"""The fused decode-step epilogue (port of ``repro.serve.fused``, greedy
branch): pick the next token, check stop ids, the token budget and the
context bound, and advance the per-slot position — as tensor ops on the
device of the scores, so one decode token needs one forward plus this
epilogue and ONE host readback of ``(next_tok, done)``.
``verify_epilogue`` is its speculative sibling: the accept rule over a
verified span, read back as ``(toks, n_emit, done)`` in one transfer.

Semantics are exactly the reference's:

* stop ids match only *generated* tokens;
* reason precedence is stop > length > truncated;
* the capacity bound is position-exact: position ``cache_len - 1`` is
  decodable, the write that would land at ``cache_len`` is not.

With ``from_probs`` the scores are the Eq. 27 mixture's probabilities
(the mixture server's): the pick takes log(max(p, ``PROB_FLOOR``)) first,
as the reference does, so ties below the floor resolve to the first index
exactly as there.

Seeded sampling (``temperature > 0``) is not ported yet (see ROADMAP.md);
``SamplingParams`` refuses it.
"""
from __future__ import annotations

import torch

from repro_torch.core.ensemble import PROB_FLOOR

Tensor = torch.Tensor

#: ``done`` bitmap code → finish reason (0 means "keep decoding").
DONE_REASONS = {1: "stop", 2: "length", 3: "truncated"}


def argmax_tokens(scores: Tensor) -> Tensor:
    """Greedy next token per row, int32 (first index among ties, as
    ``jnp.argmax``)."""
    return torch.argmax(scores, dim=-1).to(torch.int32)


def _floor_log(probs: Tensor) -> Tensor:
    return torch.log(probs.clamp_min(PROB_FLOOR))


def pick_first(row: Tensor, *, from_probs: bool = False) -> Tensor:
    """First token from a prefill's last-position scores (``row``: (1, V);
    mixture probabilities with ``from_probs``) — greedy. Returns the (1,)
    int32 token on the device."""
    return argmax_tokens(_floor_log(row) if from_probs else row)


def decode_epilogue(scores: Tensor, state, *, cache_len: int,
                    from_probs: bool = False):
    """One lockstep decode step's epilogue as tensor ops.

    scores: (n_slots, V) (mixture probabilities with ``from_probs``);
    state: the per-slot device-state dict (see
    ``_SlotTable._device_state``) with tok/pos/counts/max_new (int32),
    active (bool) and stop_ids (int32, padded with -1). Returns
    ``(new_state, next_tok, done)``: finished rows are parked at tok/pos 0
    (the scratch-writing idle configuration) and deactivated; inactive rows
    keep their input token; ``done`` is the ``DONE_REASONS`` bitmap."""
    if from_probs:
        scores = _floor_log(scores)
    active = state["active"]
    act = active.to(torch.int32)
    nxt = torch.where(active, argmax_tokens(scores), state["tok"])
    counts = state["counts"] + act
    pos = state["pos"] + act
    is_stop = active & (nxt[:, None] == state["stop_ids"]).any(dim=-1)
    is_len = active & (counts >= state["max_new"])
    is_trunc = active & (pos >= cache_len)
    zero = torch.zeros_like(nxt)
    done = torch.where(is_stop, 1, torch.where(
        is_len, 2, torch.where(is_trunc, 3, zero))).to(torch.int32)
    fin = done > 0
    new_state = dict(state,
                     tok=torch.where(fin, zero, nxt),
                     pos=torch.where(fin, zero, pos),
                     counts=counts,
                     active=active & ~fin)
    return new_state, nxt, done


def verify_epilogue(scores: Tensor, drafts: Tensor, state, *,
                    cache_len: int):
    """The speculative span's accept/reject and bookkeeping as tensor ops.

    scores: (n_slots, L, V), row j the next-token scores at position
    ``pos + j`` (after the committed token and ``drafts[:, :j]``); drafts:
    (n_slots, L-1) int32; state: as for ``decode_epilogue``.

    The token the vanilla trajectory would emit at offset j is
    ``argmax_tokens(scores[:, j])``; a draft is accepted while it equals
    it (a cumulative product of matches), so offset j's scores count only
    when drafts 1..j all matched and every emitted token saw the vanilla
    prefix. Each offset replays ``decode_epilogue``'s finish checks (count
    ``c0+j+1`` against the budget, position ``p0+j+1`` against the
    context, stop-id membership; precedence stop > length > truncated) and
    the span stops at the first halting offset: ``m = min(n_acc + 1,
    first_halt + 1)`` tokens are emitted, so a stop accepted mid-span
    retires the request once and the dead tail never reaches the host.

    Returns ``(new_state, toks, n_emit, done)``: ``toks`` (n_slots, L) the
    candidate tokens left-aligned (rows of inactive slots zeroed),
    ``n_emit`` (n_slots,) how many are real (≥ 1 for an active slot, ≤ L),
    ``done`` the ``DONE_REASONS`` bitmap; all int32."""
    B, L, _ = scores.shape
    active = state["active"]
    i32 = torch.int32
    dev = scores.device
    true = argmax_tokens(scores)                                  # (B, L)
    if L > 1:
        match = (drafts == true[:, :L - 1]).to(i32)
        n_acc = torch.cumprod(match, dim=1).sum(dim=1).to(i32)
    else:
        n_acc = torch.zeros(B, dtype=i32, device=dev)
    m_max = n_acc + 1            # accepted drafts + the free bonus token
    offs = torch.arange(L, dtype=i32, device=dev)[None, :]
    cnt_after = state["counts"][:, None] + 1 + offs               # (B, L)
    pos_after = state["pos"][:, None] + 1 + offs
    is_stop = (true[:, :, None] == state["stop_ids"][:, None, :]).any(-1)
    is_len = cnt_after >= state["max_new"][:, None]
    is_trunc = pos_after >= cache_len
    halt = is_stop | is_len | is_trunc
    first_halt = torch.where(halt, offs, L).min(dim=1).values.to(i32)
    zero = torch.zeros_like(n_acc)
    m = torch.where(active, torch.minimum(m_max, first_halt + 1), zero)
    halted = active & (first_halt < m_max)
    code = torch.where(is_stop, 1, torch.where(
        is_len, 2, torch.full_like(true, 3))).to(i32)
    h = first_halt.clamp(0, L - 1).long()
    done = torch.where(halted, code.gather(1, h[:, None])[:, 0], zero)
    fin = done > 0
    counts = state["counts"] + m
    pos = state["pos"] + m
    last = true.gather(1, (m - 1).clamp(min=0).long()[:, None])[:, 0]
    nxt = torch.where(active, last, state["tok"])
    new_state = dict(state,
                     tok=torch.where(fin, zero, nxt),
                     pos=torch.where(fin, zero, pos),
                     counts=counts,
                     active=active & ~fin)
    toks = torch.where(active[:, None], true, 0).to(i32)
    return new_state, toks, m, done
