"""The fused decode-step epilogue (port of ``repro.serve.fused``, greedy
branch): pick the next token, check stop ids, the token budget and the
context bound, and advance the per-slot position — as tensor ops on the
device of the scores, so one decode token needs one forward plus this
epilogue and ONE host readback of ``(next_tok, done)``.

Semantics are exactly the reference's:

* stop ids match only *generated* tokens;
* reason precedence is stop > length > truncated;
* the capacity bound is position-exact: position ``cache_len - 1`` is
  decodable, the write that would land at ``cache_len`` is not.

Seeded sampling (``temperature > 0``) is not ported yet (see ROADMAP.md);
``SamplingParams`` refuses it.
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor

#: ``done`` bitmap code → finish reason (0 means "keep decoding").
DONE_REASONS = {1: "stop", 2: "length", 3: "truncated"}


def argmax_tokens(scores: Tensor) -> Tensor:
    """Greedy next token per row, int32 (first index among ties, as
    ``jnp.argmax``)."""
    return torch.argmax(scores, dim=-1).to(torch.int32)


def pick_first(row: Tensor) -> Tensor:
    """First token from a prefill's last-position scores (``row``: (1, V))
    — greedy. Returns the (1,) int32 token on the device."""
    return argmax_tokens(row)


def decode_epilogue(scores: Tensor, state, *, cache_len: int):
    """One lockstep decode step's epilogue as tensor ops.

    scores: (n_slots, V); state: the per-slot device-state dict (see
    ``_SlotTable._device_state``) with tok/pos/counts/max_new (int32),
    active (bool) and stop_ids (int32, padded with -1). Returns
    ``(new_state, next_tok, done)``: finished rows are parked at tok/pos 0
    (the scratch-writing idle configuration) and deactivated; inactive rows
    keep their input token; ``done`` is the ``DONE_REASONS`` bitmap."""
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
