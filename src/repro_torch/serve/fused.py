"""The fused decode-step epilogue (port of ``repro.serve.fused``): pick
the next token (greedy or seeded sampling), check stop ids, the token
budget and the context bound, and advance the per-slot position — as
tensor ops on the device of the scores, so one decode token needs one
forward plus this epilogue and ONE host readback of ``(next_tok, done)``.
``verify_epilogue`` is its speculative sibling: the accept rule over a
verified span, read back as ``(toks, n_emit, done)`` in one transfer.
``sample_tokens``, ``sample_tokens_probs`` and ``argmax_tokens`` are the
unfused step's host epilogue (``fused_step=False``): the pick alone, on
scores the forward already returned.

Semantics are exactly the reference's:

* stop ids match only *generated* tokens;
* reason precedence is stop > length > truncated;
* the capacity bound is position-exact: position ``cache_len - 1`` is
  decodable, the write that would land at ``cache_len`` is not.

With ``from_probs`` the scores are the Eq. 27 mixture's probabilities
(the mixture server's): the pick takes log(max(p, ``PROB_FLOOR``)) first,
as the reference does, so ties below the floor resolve to the first index
exactly as there.

Seeded sampling (``temperature > 0``): token ``c`` of a request with seed
``s`` draws from ``fold_in(PRNGKey(s), c)`` by the Gumbel-max trick over
its top-k-masked, temperature-scaled scores (``_sample_tokens``), with
the reference's threefry bits (``core.prng``), so a request's sampled
continuation depends only on (seed, scores), never on slot placement or
co-scheduled traffic. The speculative accept rule is the seeded one: the
"true" token at span offset j is the draw at count ``c0 + j``. The
epilogues sample only when the state says a decoding slot asks for it
(``state["sampled"]``, a host bool set when the scheduler rebuilds the
state): an all-greedy step takes the argmax and launches nothing more.
"""
from __future__ import annotations

import torch

from repro_torch.core import prng
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


def _perturbed(scores: Tensor, temps: Tensor, top_ks: Tensor,
               seeds: Tensor, counts: Tensor) -> Tensor:
    """The Gumbel-max draw's operand: each row's top-k-masked scores over
    ``max(temps, 1e-6)`` plus the Gumbel noise of ``fold_in(PRNGKey(seed),
    count)``. Row r keeps every score ``>=`` the ascending sort's entry at
    V − k, so ties at the threshold all stay; ``top_ks <= 0`` keeps the
    full vocabulary."""
    V = scores.shape[-1]
    k = torch.where(top_ks <= 0, V, top_ks.clamp(max=V))
    thresh = torch.sort(scores, dim=-1).values.gather(
        -1, (V - k).long()[:, None])
    masked = torch.where(scores >= thresh, scores, float("-inf"))
    scaled = masked / temps.clamp_min(1e-6)[:, None]
    key = prng.fold_in(prng.threefry_seed(seeds), counts)
    return prng.gumbel(prng.random_bits(key, V)) + scaled


def _sample_tokens(scores: Tensor, temps: Tensor, top_ks: Tensor,
                   seeds: Tensor, counts: Tensor) -> Tensor:
    """Per-row seeded sampling (the reference's ``_sample_tokens``).

    scores: (R, V) float32 next-token scores; temps: (R,) float32, rows
    with ``temps <= 0`` take the argmax (first index among ties); top_ks:
    (R,) int32; seeds: (R,) int64 holding uint32 seeds; counts: (R,)
    int32 token indices. A sampled row draws the argmax of ``_perturbed``.
    Returns (R,) int32 tokens."""
    sampled = argmax_tokens(_perturbed(scores, temps, top_ks, seeds, counts))
    return torch.where(temps > 0, sampled, argmax_tokens(scores))


def sample_margin(scores: Tensor, temps: Tensor, top_ks: Tensor,
                  seeds: Tensor, counts: Tensor) -> Tensor:
    """(R,) gap between the two largest entries that a sampled row takes
    the argmax of: how far the draw is from a tie. The noise takes two
    float32 logs, which may differ in the last ulp between libraries and
    devices, so only a draw whose gap is within a few ulps of its top
    value can change with them."""
    top2 = torch.topk(_perturbed(scores, temps, top_ks, seeds, counts), 2,
                      dim=-1).values
    return top2[:, 0] - top2[:, 1]


def _sample_tokens_probs(probs: Tensor, temps: Tensor, top_ks: Tensor,
                         seeds: Tensor, counts: Tensor) -> Tensor:
    """``_sample_tokens`` over Eq. 27 mixture probabilities: the floor and
    log first, as the reference does."""
    return _sample_tokens(_floor_log(probs), temps, top_ks, seeds, counts)


#: The reference's jitted dispatches of the unfused host epilogue, by its
#: public names: per-row seeded sampling over scores, over Eq. 27 mixture
#: probabilities, and the all-greedy argmax (``argmax_tokens`` above).
sample_tokens = _sample_tokens
sample_tokens_probs = _sample_tokens_probs


def pick_first(row: Tensor, temp: Tensor = None, top_k: Tensor = None,
               seed: Tensor = None, *, from_probs: bool = False) -> Tensor:
    """First token from a prefill's last-position scores (``row``: (1, V);
    mixture probabilities with ``from_probs``): count 0 of the request's
    seeded stream under (1,)-tensors ``temp``, ``top_k`` and ``seed``, or
    the argmax when ``temp`` is None (a greedy request). Returns the (1,)
    int32 token on the device."""
    if temp is None:
        return argmax_tokens(_floor_log(row) if from_probs else row)
    sample = _sample_tokens_probs if from_probs else _sample_tokens
    return sample(row, temp, top_k, seed, torch.zeros_like(top_k))


def decode_epilogue(scores: Tensor, state, *, cache_len: int,
                    from_probs: bool = False):
    """One lockstep decode step's epilogue as tensor ops.

    scores: (n_slots, V) (mixture probabilities with ``from_probs``);
    state: the per-slot device-state dict (see
    ``_SlotTable._device_state``) with tok/pos/counts/max_new (int32),
    active (bool), stop_ids (int32, padded with -1) and, when
    ``state["sampled"]``, temps (float32), top_ks (int32) and seeds (int64
    holding uint32 values). Returns
    ``(new_state, next_tok, done)``: finished rows are parked at tok/pos 0
    (the scratch-writing idle configuration) and deactivated; inactive rows
    keep their input token; ``done`` is the ``DONE_REASONS`` bitmap."""
    if from_probs:
        scores = _floor_log(scores)
    active = state["active"]
    act = active.to(torch.int32)
    pick = _sample_tokens(scores, state["temps"], state["top_ks"],
                          state["seeds"], state["counts"]) \
        if state.get("sampled", False) else argmax_tokens(scores)
    nxt = torch.where(active, pick, state["tok"])
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
                    cache_len: int, from_probs: bool = False):
    """The speculative span's accept/reject and bookkeeping as tensor ops.

    scores: (n_slots, L, V), row j the next-token scores at position
    ``pos + j`` (after the committed token and ``drafts[:, :j]``; the
    Eq. 27 mixture's probabilities with ``from_probs``); drafts:
    (n_slots, L-1) int32; state: as for ``decode_epilogue``.

    The token the vanilla trajectory would emit at offset j is the one a
    vanilla step with that prefix draws: count ``c0 + j`` of the
    request's seeded stream (``_sample_tokens``; the argmax for a greedy
    row), all L offsets drawn in one call over the (n_slots·L, V) rows. A
    draft is accepted while it equals it (a cumulative product of
    matches: rejection sampling in its deterministic form, which keeps
    speculation on ≡ off for sampled requests too), so offset j's scores
    count only when drafts 1..j all matched and every emitted token saw
    the vanilla prefix. Each offset replays ``decode_epilogue``'s finish
    checks (count ``c0+j+1`` against the budget, position ``p0+j+1``
    against the context, stop-id membership; precedence stop > length >
    truncated) and the span stops at the first halting offset: ``m =
    min(n_acc + 1, first_halt + 1)`` tokens are emitted, so a stop
    accepted mid-span retires the request once and the dead tail never
    reaches the host.

    Returns ``(new_state, toks, n_emit, done)``: ``toks`` (n_slots, L) the
    candidate tokens left-aligned (rows of inactive slots zeroed),
    ``n_emit`` (n_slots,) how many are real (≥ 1 for an active slot, ≤ L),
    ``done`` the ``DONE_REASONS`` bitmap; all int32."""
    B, L, V = scores.shape
    if from_probs:
        scores = _floor_log(scores)
    active = state["active"]
    i32 = torch.int32
    dev = scores.device
    offs = torch.arange(L, dtype=i32, device=dev)[None, :]
    if state.get("sampled", False):
        rows = {k: state[k].repeat_interleave(L)
                for k in ("temps", "top_ks", "seeds")}
        true = _sample_tokens(
            scores.reshape(B * L, V), rows["temps"], rows["top_ks"],
            rows["seeds"], (state["counts"][:, None] + offs).reshape(-1)
        ).reshape(B, L)
    else:
        true = argmax_tokens(scores)                              # (B, L)
    if L > 1:
        match = (drafts == true[:, :L - 1]).to(i32)
        n_acc = torch.cumprod(match, dim=1).sum(dim=1).to(i32)
    else:
        n_acc = torch.zeros(B, dtype=i32, device=dev)
    m_max = n_acc + 1            # accepted drafts + the free bonus token
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
