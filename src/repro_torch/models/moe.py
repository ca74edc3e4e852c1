"""Mixture-of-Experts FFN (port of ``repro.models.moe``): shared + routed
experts, top-k token routing with GShard capacity dispatch.

Two notions of "expert" meet here. The routed experts are part of one
model's architecture (DeepSeek-MoE, Qwen3-MoE): E of them a layer, each
token choosing ``top_k``. The paper's decentralized experts are whole
models, which the serving paths stack K of on a leading dim
(``core.ensemble.stack_experts_for_decode``). So that the two cannot be
confused, this module calls the per-token choices ``top_k`` and the size
of a decentralized stack ``stack``, which the caller takes from
``model.n_stacked(params)``. Nothing here infers it from a weight's rank:
one model's routed weights are already 3-D, (E, D, Fe); a stack's are
(stack, E, D, Fe), its router (stack, D, E), its shared experts' weights
(stack, D, F).

Each row of ``x`` is a routing group with its own capacity
``C = int(S·top_k·cf/E)``, S being the row's width at the call site. So
which (token, choice) pairs are dropped depends on the site, exactly as
in the reference: the padded chunk under chunked prefill, the prompt
under monolithic prefill, the span under verify, 1 under decode. A
stack's rows (stack·B, S, D), expert-major, are each their own group too,
as the reference's ``jax.vmap`` over the stack gives.

The reference moves rows with dense one-hot (B, S, E, C) einsums. The
port moves the same rows by index: each kept pair's capacity slot
(e, b, c) takes its token's row and every other slot zeros, which is what
the one-hot einsum computes, exactly. Each token then sums its kept
choices' expert outputs times their weights in float32 and rounds once to
the working dtype, as the combine einsum accumulates; only the order of
that sum of ``top_k`` terms differs from the reference's. The expert
products stay dense over every routed expert's capacity buffer (E·C rows a
group), as in the reference.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .layers import expert_matmul, on_local_rows, swiglu_specs
from .params import ParamSpec

Tensor = torch.Tensor

#: Off (None) unless a caller measures drops: then a dict that each
#: ``moe_ffn`` call adds its kept and routed (token, choice) pair counts
#: to, under the group width S of the call, as device tensors (no
#: synchronisation): ``{S: [kept, pairs]}``. Padded rows of a chunk count
#: among the pairs; they come after the valid rows, so they never take a
#: valid row's capacity.
DROP_TALLY: Optional[Dict[int, list]] = None


def moe_specs(cfg) -> Dict[str, ParamSpec]:
    D, E, Fe = cfg.d_model, cfg.moe.n_experts, cfg.moe.d_ff_expert
    specs = {
        "router": ParamSpec((D, E), ("embed", None), "scaled"),
        "w_gate": ParamSpec((E, D, Fe), ("expert", "embed", "expert_mlp"),
                            "scaled"),
        "w_up": ParamSpec((E, D, Fe), ("expert", "embed", "expert_mlp"),
                          "scaled"),
        "w_down": ParamSpec((E, Fe, D), ("expert", "expert_mlp", "embed"),
                            "scaled"),
    }
    if cfg.moe.n_shared > 0:
        specs["shared"] = swiglu_specs(D, cfg.moe.n_shared * Fe)
    return specs


def _capacity(n_tokens: int, n_experts: int, top_k: int,
              factor: float) -> int:
    cap = int(n_tokens * top_k * factor / n_experts)
    return max(cap, 1)


def route_topk(router_logits: Tensor, top_k: int) -> Tuple[Tensor, Tensor]:
    """Per-token top-k routing. logits (..., E) → (weights (..., top_k) in
    the logits' dtype, softmaxed over the chosen experts; idx (..., top_k)
    int64). The reference's argmax-and-mask loop in float32: the first
    index wins a tie, and the choices come out in descending order, which
    sets each pair's capacity position. Each chosen logit is lowered by
    1e30 before the next argmax, as the reference does."""
    work = router_logits.float()
    lower = work.new_full((*work.shape[:-1], 1), -1e30)
    gates, idxs = [], []
    for _ in range(top_k):
        idx = work.argmax(dim=-1, keepdim=True)
        gates.append(work.gather(-1, idx))
        work = work.scatter_add(-1, idx, lower)
        idxs.append(idx)
    weights = torch.softmax(torch.cat(gates, dim=-1), dim=-1)
    return weights.to(router_logits.dtype), torch.cat(idxs, dim=-1)


def _product(x: Tensor, w: Tensor, stack: int) -> Tensor:
    """x @ w in x's dtype: one model's w (D, F), or a stack's (stack, D, F)
    over expert-major rows."""
    return expert_matmul(x, w) if stack else x @ w.to(x.dtype)


def _shared(p: Dict[str, Tensor], x: Tensor, stack: int) -> Tensor:
    gate = F.silu(_product(x, p["w_gate"], stack))
    return _product(gate * _product(x, p["w_up"], stack), p["w_down"],
                    stack)


def capacity_slots(idx: Tensor, capacity: int, n_experts: int
                   ) -> Tuple[Tensor, Tensor]:
    """Each (token, choice) pair's position in its routed expert's buffer
    of its row (group), and whether it is kept. idx: (R, S, top_k) →
    (pos, keep), both (R, S, top_k): the position counts the pairs before
    it, in (token, choice) order, that chose the same expert in the same
    row; a pair at or past ``capacity`` is dropped."""
    R, S, top_k = idx.shape
    flat = idx.reshape(R, S * top_k)
    onehot = F.one_hot(flat, n_experts)                   # (R, S·top_k, E)
    pos = onehot.cumsum(1).gather(-1, flat[..., None])[..., 0] - 1
    pos = pos.reshape(R, S, top_k)
    return pos, pos < capacity


def moe_ffn(params: Dict[str, Tensor], x: Tensor, cfg,
            stack: int = 0) -> Tensor:
    """x (R, S, D) → (R, S, D) in x's dtype; each row a routing group.
    ``stack`` = K for a stack of K models' parameters (rows expert-major,
    R = K·B), 0 for one model's. Placed on a mesh (DTensors), it runs on
    each device's rows with the expert weights gathered whole
    (``layers.on_local_rows``): DTensor has no placement for the capacity
    dispatch's scatter."""
    if hasattr(x, "device_mesh"):
        return on_local_rows(lambda p, h: moe_ffn(p, h, cfg, stack),
                             params, x)
    R, S, D = x.shape
    E, top_k = cfg.moe.n_experts, cfg.moe.top_k
    C = _capacity(S, E, top_k, cfg.moe.capacity_factor)
    n_stack = stack or 1
    B = R // n_stack
    dt, dev = x.dtype, x.device

    logits = _product(x, params["router"], stack)            # (R, S, E)
    weights, idx = route_topk(logits, top_k)                 # (R, S, top_k)
    pos, keep = capacity_slots(idx, C, E)
    if DROP_TALLY is not None:
        kept, pairs = DROP_TALLY.setdefault(S, [0, 0])
        DROP_TALLY[S] = [kept + keep.sum(), pairs + keep.numel()]

    # each kept pair's slot in the (stack, E, B, C) buffers; the dropped
    # ones all go to one spare slot past the end
    n_slots = n_stack * E * B * C
    row = torch.arange(R, device=dev)[:, None, None]
    slot = (((row // B) * E + idx) * B + row % B) * C + pos
    slot = torch.where(keep, slot, n_slots)
    # the token row that fills each slot; the zero row R·S fills the rest
    src = torch.full((n_slots + 1,), R * S, dtype=torch.long, device=dev)
    tok = torch.arange(R * S, device=dev).reshape(R, S, 1)
    src.scatter_(0, slot.reshape(-1), tok.expand(R, S, top_k).reshape(-1))
    rows = torch.cat([x.reshape(R * S, D), x.new_zeros(1, D)])
    expert_in = rows[src[:n_slots]].reshape(n_stack * E, B * C, D)

    def weight(name):
        w = params[name]
        return w.reshape(n_stack * E, *w.shape[-2:]).to(dt)

    gate = F.silu(torch.bmm(expert_in, weight("w_gate")))
    up = torch.bmm(expert_in, weight("w_up"))
    expert_out = torch.bmm(gate * up, weight("w_down"))      # (·E, B·C, D)
    expert_out = torch.cat([expert_out.reshape(n_slots, D),
                            expert_out.new_zeros(1, D)])
    picked = expert_out[slot]                                # (R, S, k, D)
    w = weights.masked_fill(~keep, 0)
    out = (picked.float() * w.float()[..., None]).sum(2).to(dt)

    if cfg.moe.n_shared > 0:
        out = out + _shared(params["shared"], x, stack)
    return out


def load_balance_stats(router_logits: Tensor, top_k: int
                       ) -> Dict[str, Tensor]:
    """Aux monitoring: expert load entropy (normalised by log E) and the
    largest expert's share of the routed pairs."""
    E = router_logits.shape[-1]
    _, idx = route_topk(router_logits, top_k)
    counts = torch.bincount(idx.reshape(-1), minlength=E)
    load = counts / counts.sum().clamp_min(1)
    entropy = -(load * torch.log(load.clamp_min(1e-9))).sum() / math.log(E)
    return {"load_entropy": entropy, "max_load": load.max()}
