"""Shared building blocks (port of ``repro.models.layers``): norms, RoPE,
SwiGLU, embeddings, the training loss. Numerics follow the reference: norms and RoPE in
float32, projections in the working dtype, logits upcast to float32.

Every function also takes a stack of K experts' parameters
(``core.ensemble.stack_experts_for_decode``): each leaf then carries a
leading K dim, and the activations carry K folded into their batch, rows
expert-major (expert k's B rows are rows k·B .. k·B + B − 1). A weight
product is then one batched product over K (``expert_matmul``) and a
per-channel parameter pairs expert k's values with expert k's rows
(``per_expert``): the reference's ``jax.vmap`` over the expert dim,
written out. One model's parameters take the unchanged single-model
arithmetic."""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from .params import ParamSpec

Tensor = torch.Tensor


def expert_matmul(x: Tensor, w: Tensor) -> Tensor:
    """x (K·N, ..., D), rows expert-major, times an expert stack w (K, D,
    *out) → (K·N, ..., *out) in x's dtype: one batched product over K."""
    K, D = w.shape[:2]
    y = torch.bmm(x.reshape(K, -1, D), w.reshape(K, D, -1).to(x.dtype))
    return y.reshape(*x.shape[:-1], *w.shape[2:])


def linear(x: Tensor, w: Tensor) -> Tensor:
    """x (..., D) @ w (D, F) in x's dtype, or an expert stack w (K, D, F)
    over expert-major rows (``expert_matmul``)."""
    if w.dim() == 2:
        return x @ w.to(x.dtype)
    return expert_matmul(x, w)


def per_expert(op, x: Tensor, p: Tensor, base: int = 1) -> Tensor:
    """``op(x, p)`` with p (of ``base`` dims) broadcast over x's trailing
    dims; an expert stack p (K, *base dims) pairs expert k's values with
    its rows of x (K·N, ...), expert-major."""
    if p.dim() == base:
        return op(x, p)
    K = p.shape[0]
    xv = x.reshape(K, -1, *x.shape[1:])
    pv = p.reshape(K, *(1,) * (x.dim() - base), *p.shape[1:])
    return op(xv, pv).reshape(x.shape)


def whole_rows(x: Tensor) -> Tensor:
    """``x`` itself, or for a DTensor, ``x`` with only its batch (dim 0)
    and head dims (2 .. ndim−2 of a (B, S, H, dh) layout) left split:
    partial sums are reduced and a split sequence or feature dim gathered
    — the layout a norm over the last dim and the products after it need
    (the residual stream after a row-parallel product is a partial sum,
    and DTensor would otherwise reduce-scatter it over the sequence)."""
    if not hasattr(x, "device_mesh"):
        return x
    from torch.distributed.tensor import Replicate
    keep = [p.is_shard() and (p.dim == 0 or 2 <= p.dim < x.dim() - 1)
            for p in x.placements]
    want = [p if k else Replicate() for k, p in zip(keep, x.placements)]
    return x if want == list(x.placements) else x.redistribute(
        x.device_mesh, want)


def on_local_rows(fn, params, x: Tensor, *args, **kwargs):
    """``fn(params, x, *args, **kwargs)`` for a sub-layer that DTensor
    cannot place — each batch row's arithmetic is its own, so it runs on
    each device's rows: x and every tensor in ``args`` and ``kwargs``
    (states, batch at dim 0, nested in tuples or not) are placed as x's
    batch rows, whole otherwise, and every param is made whole first (an
    explicit all-gather of its split dims, which every device then
    computes with). Every tensor of the output (a tensor or nested tuples)
    comes back placed as the rows; each device's rows give a partial sum
    of the params' gradients over the axes that split the batch."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from repro_torch.tree import tree_from_leaves, tree_leaves, tree_map

    mesh = x.device_mesh
    rows = [Shard(0) if p.is_shard(0) else Replicate() for p in x.placements]
    whole = [Replicate()] * mesh.ndim
    grad = [Partial() if r.is_shard(0) else Replicate() for r in rows]

    def local_rows(t):
        if not isinstance(t, DTensor):
            return t
        return t.redistribute(mesh, rows).to_local(grad_placements=rows)

    paths, leaves = zip(*tree_leaves(params))
    local_params = tree_from_leaves(paths, [
        p.redistribute(mesh, whole).to_local(grad_placements=grad)
        for p in leaves])
    out = fn(local_params, local_rows(x), *tree_map(local_rows, args),
             **tree_map(local_rows, kwargs))
    return tree_map(lambda t: DTensor.from_local(t, mesh, rows,
                                                 run_check=False), out)


def placed_rows(fn):
    """``fn(params, x, cfg, ...)`` through ``on_local_rows`` when x is a
    DTensor, as it is otherwise."""
    import functools

    @functools.wraps(fn)
    def run(params, x, cfg, *args, **kwargs):
        if not hasattr(x, "device_mesh"):
            return fn(params, x, cfg, *args, **kwargs)
        return on_local_rows(
            lambda p, xl, *al, **kl: fn(p, xl, cfg, *al, **kl), params, x,
            *args, **kwargs)

    return run


def rms_norm(x: Tensor, scale: Tensor, eps: float = 1e-5) -> Tensor:
    x = whole_rows(x)
    dtype = x.dtype
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return per_expert(torch.mul, out, scale.float()).to(dtype)


def rope_freqs(head_dim: int, theta: float, device=None) -> Tensor:
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    # a Python-scalar base: a device tensor built from ``theta`` here would
    # be a host-to-device copy, which synchronizes the host with the card
    # on every call
    return 1.0 / torch.pow(theta, exps)


def apply_rope(x: Tensor, positions: Tensor, theta: float) -> Tensor:
    """x: (..., S, H, dh); positions: broadcastable to (..., S). Half-split
    (not interleaved) rotation, computed in float32."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)                 # (dh/2,)
    angles = positions[..., None].float() * freqs           # (..., S, dh/2)
    cos = torch.cos(angles)[..., None, :]                   # (..., S, 1, dh/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def swiglu_specs(d_model: int, d_ff: int) -> Dict[str, ParamSpec]:
    return {
        "w_gate": ParamSpec((d_model, d_ff), ("embed", "mlp"), "scaled"),
        "w_up": ParamSpec((d_model, d_ff), ("embed", "mlp"), "scaled"),
        "w_down": ParamSpec((d_ff, d_model), ("mlp", "embed"), "scaled"),
    }


def swiglu(params: Dict[str, Tensor], x: Tensor) -> Tensor:
    gate = F.silu(linear(x, params["w_gate"]))
    up = linear(x, params["w_up"])
    return linear(gate * up, params["w_down"])


def embedding_specs(vocab: int, d_model: int, tie: bool) -> Dict[str, ParamSpec]:
    specs = {"embedding": ParamSpec((vocab, d_model), ("vocab", "embed"))}
    if not tie:
        specs["unembed"] = ParamSpec((d_model, vocab), ("embed", "vocab"),
                                     "scaled")
    return specs


def embed(params: Dict[str, Tensor], tokens: Tensor, dtype) -> Tensor:
    """tokens (B, ...) → (B, ..., D); an expert stack embeds the same
    tokens with each expert's table, (K·B, ..., D) expert-major. A table
    placed on a mesh takes ``_embed_placed``."""
    table = params["embedding"]
    if table.dim() == 3:
        return table[:, tokens].flatten(0, 1).to(dtype)
    if hasattr(table, "device_mesh"):
        return _embed_placed(table, tokens, dtype)
    return table[tokens].to(dtype)


def _embed_placed(table, tokens, dtype):
    """The lookup on DTensors, made explicit: the table's ``embed`` dim is
    gathered where it is split (FSDP), each device looks up the ids that
    its rows of the vocab hold (the others read as zero) and the rows are
    summed over the vocab's mesh axes — Megatron's vocab-parallel
    embedding. Left to itself DTensor would move the table to split its
    ``embed`` dim instead, and every layer after it would work on partial
    rows. The output is placed as the tokens, its rows whole."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = table.device_mesh
    whole_d = [Replicate() if p.is_shard(1) else p for p in table.placements]
    if whole_d != list(table.placements):
        table = table.redistribute(mesh, whole_d)
    vocab = [p.is_shard(0) for p in whole_d]
    tok = list(tokens.placements)
    if any(v and not t.is_replicate() for v, t in zip(vocab, tok)):
        raise ValueError(f"tokens {tok} are split over the vocab's mesh "
                         f"axes {whole_d}")
    rows = [Shard(0) if t.is_shard(0) else Replicate() for t in tok]
    out = [Partial() if v else r for v, r in zip(vocab, rows)]
    n_local = table.to_local().shape[0]
    coord, idx = mesh.get_coordinate(), 0
    for i, v in enumerate(vocab):
        if v:
            idx = idx * mesh.size(i) + coord[i]
    lo = idx * n_local

    def local(t, ids):
        if not any(vocab):             # the whole table: the plain lookup
            return t[ids]
        ids = ids - lo
        hit = (ids >= 0) & (ids < n_local)
        return t[ids.clamp(0, n_local - 1)] * hit[..., None].to(t.dtype)

    # each device's rows of the batch give a partial sum of the table's
    # gradient over the axes that split the batch
    grad = [Partial() if t.is_shard(0) else p for t, p in zip(tok, whole_d)]
    x = local_map(local, out_placements=out, in_placements=(whole_d, tok),
                  in_grad_placements=(grad, tok),
                  device_mesh=mesh)(table, tokens)
    return x.redistribute(mesh, rows).to(dtype)


def unembed(params: Dict[str, Tensor], x: Tensor, tie: bool,
            true_vocab: int = 0) -> Tensor:
    w = params["embedding"].transpose(-1, -2) if tie else params["unembed"]
    # the product in the working dtype, then float32 for a stable softmax
    logits = linear(x, w).float()
    V = logits.shape[-1]
    if true_vocab and true_vocab < V:      # mask padded vocab rows
        pad = torch.arange(V, device=logits.device) >= true_vocab
        logits = logits.masked_fill(pad, -1e30)
    return logits


def cross_entropy_loss(logits: Tensor, labels: Tensor,
                       mask: Optional[Tensor] = None) -> Tensor:
    """Mean next-token NLL. logits: (B, S, V) float32; labels: (B, S) int;
    mask: (B, S), the positions that count (all when None)."""
    if hasattr(logits, "device_mesh") and any(
            p.is_shard(logits.dim() - 1) for p in logits.placements):
        nll = _nll_placed(logits, labels)
    else:
        logp = torch.log_softmax(logits, dim=-1)
        nll = -logp.gather(-1, labels[..., None].long())[..., 0]
    if mask is None:
        return nll.mean()
    mask = mask.to(nll.dtype)
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)


def _nll_placed(logits, labels):
    """Each row's NLL from DTensor logits whose vocab dim is split
    (Megatron's vocab-parallel cross-entropy, made explicit): each device
    takes its shard's row max, sum of exponentials and — where the label
    falls in its rows — the label's logit, and these are reduced over the
    vocab's mesh axes. Left to itself DTensor would gather the whole
    (B, S, V) logits on every device for the softmax."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = logits.device_mesh
    last = logits.dim() - 1
    vocab = [p.is_shard(last) for p in logits.placements]
    rows = [Shard(0) if p.is_shard(0) else Replicate()
            for p in logits.placements]
    lp = [Shard(last) if v else r for v, r in zip(vocab, rows)]
    if lp != list(logits.placements):
        logits = logits.redistribute(mesh, lp)
    if list(labels.placements) != rows:
        labels = labels.redistribute(mesh, rows)
    n_local = logits.to_local().shape[-1]
    coord, idx = mesh.get_coordinate(), 0
    for i, v in enumerate(vocab):
        if v:
            idx = idx * mesh.size(i) + coord[i]
    lo = idx * n_local

    def reduced(op):
        return [Partial(op) if v else r for v, r in zip(vocab, rows)]

    row_max = local_map(lambda l: l.detach().amax(-1),
                        out_placements=reduced("max"), in_placements=(lp,),
                        device_mesh=mesh)(logits).redistribute(mesh, rows)

    def parts(l, m, y):
        ids = y.long() - lo
        hit = (ids >= 0) & (ids < n_local)
        picked = l.gather(-1, ids.clamp(0, n_local - 1)[..., None])[..., 0]
        return (torch.exp(l - m[..., None]).sum(-1),
                picked * hit.to(l.dtype))

    sums, picked = local_map(
        parts, out_placements=(reduced("sum"), reduced("sum")),
        in_placements=(lp, rows, rows), device_mesh=mesh)(
            logits, row_max, labels)
    return (torch.log(sums.redistribute(mesh, rows)) + row_max
            - picked.redistribute(mesh, rows))
