"""The kernel seam (port of ``repro/kernels/ops.py``), dispatching on the
device of the tensors it is given:

* a CUDA tensor launches the hand-written CUDA kernel — if the build or the
  launch fails, the call raises;
* a CPU tensor takes the kernel's plain PyTorch version.

There is no fallback from one to the other: the CPU path exists because
the tensors are on the CPU, never because the card or a kernel is missing.

Gradients: ``flash_attention`` is differentiable (port of the reference's
``_flash_vjp`` custom VJP, ``ops.py:25-48``): while autograd records and
an input requires grad it runs through ``FlashAttention``, whose forward
is ``flash_attention_with_lse`` and whose backward is
``flash_attention_bwd`` — kernels on the card, plain versions on the CPU.
Otherwise it makes the forward-only call. Every other entry's kernel has
no backward, so it raises when autograd records and an input requires
grad, on both devices: a kernel output that autograd cannot see would
silently cut the gradient.

DTensors (a model placed on a ``DeviceMesh``, ``train/trainer.py``): an
entry given DTensors runs the same function on each device's local shards
through ``local_map`` (``on_shards``, which the audio family's plain
cross-attention takes too) — attention is local to a device when its
batch is split over the data axes and its heads over ``model``, with
sequence and head_dim whole. Query heads split where the K/V heads are
whole (a KV head count the ``model`` axis does not divide: the rules
leave ``wk``, ``wv`` whole) take, on each device, the KV heads of its own
query heads, and their K/V gradients are partial sums over that axis.
``flash_attention`` under autograd runs ``FlashAttention`` inside the
local function, so both flash kernels see plain tensors.

``decode_attention`` also takes a cache split along its sequence over
any mesh axes (``sharding.rules`` does so where the KV heads do not
divide ``model``, or at batch 1): each device runs the kernel over its
own key range [s0, s0 + S_local) — the fence ``min(pos, S − 1) − s0``,
−1 (an empty fence) where the range lies wholly past pos, which also
covers a full ring — with ``return_lse``, and the partial softmaxes are
merged over the axes that split the sequence (``merge_key_ranges``: M =
max lse, w = exp(lse − M), out = Σ w·o / Σ w, in float32). The merge is
two functional all-reduces on each such axis's group, MAX of the (B, H)
lse then SUM of the packed (B, H, dh + 1) float32 numerator and weight,
so a layer makes 2 collectives per sequence axis, plus one all-gather of
q where the same axis also splits q's heads (each device then computes
every head over its keys, and keeps its own heads of the merged output).
Decode runs under ``no_grad`` (``_no_backward`` refuses it otherwise), so
no gradient placement of the merge is ever read. A cut of head_dim, a
sequence cut of any other entry's operands, and a partial k or v raise
with the placement named; nothing else is redistributed here.
"""
from __future__ import annotations

import math

import torch

from . import chunk_scan as _scan
from . import decode_attention as _decode
from . import flash_attention as _flash
from . import flash_attention_bwd as _bwd
from . import router_scores as _router

Tensor = torch.Tensor


def _is_dtensor(t) -> bool:
    if not isinstance(t, Tensor) or type(t) is Tensor:
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def split_offset(t, dim: int):
    """(mesh dims, first index, local length) of this device's slice of
    DTensor ``t``'s dim ``dim``: the mesh dims that split it, in mesh order
    (the first outermost, as ``sharding.rules.placements`` places a dim
    over several axes), the global index of its first element here, and
    the slice's length. An uneven split raises."""
    mesh = t.device_mesh
    axes = [i for i, p in enumerate(t.placements) if p.is_shard(dim)]
    n = math.prod(mesh.size(i) for i in axes)
    if t.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not divide "
                         f"over its {n} shards")
    coord, idx = mesh.get_coordinate(), 0
    for i in axes:
        idx = idx * mesh.size(i) + coord[i]
    local = t.shape[dim] // n
    return axes, idx * local, local


def merge_key_ranges(out: Tensor, lse: Tensor, reduce):
    """Merge attention over disjoint key ranges from each range's output
    ``out`` (..., dh) and natural-log ``lse`` (...), −inf for a range
    with no live key: M = max lse, w = exp(lse − M), out = Σ w·o / Σ w
    and lse = M + log Σ w, in float32 (float64 for float64 inputs), the
    output cast to out's dtype.
    ``reduce(t, op)`` reduces t over the ranges, op "max" or "sum": the
    seam's all-reduces over the mesh axes that split the keys, or a
    reduction over a leading stacked dim. A row with no live key in any
    range gets a 0 row and lse −inf."""
    m = reduce(lse, "max")
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    w = torch.exp(lse - m)[..., None]
    acc = torch.promote_types(out.dtype, torch.float32)
    tot = reduce(torch.cat([w * out.to(acc), w.to(acc)], -1), "sum")
    den = tot[..., -1:]
    merged = tot[..., :-1] / den.clamp_min(1e-30)
    return merged.to(out.dtype), m + torch.log(den[..., 0])


def on_shards(what: str, fn, q, k, v, rest=(), *, q_head: int,
               kv_head: int, key_range=None):
    """``fn(q, k, v, *rest)`` on each device's shards of DTensors q (batch
    at dim 0, heads at ``q_head``), k and v (batch at 0, KV heads at
    ``kv_head``) and ``rest`` (batch at dim 0) — see the module's
    docstring. The output is placed as q.

    With ``key_range``, k and v (sequence at dim 1) may also be split
    along their sequence: where they are, each device calls
    ``key_range(q, k, v, *rest, s0, S)`` — its keys are positions [s0, s0
    + k.shape[1]) of S — for (out, lse), and the ranges are merged over
    the axes that split the sequence (``merge_key_ranges`` on their
    groups)."""
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = q.device_mesh
    names = mesh.mesh_dim_names or tuple(map(str, range(mesh.ndim)))
    seq = () if key_range is None else (1,)

    def allowed(t, name, dims):
        if not _is_dtensor(t) or t.device_mesh != mesh:
            raise ValueError(f"{what}: {name} is not a DTensor on q's mesh")
        for i, p in enumerate(t.placements):
            if p.is_partial() or (p.is_shard() and p.dim not in dims):
                whole = "head_dim" if seq else "sequence and head_dim"
                raise ValueError(
                    f"{what}: {name} {tuple(t.shape)} is placed {p} over "
                    f"mesh axis {names[i]!r} — the kernel needs {whole} "
                    f"whole on each device (batch and heads may be "
                    f"split); redistribute at the call site")
        return list(t.placements)

    qp = allowed(q, "q", (0, q_head))
    kp = allowed(k, "k", (0, kv_head, *seq))
    if allowed(v, "v", (0, kv_head, *seq)) != kp:
        raise ValueError(f"{what}: k and v are placed differently")
    seq_axes, s0, _ = split_offset(k, 1) if seq else ([], 0, 0)
    out_p = qp
    if any(qp[i].is_shard(q_head) for i in seq_axes):
        # an axis that splits the keys and q's heads: every device there
        # takes every head over its keys (an all-gather of q), and keeps
        # its own heads of the merged output
        qp = [Replicate() if i in seq_axes else p for i, p in enumerate(qp)]
        q = q.redistribute(mesh, qp)
    batch = [p.is_shard(0) for p in qp]
    if [p.is_shard(0) for p in kp] != batch:
        raise ValueError(f"{what}: q {qp} and k {kp} split the batch "
                         f"differently")
    rest_p = [Shard(0) if b else Replicate() for b in batch]
    for t in rest:
        if allowed(t, "a batch operand", (0,)) != rest_p:
            raise ValueError(f"{what}: a batch operand is placed "
                             f"{t.placements}, q's batch {rest_p}")
    head_q = [p.is_shard(q_head) for p in qp]
    head_k = [p.is_shard(kv_head) for p in kp]
    if any(head_k) and head_k != head_q:
        raise ValueError(f"{what}: q {qp} and k {kp} split heads "
                         f"differently")
    sliced = [hq and not hk for hq, hk in zip(head_q, head_k)]
    lo = hi = None
    if any(sliced):
        H, KV = q.shape[q_head], k.shape[kv_head]
        Hl = q.to_local().shape[q_head]
        g = H // KV
        if (Hl % g if Hl >= g else g % Hl) or H % KV:
            raise ValueError(f"{what}: {Hl} of {H} query heads a device do "
                             f"not align with groups of {g} per KV head")
        coord, idx = mesh.get_coordinate(), 0
        for i, s in enumerate(sliced):
            if s:
                idx = idx * mesh.size(i) + coord[i]
        lo, hi = idx * Hl // g, (idx * Hl + Hl - 1) // g + 1
    k_grad = [Partial() if s else p for s, p in zip(sliced, kp)]

    def reduce(t, op):
        for i in seq_axes:
            t = funcol.all_reduce(t, op, (mesh, i))
        return t

    def local(ql, kl, vl, *rl):
        if lo is not None:
            kl = kl.narrow(kv_head, lo, hi - lo).contiguous()
            vl = vl.narrow(kv_head, lo, hi - lo).contiguous()
        if not seq_axes:
            return fn(ql, kl, vl, *rl)
        out, lse = key_range(ql, kl, vl, *rl, s0, k.shape[1])
        return merge_key_ranges(out, lse, reduce)[0]

    out = local_map(local, out_placements=qp,
                    in_placements=(qp, kp, kp, *([rest_p] * len(rest))),
                    in_grad_placements=(qp, k_grad, k_grad,
                                        *([rest_p] * len(rest))),
                    device_mesh=mesh)(q, k, v, *rest)
    return out if qp == out_p else out.redistribute(mesh, out_p)


def _no_dtensor(what: str, *ts) -> None:
    if any(_is_dtensor(t) for t in ts):
        raise NotImplementedError(
            f"{what} has no DTensor seam: call it on each device's local "
            f"tensors")


def _on_card(t: Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {t.device}")


def _records_grad(*ts: Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def _no_backward(what: str, *ts: Tensor) -> None:
    if _records_grad(*ts):
        raise RuntimeError(
            f"{what} has no backward kernel: it was called while autograd "
            f"records and an input requires grad — call it under "
            f"torch.no_grad() or on detached inputs")


#: Set by an observer that counts a kernel's memory as the card's kernel
#: allocates it (``launch.roofline.LocalMemory``): called as
#: ``PLAIN_CALL(fn, *args, **kwargs)`` in place of each plain version that
#: stands in for a kernel on CPU tensors, and returns its result.
PLAIN_CALL = None


def _plain(fn, *args, **kwargs):
    """A kernel's plain version, through ``PLAIN_CALL`` where one is set."""
    if PLAIN_CALL is not None:
        return PLAIN_CALL(fn, *args, **kwargs)
    return fn(*args, **kwargs)


def _flash_fwd(q: Tensor, k: Tensor, v: Tensor, *, causal: bool,
               window: int):
    if _on_card(q):
        return _flash.flash_attention_with_lse(q, k, v, causal=causal,
                                               window=window)
    return _plain(_flash.flash_attention_with_lse_ref, q, k, v, causal=causal,
                  window=window)


def _flash_bwd(q: Tensor, k: Tensor, v: Tensor, out: Tensor, lse: Tensor,
               do: Tensor, *, causal: bool, window: int):
    if _on_card(q):
        return _bwd.flash_attention_bwd(q, k, v, out, lse, do,
                                        causal=causal, window=window)
    return _plain(_bwd.flash_attention_bwd_ref, q, k, v, out, lse, do,
                  causal=causal, window=window)


class FlashAttention(torch.autograd.Function):
    """Flash attention with its gradient from the saved lse: the forward
    saves q, k, v, out and lse; the backward makes ``do`` contiguous and
    runs ``flash_attention_bwd``. Under non-reentrant
    ``torch.utils.checkpoint`` the forward runs again in the backward and
    its saved tensors are the recomputed ones."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        out, lse = _flash_fwd(q, k, v, causal=causal, window=window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd(q, k, v, out, lse, do.contiguous(),
                                causal=ctx.causal, window=ctx.window)
        return dq, dk, dv, None, None


def flash_attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True,
                    window: int = 0) -> Tensor:
    if _is_dtensor(q):
        return on_shards(
            "flash_attention",
            lambda ql, kl, vl: flash_attention(ql, kl, vl, causal=causal,
                                               window=window),
            q, k, v, q_head=2, kv_head=2)
    if _records_grad(q, k, v):
        return FlashAttention.apply(q, k, v, causal, window)
    if _on_card(q):
        return _flash.flash_attention(q, k, v, causal=causal, window=window)
    return _plain(_flash.flash_attention_ref, q, k, v, causal=causal,
                  window=window)


def decode_attention(q: Tensor, k: Tensor, v: Tensor, pos: Tensor, *,
                     window: int = 0, return_lse: bool = False):
    """The contiguous decode (``return_lse``: with its (B, H) lse, plain
    tensors only). DTensors may split the cache along its sequence: see
    the module's docstring."""
    if _is_dtensor(q):
        if return_lse:
            raise NotImplementedError("decode_attention: return_lse on "
                                      "DTensors")

        def key_range(ql, kl, vl, pl, s0, S):
            fence = (pl.clamp(max=S - 1) - s0).clamp(min=-1)
            return decode_attention(ql, kl, vl, fence, return_lse=True)

        return on_shards(
            "decode_attention",
            lambda ql, kl, vl, pl: decode_attention(ql, kl, vl, pl,
                                                    window=window),
            q, k, v, (pos,), q_head=1, kv_head=2, key_range=key_range)
    _no_backward("decode_attention", q, k, v)
    if _on_card(q):
        return _decode.decode_attention(q, k, v, pos, window=window,
                                        return_lse=return_lse)
    return _plain(_decode.decode_attention_ref, q, k, v, pos, window=window,
                  return_lse=return_lse)


def paged_decode_attention(q: Tensor, k_pool: Tensor, v_pool: Tensor,
                           pos: Tensor, block_tables: Tensor, *,
                           window: int = 0) -> Tensor:
    _no_dtensor("paged_decode_attention", q, k_pool, v_pool, pos,
                block_tables)
    _no_backward("paged_decode_attention", q, k_pool, v_pool)
    if _on_card(q):
        return _decode.paged_decode_attention(q, k_pool, v_pool, pos,
                                              block_tables, window=window)
    return _plain(_decode.paged_decode_attention_ref, q, k_pool, v_pool, pos,
                  block_tables, window=window)


def paged_verify_attention(q: Tensor, k_pool: Tensor, v_pool: Tensor,
                           pos: Tensor, block_tables: Tensor) -> Tensor:
    _no_dtensor("paged_verify_attention", q, k_pool, v_pool, pos,
                block_tables)
    _no_backward("paged_verify_attention", q, k_pool, v_pool)
    if _on_card(q):
        return _decode.paged_verify_attention(q, k_pool, v_pool, pos,
                                              block_tables)
    return _plain(_decode.paged_verify_attention_ref, q, k_pool, v_pool, pos,
                  block_tables)


def chunk_prefill_attention(q: Tensor, k_pool: Tensor, v_pool: Tensor,
                            start: int, block_table: Tensor) -> Tensor:
    _no_dtensor("chunk_prefill_attention", q, k_pool, v_pool, block_table)
    _no_backward("chunk_prefill_attention", q, k_pool, v_pool)
    if _on_card(q):
        return _decode.chunk_prefill_attention(q, k_pool, v_pool, start,
                                               block_table)
    return _plain(_decode.chunk_prefill_attention_ref, q, k_pool, v_pool,
                  start, block_table)


def router_scores(x: Tensor, centroids: Tensor,
                  temperature: float) -> Tensor:
    _no_dtensor("router_scores", x, centroids)
    _no_backward("router_scores", x, centroids)
    if _on_card(x):
        return _router.router_scores(x, centroids, temperature)
    return _plain(_router.router_scores_ref, x, centroids, temperature)


def chunk_scan(qc: Tensor, kc: Tensor, vc: Tensor, cum: Tensor):
    _no_dtensor("chunk_scan", qc, kc, vc, cum)
    _no_backward("chunk_scan", qc, kc, vc, cum)
    if _on_card(qc):
        return _scan.chunk_scan(qc, kc, vc, cum)
    return _plain(_scan.chunk_scan_ref, qc, kc, vc, cum)


def reset_launch_counts() -> None:
    """Zero every kernel wrapper's launch counter, and the chunk scan's
    count of calls that took the tensor cores."""
    for fn in KERNELS.values():
        fn.launches = 0
    _scan.chunk_scan.tensor_core_launches = 0


#: Every CUDA kernel wrapper of the port, by name (``flash_attention``
#: launches, and counts, through ``flash_attention_with_lse``).
KERNELS = {
    "paged_decode_attention": _decode.paged_decode_attention,
    "chunk_prefill_attention": _decode.chunk_prefill_attention,
    "router_scores": _router.router_scores,
    "flash_attention": _flash.flash_attention_with_lse,
    "decode_attention": _decode.decode_attention,
    "paged_verify_attention": _decode.paged_verify_attention,
    "chunk_scan": _scan.chunk_scan,
    "flash_attention_bwd": _bwd.flash_attention_bwd,
}
