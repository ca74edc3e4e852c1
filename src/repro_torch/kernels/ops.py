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
"""
from __future__ import annotations

import torch

from . import chunk_scan as _scan
from . import decode_attention as _decode
from . import flash_attention as _flash
from . import flash_attention_bwd as _bwd
from . import router_scores as _router

Tensor = torch.Tensor


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


def _flash_fwd(q: Tensor, k: Tensor, v: Tensor, *, causal: bool,
               window: int):
    if _on_card(q):
        return _flash.flash_attention_with_lse(q, k, v, causal=causal,
                                               window=window)
    return _flash.flash_attention_with_lse_ref(q, k, v, causal=causal,
                                               window=window)


def _flash_bwd(q: Tensor, k: Tensor, v: Tensor, out: Tensor, lse: Tensor,
               do: Tensor, *, causal: bool, window: int):
    if _on_card(q):
        return _bwd.flash_attention_bwd(q, k, v, out, lse, do,
                                        causal=causal, window=window)
    return _bwd.flash_attention_bwd_ref(q, k, v, out, lse, do,
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
    if _records_grad(q, k, v):
        return FlashAttention.apply(q, k, v, causal, window)
    if _on_card(q):
        return _flash.flash_attention(q, k, v, causal=causal, window=window)
    return _flash.flash_attention_ref(q, k, v, causal=causal, window=window)


def decode_attention(q: Tensor, k: Tensor, v: Tensor, pos: Tensor, *,
                     window: int = 0) -> Tensor:
    _no_backward("decode_attention", q, k, v)
    if _on_card(q):
        return _decode.decode_attention(q, k, v, pos, window=window)
    return _decode.decode_attention_ref(q, k, v, pos, window=window)


def paged_decode_attention(q: Tensor, k_pool: Tensor, v_pool: Tensor,
                           pos: Tensor, block_tables: Tensor, *,
                           window: int = 0) -> Tensor:
    _no_backward("paged_decode_attention", q, k_pool, v_pool)
    if _on_card(q):
        return _decode.paged_decode_attention(q, k_pool, v_pool, pos,
                                              block_tables, window=window)
    return _decode.paged_decode_attention_ref(q, k_pool, v_pool, pos,
                                              block_tables, window=window)


def paged_verify_attention(q: Tensor, k_pool: Tensor, v_pool: Tensor,
                           pos: Tensor, block_tables: Tensor) -> Tensor:
    _no_backward("paged_verify_attention", q, k_pool, v_pool)
    if _on_card(q):
        return _decode.paged_verify_attention(q, k_pool, v_pool, pos,
                                              block_tables)
    return _decode.paged_verify_attention_ref(q, k_pool, v_pool, pos,
                                              block_tables)


def chunk_prefill_attention(q: Tensor, k_pool: Tensor, v_pool: Tensor,
                            start: int, block_table: Tensor) -> Tensor:
    _no_backward("chunk_prefill_attention", q, k_pool, v_pool)
    if _on_card(q):
        return _decode.chunk_prefill_attention(q, k_pool, v_pool, start,
                                               block_table)
    return _decode.chunk_prefill_attention_ref(q, k_pool, v_pool, start,
                                               block_table)


def router_scores(x: Tensor, centroids: Tensor,
                  temperature: float) -> Tensor:
    _no_backward("router_scores", x, centroids)
    if _on_card(x):
        return _router.router_scores(x, centroids, temperature)
    return _router.router_scores_ref(x, centroids, temperature)


def chunk_scan(qc: Tensor, kc: Tensor, vc: Tensor, cum: Tensor):
    _no_backward("chunk_scan", qc, kc, vc, cum)
    if _on_card(qc):
        return _scan.chunk_scan(qc, kc, vc, cum)
    return _scan.chunk_scan_ref(qc, kc, vc, cum)


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
