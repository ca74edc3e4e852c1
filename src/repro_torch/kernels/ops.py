"""The kernel seam (port of ``repro/kernels/ops.py``), dispatching on the
device of the tensors it is given:

* a CUDA tensor launches the hand-written CUDA kernel — if the build or the
  launch fails, the call raises;
* a CPU tensor takes the kernel's plain PyTorch version.

There is no fallback from one to the other: the CPU path exists because
the tensors are on the CPU, never because the card or a kernel is missing.
"""
from __future__ import annotations

import torch

from . import chunk_scan as _scan
from . import decode_attention as _decode
from . import flash_attention as _flash
from . import router_scores as _router

Tensor = torch.Tensor


def _on_card(t: Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {t.device}")


def flash_attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True,
                    window: int = 0) -> Tensor:
    if _on_card(q):
        return _flash.flash_attention(q, k, v, causal=causal, window=window)
    return _flash.flash_attention_ref(q, k, v, causal=causal, window=window)


def decode_attention(q: Tensor, k: Tensor, v: Tensor, pos: Tensor, *,
                     window: int = 0) -> Tensor:
    if _on_card(q):
        return _decode.decode_attention(q, k, v, pos, window=window)
    return _decode.decode_attention_ref(q, k, v, pos, window=window)


def paged_decode_attention(q: Tensor, k_pool: Tensor, v_pool: Tensor,
                           pos: Tensor, block_tables: Tensor, *,
                           window: int = 0) -> Tensor:
    if _on_card(q):
        return _decode.paged_decode_attention(q, k_pool, v_pool, pos,
                                              block_tables, window=window)
    return _decode.paged_decode_attention_ref(q, k_pool, v_pool, pos,
                                              block_tables, window=window)


def paged_verify_attention(q: Tensor, k_pool: Tensor, v_pool: Tensor,
                           pos: Tensor, block_tables: Tensor) -> Tensor:
    if _on_card(q):
        return _decode.paged_verify_attention(q, k_pool, v_pool, pos,
                                              block_tables)
    return _decode.paged_verify_attention_ref(q, k_pool, v_pool, pos,
                                              block_tables)


def chunk_prefill_attention(q: Tensor, k_pool: Tensor, v_pool: Tensor,
                            start: int, block_table: Tensor) -> Tensor:
    if _on_card(q):
        return _decode.chunk_prefill_attention(q, k_pool, v_pool, start,
                                               block_table)
    return _decode.chunk_prefill_attention_ref(q, k_pool, v_pool, start,
                                               block_table)


def router_scores(x: Tensor, centroids: Tensor,
                  temperature: float) -> Tensor:
    if _on_card(x):
        return _router.router_scores(x, centroids, temperature)
    return _router.router_scores_ref(x, centroids, temperature)


def chunk_scan(qc: Tensor, kc: Tensor, vc: Tensor, cum: Tensor):
    if _on_card(qc):
        return _scan.chunk_scan(qc, kc, vc, cum)
    return _scan.chunk_scan_ref(qc, kc, vc, cum)


def reset_launch_counts() -> None:
    """Zero every kernel wrapper's launch counter."""
    for fn in KERNELS.values():
        fn.launches = 0


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
}
