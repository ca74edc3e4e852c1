"""Intra-chunk linear-attention kernel (CUDA, ``csrc/chunk_scan.cu``) beside
its plain PyTorch version — port of ``repro/kernels/chunk_scan.py:50``, the
inner part of the chunkwise Mamba2-SSD / mLSTM scan
(``models.ssm.chunked_linear_attention``). Per (batch, chunk, head):

    intra[t] = Σ_{s≤t} exp(cum_t − cum_s) · (q_t·k_s) · v_s
    chunk_kv = Σ_s exp(cum_{L−1} − cum_s) · k_s v_sᵀ

The CUDA wrapper takes CUDA tensors only. It has two routes, decided from
dtype and shapes alone before the launch (``tensor_core_route``), never
after a failure:

* tensor cores (``chunk_scan_sm90``): bf16 with dk a multiple of 8 (TMA's
  row strides of Q and K are whole 16 bytes) up to ``TC_MAX_DK``, any dv;
  one launch a call, P and the decayed K split into ``SCAN_PARTS`` bf16
  parts so that the float32 result holds to the float32 tolerance. Two
  kernels behind it, picked from the widths: dk ≤ ``TC_TMA_MAX_DK`` with
  dv a multiple of 8 stages V by TMA (every full-width Mamba2 shape of the
  repo, Zamba2's dk = 64, dv = 160, and the smoke config's L = 16); every
  other width (mLSTM's dk = 384, dv = 385 with the ones channel, any odd
  dv) streams K a 64-column slab at a time and stages V through registers
  (``csrc/chunk_scan.cu`` says why).
* scalar (``chunk_scan``): float32, and bf16 with dk not a multiple of 8
  or past ``TC_MAX_DK``.

``chunk_scan.launches`` counts every call, ``chunk_scan.tensor_core_launches``
the calls that took the tensor cores. ``chunk_scan_ref`` is the plain
version the CPU path and the on-card comparison use (``kernels.ops`` picks
one by the tensors' device).
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import build

Tensor = torch.Tensor
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: Dynamic shared memory one Hopper thread block can have (227 KB).
MAX_SMEM = 232448
#: The tensor-core route takes dk up to this: the wide kernel's Q tile (22
#: slabs of 64 columns) beside its K and V rings fills a block's 227 KB.
TC_MAX_DK = 1408
#: Up to this dk, with dv a multiple of 8, the tensor-core route stages V
#: by TMA (Q and K tiles of at most two slabs, dv in column slices of up to
#: 192); V's rows then start on 16-byte boundaries.
TC_TMA_MAX_DK = 128
#: bf16 parts that P and the decayed K are split into on the tensor-core
#: route (2 or 3, a template constant of the kernel; PERF.md states the
#: errors measured with each).
SCAN_PARTS = 3


def tensor_core_route(dtype: torch.dtype, dk: int, dv: int) -> bool:
    """Whether a call with inputs of ``dtype`` and widths dk, dv takes the
    tensor cores: bf16, dk a multiple of 8 up to ``TC_MAX_DK``, dv ≥ 1.
    Every other call takes the scalar kernels."""
    return dtype == torch.bfloat16 and dk % 8 == 0 and 8 <= dk <= TC_MAX_DK \
        and dv >= 1


def v_by_tma(dk: int, dv: int) -> bool:
    """Whether the tensor-core route stages V by TMA at these widths (and so
    needs vc on a 16-byte boundary): dk ≤ ``TC_TMA_MAX_DK``, dv a multiple
    of 8. Other widths load V through registers."""
    return dk <= TC_TMA_MAX_DK and dv % 8 == 0


def chunk_scan(qc: Tensor, kc: Tensor, vc: Tensor,
               cum: Tensor) -> Tuple[Tensor, Tensor]:
    """CUDA kernel. qc, kc: (B,NC,L,H,dk); vc: (B,NC,L,H,dv), float32 or
    bfloat16 (one dtype); cum: (B,NC,L,H) float32 inclusive cumulative
    log-decay. Returns (intra (B,NC,L,H,dv), chunk_kv (B,NC,H,dk,dv)), both
    float32. The route is ``tensor_core_route``'s; raises on bf16 operands
    of that route that TMA reads and that do not start on 16-byte
    boundaries (qc and kc; vc where ``v_by_tma``), and on a scalar-route
    shape whose tiles do not fit in shared memory."""
    if qc.device.type != "cuda":
        raise ValueError(f"chunk_scan: the CUDA kernel needs CUDA tensors, "
                         f"got {qc.device}")
    code = _DTYPE_CODES.get(qc.dtype)
    if code is None:
        raise TypeError(f"chunk_scan: dtype {qc.dtype} not supported "
                        f"(float32 or bfloat16)")
    for name, t in (("kc", kc), ("vc", vc)):
        if t.dtype != qc.dtype or t.device != qc.device:
            raise TypeError(f"chunk_scan: {name} is {t.dtype} on {t.device}, "
                            f"qc is {qc.dtype} on {qc.device}")
    if cum.dtype != torch.float32 or cum.device != qc.device:
        raise TypeError(f"chunk_scan: cum must be float32 on {qc.device}, "
                        f"got {cum.dtype} on {cum.device}")
    if qc.dim() != 5 or kc.shape != qc.shape or vc.dim() != 5 \
            or vc.shape[:4] != qc.shape[:4] or cum.shape != qc.shape[:4]:
        raise ValueError(
            f"chunk_scan: shapes qc {tuple(qc.shape)}, kc {tuple(kc.shape)}, "
            f"vc {tuple(vc.shape)}, cum {tuple(cum.shape)} do not agree")
    for name, t in (("qc", qc), ("kc", kc), ("vc", vc), ("cum", cum)):
        if not t.is_contiguous():
            raise ValueError(f"chunk_scan: {name} must be contiguous")
    B, NC, L, H, dk = qc.shape
    dv = vc.shape[-1]
    if min(L, dk, dv) < 1:
        raise ValueError(f"chunk_scan: L={L}, dk={dk}, dv={dv} must be >= 1")
    lib = build.load("chunk_scan")
    tensor_cores = tensor_core_route(qc.dtype, dk, dv)
    if tensor_cores:
        tma = (("qc", qc), ("kc", kc)) + ((("vc", vc),) if v_by_tma(dk, dv)
                                          else ())
        for name, t in tma:
            if t.data_ptr() % 16:
                raise ValueError(f"chunk_scan: bf16 {name} must start on a "
                                 f"16-byte boundary (TMA)")
    else:
        need = lib.chunk_scan_smem_bytes(dk, dv)
        if need > MAX_SMEM:
            raise ValueError(
                f"chunk_scan: dk={dk}, dv={dv} needs {need} bytes of shared "
                f"memory per thread block, more than the {MAX_SMEM} a Hopper "
                f"block can have")
    intra = torch.empty((B, NC, L, H, dv), dtype=torch.float32,
                        device=qc.device)
    chunk_kv = torch.empty((B, NC, H, dk, dv), dtype=torch.float32,
                           device=qc.device)
    if B * NC * H == 0:
        return intra, chunk_kv
    stream = torch.cuda.current_stream(qc.device).cuda_stream
    ptrs = (qc.data_ptr(), kc.data_ptr(), vc.data_ptr(), cum.data_ptr(),
            intra.data_ptr(), chunk_kv.data_ptr())
    with torch.cuda.device(qc.device):
        if tensor_cores:
            err = lib.chunk_scan_sm90(*ptrs, B * NC, L, H, dk, dv,
                                      SCAN_PARTS, stream)
        else:
            err = lib.chunk_scan(*ptrs, code, B * NC, L, H, dk, dv, stream)
    build.check(lib, err, "chunk_scan")
    chunk_scan.launches += 1
    chunk_scan.tensor_core_launches += int(tensor_cores)
    return intra, chunk_kv


chunk_scan.launches = 0
chunk_scan.tensor_core_launches = 0


def chunk_scan_ref(qc: Tensor, kc: Tensor, vc: Tensor,
                   cum: Tensor) -> Tuple[Tensor, Tensor]:
    """Plain version, the arithmetic of ``repro/kernels/ref.py:111``
    ``chunk_scan_ref``: q, k, v upcast to float32 (float64 stays float64:
    a check's exact yardstick), the decay matrix masked to −inf above the
    diagonal before the exp, then two products. (The reference model's
    jnp branch, ``repro/models/ssm.py:55-66``, takes the q·k product in
    the input dtype before the upcast; the two agree exactly in
    float32.)"""
    L = qc.shape[2]
    dt = torch.promote_types(qc.dtype, torch.float32)
    qc, kc, vc = qc.to(dt), kc.to(dt), vc.to(dt)
    decay = cum[:, :, :, None, :] - cum[:, :, None, :, :]     # (B,NC,L,L,H)
    tri = torch.ones((L, L), dtype=torch.bool, device=qc.device).tril()
    D = torch.exp(decay.masked_fill(~tri[None, None, :, :, None],
                                    float("-inf")))
    scores = torch.einsum("bclhd,bcmhd->bclmh", qc, kc)
    intra = torch.einsum("bclmh,bcmhv->bclhv", scores * D, vc)
    total = cum[:, :, -1]
    k_dec = kc * torch.exp(total[:, :, None, :] - cum)[..., None]
    chunk_kv = torch.einsum("bclhd,bclhv->bchdv", k_dec, vc)
    return intra, chunk_kv
