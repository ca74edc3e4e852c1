"""Fused AdamW update (CUDA, ``csrc/adamw.cu``) beside its plain PyTorch
version. It replaces no Pallas kernel: the reference's AdamW
(``repro/optim/adamw.py``) is plain ``jnp`` that XLA fuses under ``jit``;
the eager port's loop body ran as about fifteen float32 passes over each
leaf, and the kernel is that body in one in-place pass.

Both take one leaf: the parameter ``p`` (float32 or bf16), its gradient
``g`` (float32 or bf16), the float32 moments ``m`` and ``v`` and the
float32 ``master`` or None (the parameter is then its own master), all
updated in place but ``g``; and the 0-d float32 device scalars ``lr``,
``scale`` (the clip factor), ``b1c`` and ``b2c`` (the bias corrections),
which stay on the device. ``optim.adamw.apply_updates`` calls
``kernels.ops.adamw_update`` once a leaf.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import build

Tensor = torch.Tensor
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def adamw_update(p: Tensor, g: Tensor, m: Tensor, v: Tensor,
                 master: Optional[Tensor], lr: Tensor, scale: Tensor,
                 b1c: Tensor, b2c: Tensor, *, b1: float, b2: float,
                 eps: float, weight_decay: float) -> None:
    """CUDA kernel: one AdamW step of one leaf, in place. Every tensor on
    one card and contiguous (a leading-dim slice ``a[k]`` of a contiguous
    stack is); where a pointer is not 16-byte aligned the kernel takes its
    scalar path. Raises on anything else; allocates nothing."""
    leaves = {"p": p, "g": g, "m": m, "v": v}
    if master is not None:
        leaves["master"] = master
    scalars = {"lr": lr, "scale": scale, "b1c": b1c, "b2c": b2c}
    dev = p.device
    if dev.type != "cuda":
        raise ValueError(f"adamw_update: the CUDA kernel needs CUDA tensors, "
                         f"got {dev}")
    for name, t in {**leaves, **scalars}.items():
        if t.device != dev:
            raise ValueError(f"adamw_update: {name} on {t.device}, p on "
                             f"{dev}")
    if p.dtype not in _DTYPE_CODES or g.dtype not in _DTYPE_CODES:
        raise TypeError(f"adamw_update: p {p.dtype}, g {g.dtype} (float32 "
                        f"or bfloat16 each)")
    for name, t in leaves.items():
        if name not in ("p", "g") and t.dtype != torch.float32:
            raise TypeError(f"adamw_update: {name} is {t.dtype}, not "
                            f"float32")
        if t.shape != p.shape:
            raise ValueError(f"adamw_update: {name} {tuple(t.shape)}, p "
                             f"{tuple(p.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"adamw_update: {name} is not contiguous")
    for name, t in scalars.items():
        if t.numel() != 1 or t.dtype != torch.float32:
            raise TypeError(f"adamw_update: {name} must be one float32 "
                            f"element, got {t.dtype} {tuple(t.shape)}")
    n = p.numel()
    if n == 0:
        return
    lib = build.load("adamw")
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.adamw_update(
            p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(),
            None if master is None else master.data_ptr(),
            lr.data_ptr(), scale.data_ptr(), b1c.data_ptr(), b2c.data_ptr(),
            _DTYPE_CODES[p.dtype], _DTYPE_CODES[g.dtype],
            n, b1, 1 - b1, b2, 1 - b2, eps, weight_decay,
            stream)
    build.check(lib, err, "adamw_update")
    adamw_update.launches += 1


adamw_update.launches = 0


def adamw_update_ref(p: Tensor, g: Tensor, m: Tensor, v: Tensor,
                     master: Optional[Tensor], lr: Tensor, scale: Tensor,
                     b1c: Tensor, b2c: Tensor, *, b1: float, b2: float,
                     eps: float, weight_decay: float) -> None:
    """Plain version: the eager passes ``apply_updates`` ran on each leaf
    before the kernel, unchanged (two float32 temporaries of the leaf)."""
    w = p if master is None else master
    g32 = g.float() * scale
    m.mul_(b1).add_(g32, alpha=1 - b1)
    v.mul_(b2).addcmul_(g32, g32, value=1 - b2)
    denom = torch.div(v, b2c, out=g32).sqrt_().add_(eps)
    step = (m / b1c).div_(denom)
    del g32, denom
    step.add_(w.float(), alpha=weight_decay)
    if master is not None:
        master.sub_(step.mul_(lr))
        p.copy_(master)
    else:
        p.copy_(w.float() - step.mul_(lr))
