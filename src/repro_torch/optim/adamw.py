"""AdamW with global-norm clipping and float32 master weights (port of
``repro.optim.adamw``).

The reference is functional: ``apply_updates`` returns new params and a
new state. Here the state is a dict of tensors updated IN PLACE under
``torch.no_grad()`` — a functional copy would double the 41.5 GiB of
params, moments and masters that a full-width 8-layer Qwen3-8B expert
holds. Each gradient leaf is upcast to float32 one at a time. ``count``,
the learning rate and the clip scale stay on the device: nothing here
reads back to the host.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.tree import tree_leaves, tree_map

Tensor = torch.Tensor


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4                 # peak; scaled by the schedule
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"         # cosine | linear | constant
    min_lr_ratio: float = 0.1


def lr_at(cfg: AdamWConfig, step: Tensor) -> Tensor:
    """Learning rate at ``step`` (a tensor; float32 result on its
    device): linear warmup, then the schedule's decay."""
    step = step.float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp((step - cfg.warmup_steps) /
                       max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    if cfg.schedule == "cosine":
        decay = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * \
            0.5 * (1 + torch.cos(math.pi * frac))
    elif cfg.schedule == "linear":
        decay = 1.0 - (1 - cfg.min_lr_ratio) * frac
    else:
        decay = torch.ones_like(step)
    return cfg.lr * warm * decay


def init_state(params, keep_master: Optional[bool] = None) -> Dict[str, Any]:
    """m/v in float32 beside each param; a float32 master copy when a param
    is low-precision (or when ``keep_master``); an int32 step count. All on
    the params' device."""
    leaves = [p for _, p in tree_leaves(params)]
    if keep_master is None:
        keep_master = any(p.dtype != torch.float32 for p in leaves)

    def f32(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    state = {"m": tree_map(f32, params), "v": tree_map(f32, params),
             "count": torch.zeros((), dtype=torch.int32,
                                  device=leaves[0].device)}
    if keep_master:
        state["master"] = tree_map(
            lambda p: p.detach().to(torch.float32, copy=True), params)
    return state


def global_norm(tree) -> Tensor:
    """sqrt of the sum of squares of every leaf, in float32."""
    return torch.sqrt(sum(
        torch.linalg.vector_norm(g, dtype=torch.float32).square()
        for _, g in tree_leaves(tree)))


@torch.no_grad()
def apply_updates(params, grads, state, cfg: AdamWConfig
                  ) -> Tuple[Any, Dict[str, Any], Dict[str, Tensor]]:
    """One AdamW step, in place on ``params`` and ``state``. Returns
    (params, state, metrics) — the same objects — with metrics
    {"lr", "grad_norm"} (grad_norm before clipping) as device scalars."""
    count = state["count"]
    count += 1
    lr = lr_at(cfg, count)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0) if cfg.clip_norm > 0 \
        else torch.ones((), device=gnorm.device)
    cf = count.float()
    b1c = 1 - cfg.b1 ** cf
    b2c = 1 - cfg.b2 ** cf
    masters = state.get("master", params)
    for (_, p), (_, g), (_, m), (_, v), (_, master) in zip(
            *(tree_leaves(t) for t in (params, grads, state["m"],
                                       state["v"], masters))):
        g32 = g.float() * scale
        m.mul_(cfg.b1).add_(g32, alpha=1 - cfg.b1)
        v.mul_(cfg.b2).addcmul_(g32, g32, value=1 - cfg.b2)
        denom = torch.div(v, b2c, out=g32).sqrt_().add_(cfg.eps)
        step = (m / b1c).div_(denom)
        del g32, denom
        step.add_(master.float(), alpha=cfg.weight_decay)
        if "master" in state:
            master.sub_(step.mul_(lr))
            p.copy_(master)
        else:
            p.copy_(master.float() - step.mul_(lr))
    return params, state, {"lr": lr, "grad_norm": gnorm}
