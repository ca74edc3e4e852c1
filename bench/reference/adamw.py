"""Plain float32 AdamW (decoupled weight decay on every leaf, global-norm
clipping, linear warmup then cosine or linear decay to ``min_lr_ratio``),
with the hyper-parameters the traffic file states."""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch


def lr_at(opt: dict, t: int) -> float:
    warm = min(t / max(opt["warmup_steps"], 1), 1.0)
    frac = min(max((t - opt["warmup_steps"]) /
                   max(opt["total_steps"] - opt["warmup_steps"], 1), 0.0), 1.0)
    r = opt["min_lr_ratio"]
    if opt["schedule"] == "cosine":
        decay = r + (1 - r) * 0.5 * (1 + math.cos(math.pi * frac))
    elif opt["schedule"] == "linear":
        decay = 1 - (1 - r) * frac
    else:
        decay = 1.0
    return opt["lr"] * warm * decay


class AdamW:
    def __init__(self, opt: dict, leaves: List[Tuple[str, torch.Tensor]]):
        self.opt, self.t = opt, 0
        self.m = {p: torch.zeros_like(x) for p, x in leaves}
        self.v = {p: torch.zeros_like(x) for p, x in leaves}

    @torch.no_grad()
    def step(self, leaves: List[Tuple[str, torch.Tensor]],
             grads: List[torch.Tensor]) -> Dict[str, float]:
        """Update ``leaves`` in place; returns each leaf's clipped gradient
        norm (the gradient as the update takes it)."""
        o = self.opt
        self.t += 1
        gnorm = math.sqrt(sum(float(g.double().square().sum())
                              for g in grads))
        scale = min(o["clip_norm"] / max(gnorm, 1e-9), 1.0) \
            if o["clip_norm"] > 0 else 1.0
        lr = lr_at(o, self.t)
        b1c, b2c = 1 - o["b1"] ** self.t, 1 - o["b2"] ** self.t
        norms = {}
        for (path, p), g in zip(leaves, grads):
            g = g * scale
            norms[path] = float(g.double().norm())
            m, v = self.m[path], self.v[path]
            m.mul_(o["b1"]).add_(g, alpha=1 - o["b1"])
            v.mul_(o["b2"]).addcmul_(g, g, value=1 - o["b2"])
            upd = (m / b1c) / ((v / b2c).sqrt() + o["eps"])
            p.sub_(lr * (upd + o["weight_decay"] * p))
        return norms
