"""The reference decoder stack and the two readings the benchmark takes
from it: a training loss with its gradient, and next-token logits over a
served request. The layer's FFN and the weights' layout come from the
model type's own module beside this one (``qwen3.py``),
found by the configuration's ``model_type``. Parameters are nested dicts
of float32 tensors, every ``blocks`` leaf stacked on a leading layer dim
(the layout the benchmark draws its weights in)."""
from __future__ import annotations

import importlib
from typing import Callable, Dict, List, Sequence

import torch
from torch.utils.checkpoint import checkpoint

from .common import Prec, attention_block, nll, rms_norm


def model_module(cfg: dict):
    return importlib.import_module(f"{__package__}.{cfg['model_type']}")


def layer(mod, prec: Prec, p: Dict, x: torch.Tensor, pos: torch.Tensor,
          cfg: dict) -> torch.Tensor:
    eps = cfg["rms_norm_eps"]
    h = x + attention_block(prec, p["attn"], rms_norm(x, p["ln1"], eps),
                            pos, cfg)
    return h + mod.ffn(prec, p, rms_norm(h, p["ln2"], eps), cfg)


def layer_slice(tree, i: int):
    return {k: layer_slice(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def head(params: Dict) -> torch.Tensor:
    emb = params["embed"]
    return emb["unembed"] if "unembed" in emb else emb["embedding"].T


def train_loss(cfg: dict, prec: Prec, params: Dict,
               tokens: torch.Tensor, mask: torch.Tensor = None
               ) -> torch.Tensor:
    """Mean next-token NLL of ``tokens`` (B, S) (positions 0..S-2 predict
    1..S-1, over ``mask[:, 1:]`` where given); each row its own sequence
    (and routing group); each layer recomputed in the backward."""
    mod = model_module(cfg)
    L = cfg["num_hidden_layers"]
    total, count = 0.0, 0.0
    for b in range(tokens.shape[0]):
        row = tokens[b]
        pos = torch.arange(row.numel(), device=row.device)
        x = params["embed"]["embedding"][row]
        for i in range(L):
            x = checkpoint(layer, mod, prec, layer_slice(params["blocks"], i),
                           x, pos, cfg, use_reentrant=False)
        x = rms_norm(x, params["final_norm"], cfg["rms_norm_eps"])
        per = nll(prec.mm(x[:-1], head(params)), row[1:])
        w = torch.ones_like(per) if mask is None else mask[b, 1:].float()
        total = total + (per * w).sum()
        count = count + w.sum()
    return total / count


@torch.no_grad()
def served_logits(cfg: dict, prec: Prec, layer_params: Callable[[int], Dict],
                  outer: Dict, rows: Sequence[torch.Tensor],
                  scored: Sequence[slice]) -> List[torch.Tensor]:
    """Next-token logits (n, V) float32 of each token row in ``rows`` at
    its ``scored`` positions, computed layer by layer over all rows:
    ``layer_params(i)`` gives layer i's parameters (so one layer is held
    at a time) and ``outer`` the embedding, final norm and head."""
    mod = model_module(cfg)
    xs = [outer["embed"]["embedding"][r] for r in rows]
    pos = [torch.arange(r.numel(), device=r.device) for r in rows]
    for i in range(cfg["num_hidden_layers"]):
        p = layer_params(i)
        xs = [layer(mod, prec, p, x, ps, cfg) for x, ps in zip(xs, pos)]
        del p
    out = []
    for x, s in zip(xs, scored):
        h = rms_norm(x[s], outer["final_norm"], cfg["rms_norm_eps"])
        out.append(prec.mm(h, head(outer)))
    return out
