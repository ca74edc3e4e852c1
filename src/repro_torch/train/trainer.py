"""Training runtime: the train step and the decentralized expert trainer
(port of ``repro.train.trainer``; paper §5.1).

A train state is ``{"params": ..., "opt": ...}`` (nested dicts of tensors,
the reference's layout). The step is one forward, one backward
(``torch.autograd.grad`` with respect to detached aliases of the params)
and one in-place AdamW update; it returns the same state object. Metrics
stay on the device; ``train_host_loop`` reads them back only at log
steps, as the reference does.

Decentralized (experts): states carry a leading K dim; the step runs each
expert's slice in turn with nothing shared between them, so experts never
exchange gradients. Mapping the expert dim onto devices (the reference's
``dexpert`` mesh axis, ``state_shardings``) is not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.models.model import Model
from repro_torch.optim.adamw import AdamWConfig, apply_updates, init_state
from repro_torch.tree import tree_from_leaves, tree_leaves, tree_map

Tensor = torch.Tensor
BATCH_KEYS = ("tokens", "labels", "patches", "frames", "loss_mask")


@dataclass(frozen=True)
class TrainConfig:
    opt: AdamWConfig = field(default_factory=AdamWConfig)
    # kept for parity with the reference, which declares it and never reads
    # it; the port's forward always takes the kernel seam
    use_kernel: bool = False


def init_train_state(model: Model, gen: torch.Generator,
                     opt_cfg: AdamWConfig) -> Dict[str, Any]:
    """Fresh params drawn from ``gen`` (on its device) and their AdamW
    state."""
    params = model.init(gen)
    return {"params": params, "opt": init_state(params)}


def make_train_step(model: Model, cfg: TrainConfig
                    ) -> Callable[[Dict, Dict], Tuple[Dict, Dict]]:
    """(state, batch) → (state, metrics), updating ``state`` in place.
    Metrics {"loss", "lr", "grad_norm"} are device scalars."""

    def train_step(state, batch):
        params = state["params"]
        paths, leaves = zip(*tree_leaves(params))
        live = [p.detach().requires_grad_() for p in leaves]
        with torch.enable_grad():
            loss, _ = model.loss(tree_from_leaves(paths, live), batch)
            grads = torch.autograd.grad(loss, live)
        _, _, opt_metrics = apply_updates(
            params, tree_from_leaves(paths, grads), state["opt"], cfg.opt)
        return state, {"loss": loss.detach(), **opt_metrics}

    return train_step


def make_eval_step(model: Model) -> Callable:
    def eval_step(params, batch):
        with torch.no_grad():
            _, metrics = model.loss(params, batch)
        return metrics
    return eval_step


# ---------------------------------------------------------------------------
# Decentralized expert training (paper §5.1 "Experts training")
# ---------------------------------------------------------------------------

def stack_expert_states(states) -> Dict[str, Any]:
    """K independent train states → one state with a leading K dim on
    every leaf."""
    return tree_map(lambda *leaves: torch.stack(leaves), *states)


def unstack_expert_states(stacked, K: int):
    """The K experts' states as views of the stacked one."""
    return [tree_map(lambda a, k=k: a[k], stacked) for k in range(K)]


def make_decentralized_train_step(model: Model, cfg: TrainConfig) -> Callable:
    """(stacked state, stacked batch) → (stacked state, stacked metrics):
    each expert's single step on its own slice (views of the stacked
    leaves, updated in place), one after another — the same arithmetic as
    K independent steps, with nothing exchanged between experts."""
    single = make_train_step(model, cfg)

    def step(stacked, batch):
        K = next(iter(batch.values())).shape[0]
        metrics = []
        for k, state in enumerate(unstack_expert_states(stacked, K)):
            _, m = single(state, {n: b[k] for n, b in batch.items()})
            metrics.append(m)
        return stacked, {n: torch.stack([m[n] for m in metrics])
                         for n in metrics[0]}

    return step


def to_batch(batch, device) -> Dict[str, Tensor]:
    """The model's inputs of a loader batch, as tensors on ``device``."""
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()
            if k in BATCH_KEYS}


def train_host_loop(model: Model, state, loader, n_steps: int,
                    cfg: TrainConfig, *, log_every: int = 10,
                    callback: Optional[Callable] = None):
    """Single-host training loop: ``n_steps`` steps on ``loader``'s
    batches, on the device of the params. Metrics are read back at every
    ``log_every``-th step and the last one. Returns (state, history)."""
    step_fn = make_train_step(model, cfg)
    device = state["opt"]["count"].device
    history = []
    for step in range(n_steps):
        state, metrics = step_fn(state, to_batch(next(loader), device))
        if step % log_every == 0 or step == n_steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            history.append({"step": step, **m})
            if callback:
                callback(step, m)
    return state, history
