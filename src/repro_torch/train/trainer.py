"""Training runtime: the train step and the decentralized expert trainer
(port of ``repro.train.trainer``; paper §5.1).

A train state is ``{"params": ..., "opt": ...}`` (nested dicts of tensors,
the reference's layout). The step is one forward, one backward
(``torch.autograd.grad`` with respect to detached aliases of the params)
and one in-place AdamW update; it returns the same state object. Metrics
stay on the device; ``train_host_loop`` reads them back only at log
steps, as the reference does.

While a ``torch.profiler`` records, the step's forward, backward and
update run inside ``repro.train.forward``, ``repro.train.backward`` and
``repro.train.optimizer`` ranges (``obs.engine.host_range``; with no
profiler, one check each).

Decentralized (experts): states carry a leading K dim; the step runs each
expert's slice in turn with nothing shared between them, so experts never
exchange gradients.

Placement on a ``DeviceMesh`` (the reference's ``state_shardings`` and its
pjit-sharded steps): ``state_shardings`` gives each leaf's spec under the
logical rules, ``distribute_state`` makes the leaves DTensors, and the
placed steps run the same single-model step on them. The decentralized one
runs, on each rank, the experts of its own pod — the expert dim lies over
``pod`` (``dexpert``) — each on the pod's ("data", "model") sub-mesh, so
every collective's group lies inside one pod by construction. The dense
one runs one model over the whole mesh, its batch and FSDP ``embed`` axis
over the flattened ("pod", "data").
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.models.model import Model
from repro_torch.models.params import norm_axes, tree_shardings
from repro_torch.obs.engine import host_range
from repro_torch.optim.adamw import AdamWConfig, apply_updates, init_state
from repro_torch.tree import (flat_leaves, tree_from_leaves, tree_leaves,
                              tree_map)

Tensor = torch.Tensor
BATCH_KEYS = ("tokens", "labels", "patches", "frames", "loss_mask")


@dataclass(frozen=True)
class TrainConfig:
    """The reference's ``TrainConfig`` without its ``use_kernel``, which
    it never reads: the port's forward always takes the kernel seam, and
    ``Model.forward`` picks the scans' training form itself."""
    opt: AdamWConfig = field(default_factory=AdamWConfig)


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
    return _train_step(model, cfg)


def _train_step(model: Model, cfg: TrainConfig, placed: bool = False):
    """The train step; ``placed`` for DTensors: each param goes through
    the FSDP all-gather (``_gather_fsdp``) before the forward, and each
    gradient is brought to its param's placement before the update (a
    whole param's gradient comes back as a partial sum over the batch's
    axes: this is its all-reduce)."""

    def train_step(state, batch):
        params = state["params"]
        paths, leaves = zip(*tree_leaves(params))
        live = [p.detach().requires_grad_() for p in leaves]
        with torch.enable_grad():
            with host_range("repro.train.forward"):
                used = list(map(_gather_fsdp(batch), live)) if placed \
                    else live
                loss, _ = model.loss(tree_from_leaves(paths, used), batch)
            with host_range("repro.train.backward"):
                grads = torch.autograd.grad(loss, live)
                if placed:
                    grads = [g.redistribute(p.device_mesh, p.placements)
                             for g, p in zip(grads, leaves)]
        with host_range("repro.train.optimizer"):
            _, _, opt_metrics = apply_updates(
                params, tree_from_leaves(paths, grads), state["opt"],
                cfg.opt)
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


# ---------------------------------------------------------------------------
# Placement on a DeviceMesh
# ---------------------------------------------------------------------------

def state_shardings(model: Model, rules: Dict, mesh,
                    decentralized_k: int = 0, *,
                    count_over_experts: bool = False):
    """Specs of the train state: params, ``m``, ``v`` and ``master`` as the
    params (``tree_shardings``, the expert dim over ``dexpert``); ``count``
    whole, as the reference's trainer places it, or with
    ``count_over_experts`` over ``dexpert`` as its dry run places it — each
    pod then owns its experts' step counts, which the placed decentralized
    step needs."""
    lead = ("dexpert",) if decentralized_k else ()
    ps = tree_shardings(model.param_specs(), rules, mesh,
                        extra_leading_axes=lead)
    count = (None,) * len(lead)
    if count_over_experts and decentralized_k:
        count = (norm_axes(rules["dexpert"]),)
    return {"params": ps,
            "opt": {"m": ps, "v": ps, "master": ps, "count": count}}


def distribute_state(state, specs, mesh):
    """Each leaf of ``state`` through ``distribute_tensor`` with its spec's
    placements (``sharding.rules.placements``). The leaves are replaced in
    place, one at a time, so a full-width state is never held twice."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.sharding.rules import placements

    def place(node, spec):
        for key in (node if isinstance(node, dict) else ()):
            if isinstance(node[key], dict):
                place(node[key], spec[key])
            else:
                node[key] = distribute_tensor(node[key], mesh,
                                              placements(spec[key], mesh))
        return node

    return place(state, specs)


def _gather_fsdp(batch):
    """The FSDP all-gather of a placed step: each param made whole over
    the mesh axes that split the batch (the rules' ZeRO-3 ``embed`` axes;
    no param dim lies over them otherwise), its tensor-parallel shards over
    ``model`` kept. Without it DTensor would keep the weights split and
    split the activations' ``embed`` dim to match, leaving partial sums
    where attention needs whole rows."""
    from torch.distributed.tensor import Replicate

    split = [p.is_shard(0) for p in batch["tokens"].placements]

    def use(p):
        want = [Replicate() if s else q for s, q in zip(split, p.placements)]
        return p if want == list(p.placements) else p.redistribute(
            p.device_mesh, want)

    return use


def run_placed(fn, *args):
    """``fn(*args)`` on DTensors, the plain tensors made inside it
    (positions, masks) taken as whole on every device."""
    from torch.distributed.tensor.experimental import implicit_replication
    with implicit_replication():
        return fn(*args)


def _full(x):
    return x.full_tensor() if hasattr(x, "full_tensor") else x


def make_placed_train_step(model: Model, cfg: TrainConfig) -> Callable:
    """``make_train_step`` on a state and batch placed on one mesh (the
    dense mode): the same arithmetic, DTensor issuing the collectives.
    Metrics come back whole on every rank."""
    single = _train_step(model, cfg, placed=True)

    def step(state, batch):
        state, metrics = run_placed(single, state, batch)
        return state, {n: _full(m) for n, m in metrics.items()}

    return step


def _pod_dim(mesh) -> Optional[int]:
    names = list(mesh.mesh_dim_names)
    return names.index("pod") if "pod" in names else None


def _expert_slice(t, k: int, mesh, sub, pod: Optional[int]):
    """Expert k's slice of a stacked leaf ``t`` placed on ``mesh``, as a
    DTensor on the pod's sub-mesh ``sub`` over the same local storage (a
    view: the step's in-place updates land in ``t``). Never ``t[k]``: on a
    dim over ``pod`` that is a gather across pods."""
    from torch.distributed.tensor import DTensor, Shard

    local = t.to_local()
    j = k
    if pod is not None and t.placements[pod].is_shard(0):
        per = -(-t.shape[0] // mesh.size(pod))
        j = k - mesh.get_local_rank(pod) * per
    rest = []
    for i, p in enumerate(t.placements):
        if i == pod:
            continue
        if p.is_shard(0):
            raise ValueError(f"the expert dim of a {tuple(t.shape)} leaf is "
                             f"split over mesh axis "
                             f"{mesh.mesh_dim_names[i]!r}, not over 'pod'")
        rest.append(Shard(p.dim - 1) if p.is_shard() else p)
    shape = tuple(t.shape[1:])
    stride = tuple(torch.empty(shape, device="meta").stride())
    return DTensor.from_local(local[j], sub, rest, run_check=False,
                              shape=shape, stride=stride)


def pod_experts(stacked, mesh) -> range:
    """The experts this rank runs: its pod's share of the stacked K when
    the expert dim lies over ``pod``, all K otherwise (a mesh without a
    pod axis, or the dim whole)."""
    leaves = flat_leaves(stacked)
    K = leaves[0].shape[0]
    pod = _pod_dim(mesh)
    over = {t.placements[pod].is_shard(0) for t in leaves} \
        if pod is not None else {False}
    if len(over) > 1:
        raise ValueError("some leaves put the expert dim over 'pod' and some "
                         "keep it whole: place them alike (state_shardings "
                         "with count_over_experts=True)")
    if not over.pop():
        return range(K)
    per = -(-K // mesh.size(pod))
    lo = mesh.get_local_rank(pod) * per
    return range(lo, min(lo + per, K))


def make_placed_decentralized_train_step(model: Model, cfg: TrainConfig,
                                         mesh) -> Callable:
    """(stacked state, stacked batch), DTensors on ``mesh`` with the expert
    dim over ``pod`` → (the same state, updated in place, and (K,)
    metrics over ``pod``). Each rank runs its pod's experts
    (``pod_experts``), one after another, each on the pod's ("data",
    "model") sub-mesh: every collective stays inside one pod."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    single = _train_step(model, cfg, placed=True)
    pod = _pod_dim(mesh)
    names = [n for n in mesh.mesh_dim_names if n != "pod"]
    sub = mesh[tuple(names)] if pod is not None else mesh

    def step(stacked, batch):
        experts = pod_experts(stacked, mesh)
        K = next(iter(batch.values())).shape[0]
        metrics = []
        for k in experts:
            state_k = tree_map(
                lambda t: _expert_slice(t, k, mesh, sub, pod), stacked)
            batch_k = {n: _expert_slice(b, k, mesh, sub, pod)
                       for n, b in batch.items()}
            _, m = run_placed(single, state_k, batch_k)
            metrics.append({n: _full(v) for n, v in m.items()})
        split = len(experts) < K
        place = [Shard(0) if (i == pod and split) else Replicate()
                 for i in range(mesh.ndim)]
        return stacked, {
            n: DTensor.from_local(torch.stack([m[n] for m in metrics]),
                                  mesh, place, run_check=False,
                                  shape=(K,), stride=(1,))
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
