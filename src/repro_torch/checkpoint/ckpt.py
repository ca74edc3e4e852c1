"""Per-expert npz checkpoints (port of ``repro.checkpoint.ckpt``), in the
same layout and the same npz entries, so each package reads what the other
wrote:

    <dir>/expert_<k>/step_<n>.npz      (params + optimizer state + step)
    <dir>/router.npz                    (centroids — the parameter-free router)

Leaves come back as numpy arrays; ``repro_torch.weights`` turns a params
tree into tensors. A bfloat16 leaf is stored as the reference stores one
(``np.savez`` of an ``ml_dtypes`` bfloat16 array writes its raw bits with
dtype ``|V2``): its bits as ``V2``, so no ``ml_dtypes`` is needed here.
``weights.to_tensor`` reads ``|V2`` leaves back as bfloat16.
"""
from __future__ import annotations

import os
import re
from typing import Any, Dict, Optional

import numpy as np
import torch

# zero-length marker entries that keep empty containers in the tree
_EMPTY_FACTORIES = {"__ED": dict, "__EL": list, "__ET": tuple}


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2")
        return t.numpy()
    return np.asarray(leaf)


def _flatten(tree, prefix="") -> Dict[str, np.ndarray]:
    """``/``-joined paths → arrays, dict keys in sorted order (the order
    ``jax.device_get`` leaves the reference's trees in); an empty container
    becomes a zero-length ``__E<tag>`` marker entry."""
    out = {}
    if isinstance(tree, dict):
        if not tree:
            out[f"{prefix}__ED"] = np.zeros(0, np.int8)
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
    elif isinstance(tree, (tuple, list)):
        tag = "T" if isinstance(tree, tuple) else "L"
        if not tree:
            out[f"{prefix}__E{tag}"] = np.zeros(0, np.int8)
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}__{tag}{i}/"))
    else:
        out[prefix.rstrip("/")] = _to_numpy(tree)
    return out


def _unflatten(flat: Dict[str, np.ndarray]):
    tree: Dict[str, Any] = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    def rebuild(node):
        if not isinstance(node, dict):
            return node
        keys = list(node.keys())
        if len(keys) == 1 and keys[0] in _EMPTY_FACTORIES:
            return _EMPTY_FACTORIES[keys[0]]()
        if keys and all(re.fullmatch(r"__[TL]\d+", k) for k in keys):
            items = sorted(keys, key=lambda k: int(k[3:]))
            seq = [rebuild(node[k]) for k in items]
            return tuple(seq) if keys[0][2] == "T" else list(seq)
        return {k: rebuild(v) for k, v in node.items()}

    return rebuild(tree)


def save(path: str, tree) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **_flatten(tree))


def load(path: str):
    with np.load(path, allow_pickle=False) as data:
        return _unflatten({k: data[k] for k in data.files})


def expert_dir(base: str, expert: int) -> str:
    return os.path.join(base, f"expert_{expert}")


def save_expert(base: str, expert: int, step: int, state) -> str:
    path = os.path.join(expert_dir(base, expert), f"step_{step}.npz")
    save(path, state)
    return path


def latest_step(base: str, expert: int) -> Optional[int]:
    d = expert_dir(base, expert)
    if not os.path.isdir(d):
        return None
    steps = [int(m.group(1)) for f in os.listdir(d)
             if (m := re.fullmatch(r"step_(\d+)\.npz", f))]
    return max(steps) if steps else None


def restore_expert(base: str, expert: int, step: Optional[int] = None):
    """(state, step) of expert ``expert`` — the latest step by default;
    (None, None) when it has no checkpoint."""
    step = latest_step(base, expert) if step is None else step
    if step is None:
        return None, None
    return load(os.path.join(expert_dir(base, expert),
                             f"step_{step}.npz")), step


def save_router(base: str, centroids: np.ndarray,
                temperature: float, top_k: int) -> None:
    os.makedirs(base, exist_ok=True)
    np.savez(os.path.join(base, "router.npz"), centroids=centroids,
             temperature=np.float64(temperature), top_k=np.int64(top_k))


def load_router(base: str):
    """(centroids (K, D), temperature, top_k) of the run's router."""
    with np.load(os.path.join(base, "router.npz")) as d:
        return d["centroids"], float(d["temperature"]), int(d["top_k"])
