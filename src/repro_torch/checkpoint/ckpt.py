"""Read side of the per-expert npz checkpoints (port of
``repro.checkpoint.ckpt``), in the same layout, so the port serves
checkpoints the JAX package trained:

    <dir>/expert_<k>/step_<n>.npz      (params + optimizer state + step)
    <dir>/router.npz                    (centroids — the parameter-free router)

Leaves come back as numpy arrays; ``repro_torch.weights`` turns a params
tree into tensors.
"""
from __future__ import annotations

import os
import re
from typing import Any, Dict, Optional

import numpy as np

# zero-length marker entries that keep empty containers in the tree
_EMPTY_FACTORIES = {"__ED": dict, "__EL": list, "__ET": tuple}


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


def load(path: str):
    with np.load(path, allow_pickle=False) as data:
        return _unflatten({k: data[k] for k in data.files})


def expert_dir(base: str, expert: int) -> str:
    return os.path.join(base, f"expert_{expert}")


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


def load_router(base: str):
    """(centroids (K, D), temperature, top_k) of the run's router."""
    with np.load(os.path.join(base, "router.npz")) as d:
        return d["centroids"], float(d["temperature"]), int(d["top_k"])
