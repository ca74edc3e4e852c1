"""Carry parameters across from the JAX reference, without transposes.

The port keeps the reference's pytree layout and einsum layouts, so
conversion is leaf by leaf: a nested dict of arrays (numpy, or anything
``np.asarray`` accepts) — or an npz written by ``repro.checkpoint.ckpt``,
whose keys are the ``/``-joined tree paths — becomes the same nested dict
of tensors. bfloat16 arrays (numpy's ``ml_dtypes`` bfloat16, or the raw
``|V2`` bits an npz holds for a bfloat16 leaf) cross bit-exactly.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.checkpoint import ckpt
from repro_torch.tree import tree_map


def to_tensor(a, device="cpu", dtype=None) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16" or arr.dtype == np.dtype("V2"):
        t = torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(arr).copy())
    return t.to(device=device, dtype=dtype or t.dtype)


def from_tree(tree, device="cpu", dtype=None) -> Dict[str, Any]:
    """Nested dict of arrays → nested dict of tensors on ``device``
    (optionally cast to ``dtype``)."""
    return tree_map(lambda a: to_tensor(a, device, dtype), tree)


def from_npz(path: str, device="cpu", dtype=None, key: str = "params"):
    """Parameters stored under ``key`` in a ``ckpt.save`` npz (the whole
    tree when ``key`` is empty)."""
    tree = ckpt.load(path)
    return from_tree(tree[key] if key else tree, device, dtype)
