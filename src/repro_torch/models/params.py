"""Parameter descriptors (port of ``repro.models.params``): shapes, logical
axis names and init rules. Initialization draws from an explicit
``torch.Generator`` on the target device; it matches the reference in shape
and scale only — bit parity with ``jax.random`` is impossible, so parity
tests carry the reference's weights across with ``repro_torch.weights``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch


@dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    logical: Tuple[Optional[str], ...]        # logical axis name per dim
    init: str = "normal"                      # normal | zeros | ones | scaled
    scale: float = 0.02

    def __post_init__(self):
        if len(self.shape) != len(self.logical):
            raise ValueError(f"shape {self.shape} vs axes {self.logical}")


def is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def _init_leaf(gen: torch.Generator, spec: ParamSpec,
               dtype: torch.dtype) -> torch.Tensor:
    dev = gen.device
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=dev)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=dev)
    scale = spec.scale
    if spec.init == "scaled":                 # fan-in scaled
        fan_in = spec.shape[0] if len(spec.shape) else 1
        scale = 1.0 / math.sqrt(max(fan_in, 1))
    # drawn in the target dtype, as the reference does: a float32 draw of
    # the 8B leaves would double their peak memory
    out = torch.randn(spec.shape, generator=gen, dtype=dtype, device=dev)
    return out.mul_(scale)


def init_params(gen: torch.Generator, tree, dtype=torch.float32):
    """Materialize a ParamSpec tree (nested dicts) into tensors on
    ``gen.device``, drawing the leaves in sorted-key order."""
    if is_spec(tree):
        return _init_leaf(gen, tree, dtype)
    return {k: init_params(gen, tree[k], dtype) for k in sorted(tree)}

