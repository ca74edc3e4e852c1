"""Parameter descriptors (port of ``repro.models.params``): shapes, logical
axis names and init rules. Initialization draws from an explicit
``torch.Generator`` on the target device; it matches the reference in shape
and scale only — bit parity with ``jax.random`` is impossible, so parity
tests carry the reference's weights across with ``repro_torch.weights``.

The sharding half maps logical axes to mesh axes. A *spec* is a plain tuple
with one entry per tensor dim: ``None`` (whole), one mesh-axis name, or a
tuple of names (the dim split over those mesh axes, the first outermost);
a 1-tuple is normalised to its name. The mesh is ``{axis name: size}`` or a
``DeviceMesh`` — the rules read only its axis sizes, so they need no
process group. ``repro_torch.sharding.rules.placements`` turns a spec into
DTensor placements.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from repro_torch.tree import flat_leaves, tree_map


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



# ---------------------------------------------------------------------------
# Sharding: logical axes → mesh axes
# ---------------------------------------------------------------------------

def mesh_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh``, of such a dict, or of a
    mesh object whose ``shape`` is such a dict."""
    if isinstance(mesh, dict):
        return mesh
    if isinstance(getattr(mesh, "shape", None), dict):
        return dict(mesh.shape)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def norm_axes(axes):
    """A rule's mesh axes in the port's spec form: a 1-tuple becomes its
    name, an empty tuple None."""
    if isinstance(axes, (tuple, list)):
        axes = tuple(axes)
        return None if not axes else axes[0] if len(axes) == 1 else axes
    return axes


def axes_tuple(entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry, as a tuple."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def axes_extent(mesh, entry) -> int:
    sizes = mesh_sizes(mesh)
    return math.prod(sizes[a] for a in axes_tuple(entry))


def resolve_axis(logical: Optional[str], dim: int, rules: Dict[str, object],
                 mesh=None):
    """Map a logical axis to mesh axes, dropping the rule (→ whole) when
    ``dim`` is not divisible by the mesh axes' extent."""
    if logical is None or logical not in rules:
        return None
    axes = norm_axes(rules[logical])
    if axes is None:
        return None
    if mesh is not None:
        extent = axes_extent(mesh, axes)
        if extent == 0 or dim % extent != 0:
            return None
    return axes


def _first_use(resolved, used: set) -> list:
    """A mesh axis may shard one tensor dim only: keep its first use."""
    out = []
    for r in resolved:
        axes = axes_tuple(r)
        if any(a in used for a in axes):
            out.append(None)
        else:
            used.update(axes)
            out.append(r)
    return out


def spec_pspec(spec: ParamSpec, rules: Dict[str, object],
               mesh=None) -> tuple:
    """One ParamSpec's spec under ``rules`` (divisibility-checked when a
    mesh is given)."""
    resolved = [resolve_axis(l, d, rules, mesh)
                for l, d in zip(spec.logical, spec.shape)]
    return tuple(_first_use(resolved, set()))


def tree_pspecs(tree, rules: Dict[str, object], mesh=None):
    """ParamSpec tree → spec tree under the given logical rules."""
    return tree_map(lambda s: spec_pspec(s, rules, mesh), tree)


def tree_shapes(tree, dtype=torch.float32,
                extra_leading: Tuple[int, ...] = ()):
    """ParamSpec tree → tree of ``meta`` tensors (no allocation): the
    reference's ``ShapeDtypeStruct`` tree."""
    return tree_map(lambda s: torch.empty(extra_leading + s.shape,
                                          dtype=dtype, device="meta"), tree)


def tree_shardings(tree, rules: Dict[str, object], mesh,
                   extra_leading_axes: Tuple[Optional[str], ...] = ()):
    """ParamSpec tree → spec tree with ``extra_leading_axes`` (logical
    names of prepended dims, e.g. the decentralized expert dim stacked over
    ``pod``) ahead of each leaf's own; a mesh axis the body already uses
    leaves its leading dim whole."""
    def one(s: ParamSpec):
        body = spec_pspec(s, rules, mesh)            # divisibility-checked
        used = {a for part in body for a in axes_tuple(part)}
        lead = _first_use([norm_axes(rules.get(l)) if l else None
                           for l in extra_leading_axes], used)
        return (*lead, *body)
    return tree_map(one, tree)


def count_params(tree) -> int:
    """Elements of a ParamSpec tree (or of a tensor tree)."""
    return int(sum(math.prod(l.shape) if is_spec(l) else l.numel()
                   for l in flat_leaves(tree)))
