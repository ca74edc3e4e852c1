"""Logical-axis sharding rules (port of ``repro.sharding.rules``).

Meshes (``launch/mesh.py``):
    single-pod : (16, 16)      axes ("data", "model")
    multi-pod  : (2, 16, 16)   axes ("pod", "data", "model")

Two training modes:

* ``dense`` (the paper's centralized baseline): one model; batch and FSDP
  shard over (pod, data) — gradient reductions and FSDP all-gathers cross
  the pod boundary. This is the cost the paper's scheme removes.
* ``decentralized`` (the paper's scheme): K experts stacked on a leading
  ``dexpert`` dim sharded over ``pod``. Each expert runs on its pod's
  ("data", "model") sub-mesh, so every collective's group stays inside one
  pod (``launch/roofline.py`` records the groups to check it).

Tensor parallelism (``model`` axis) rules are shared: vocab/heads/ffn/expert
dims shard over ``model``; kv_heads fall back to whole when the head count
does not divide the axis (e.g. llama3 kv=8 on model=16).

Every placement function returns a tree of specs (``models.params``: a
tuple per tensor, one entry per dim — None, a mesh-axis name or a tuple of
names); ``placements`` turns one into DTensor placements. The mesh is
``{axis name: size}`` or a ``DeviceMesh``.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from repro_torch.models.params import (axes_extent, axes_tuple, mesh_sizes,
                                       norm_axes)
from repro_torch.tree import tree_map


def logical_rules(*, multi_pod: bool, decentralized: bool,
                  fsdp: bool = True) -> Dict[str, object]:
    """Logical axis name → mesh axis (or tuple) mapping."""
    if decentralized:
        fsdp_axes = ("data",)          # pod is the expert axis
    else:
        fsdp_axes = ("pod", "data") if multi_pod else ("data",)
    rules: Dict[str, object] = {
        # ---- parameter axes
        "vocab": "model",
        "embed": fsdp_axes if fsdp else None,    # ZeRO-3-style weight shard
        "mlp": "model",
        "expert_mlp": None,
        "heads": "model",
        "kv_heads": "model",
        "head_dim": None,
        "expert": "model",                        # MoE expert parallelism
        "inner": "model",
        "inner_qkv": "model",
        "vision": None,
        "audio": None,
        "layer": None,                            # scanned dim, never sharded
        # ---- decentralized expert stacking dim
        "dexpert": "pod" if (multi_pod and decentralized) else None,
        # ---- activation/batch axes
        "act_batch": (("pod", "data") if (multi_pod and not decentralized)
                      else ("data",)),
        "act_seq": None,
        "act_embed": None,
        "act_heads": "model",
        "act_vocab": "model",
        "kv_cache_batch": (("pod", "data") if (multi_pod and not decentralized)
                           else ("data",)),
        "kv_cache_heads": "model",
    }
    return rules


def batch_pspec(rules) -> tuple:
    return (norm_axes(rules["act_batch"]),)


def data_shardings(rules, mesh, cfg, kind: str,
                   decentralized_k: int = 0) -> Dict[str, tuple]:
    """Specs of the input batch (tokens/labels/patches/frames).
    ``decentralized_k`` > 0 prepends the expert dim (over pod)."""
    lead = (norm_axes(rules["dexpert"]),) if decentralized_k else ()
    b = norm_axes(rules["act_batch"])
    out = {"tokens": (*lead, b, None), "labels": (*lead, b, None)}
    if cfg.family == "vlm":
        out["patches"] = (*lead, b, None, None)
    if cfg.family == "audio":
        out["frames"] = (*lead, b, None, None)
    return out


def _strip_expert(t):
    """A stacked leaf's shape without its axis-1 expert dim."""
    return tuple(t.shape[:1]) + tuple(t.shape[2:])


def stacked_cache_pspec_tree(stacked_cache_shapes, rules, mesh,
                             seq_axes=None):
    """Specs of the stacked-expert decode cache: every leaf carries the K
    (``dexpert``) dim at axis 1, after its scan dim, over ``pod`` under the
    decentralized rules; the rest is placed as ``cache_pspec_tree`` places
    the unstacked cache (``paged_pool_pspec_tree`` when ``seq_axes``, the
    UNSTACKED ``CacheSpec.paged.seq_axes``, is given)."""
    dexp = norm_axes(rules["dexpert"])

    def one(t, s_ax=-1):
        inner = (_pool_leaf_spec(_strip_expert(t), s_ax, rules, mesh)
                 if s_ax >= 0 else
                 _cache_leaf_spec(_strip_expert(t), rules, mesh))
        return (inner[0] if inner else None, dexp, *inner[1:])

    if seq_axes is None:
        return tree_map(one, stacked_cache_shapes)
    return tree_map(one, stacked_cache_shapes, seq_axes)


def _shape(t) -> Tuple[int, ...]:
    return tuple(t) if isinstance(t, tuple) else tuple(t.shape)


def _cache_leaf_spec(shape_like, rules, mesh) -> tuple:
    """Contiguous cache-leaf placement: batch over data, heads over model
    when divisible. Cache layouts carry the layer/group dim first and batch
    second (attention) or inside (states); exotic dims stay whole when
    indivisible."""
    shape = _shape(shape_like)
    ndim = len(shape)
    b_axes = norm_axes(rules["kv_cache_batch"])
    extent = axes_extent(mesh, b_axes)
    model = mesh_sizes(mesh)["model"]
    spec: List[object] = [None] * ndim
    # the batch dim: layouts here are (L, B, ...) or (G, gm, B, ...)
    for cand in (1, 2):
        if ndim > cand and shape[cand] % extent == 0 and shape[cand] > 1:
            spec[cand] = b_axes
            break
    # (L,B,S,KV,dh) attention caches: kv-heads over model when divisible,
    # else the sequence dim (the distributed-decode partial-softmax layout)
    if ndim == 5 and spec[1] == b_axes:
        kv, seq = shape[-2], shape[2]
        if kv % model == 0 and kv > 1:
            spec[-2] = "model"
        elif seq % model == 0 and seq > 1:
            spec[2] = "model"
    return tuple(spec)


def cache_pspec_tree(cache_shapes, rules, mesh):
    """KV-cache / recurrent-state specs for the contiguous layout."""
    return tree_map(lambda t: _cache_leaf_spec(t, rules, mesh), cache_shapes)


def chunk_carry_pspec_tree(carry_shapes, rules, mesh):
    """Specs of a chunked-prefill carry (one request's direct-leaf decode
    states plus (1,)-shaped pool placeholders): its batch extent is 1, so
    nothing shards over the kv-cache batch axes; kv-heads of 5-D
    cross-attention leaves follow ``model`` when divisible, everything else
    is whole."""
    heads_ax = rules["kv_cache_heads"]
    size = mesh_sizes(mesh)[heads_ax]

    def one(t):
        shape = _shape(t)
        spec: List[object] = [None] * len(shape)
        if len(shape) == 5:                    # (L, 1, F, KV, dh) cross KV
            kv = shape[-2]
            if kv % size == 0 and kv > 1:
                spec[-2] = heads_ax
        return tuple(spec)

    return tree_map(one, carry_shapes)


def block_table_pspec(rules, mesh) -> tuple:
    """The paged cache's block tables (decode (n_slots, NB), chunk (NB,))
    are whole on every device: with the pool's physical-block axis sharded
    over the kv-cache batch axes, each shard resolves its own
    ``pool[table]`` gather locally."""
    return ()


def slot_state_pspec_tree(state_like, rules, mesh):
    """The fused decode step's per-slot device state is whole on every
    device, like the block tables it carries: each leaf is a small row, so
    the epilogue's sampling and stop checks run locally, with no
    collective."""
    return tree_map(lambda _: (), state_like)


def _pool_leaf_spec(shape_like, s_ax: int, rules, mesh) -> tuple:
    """A pool leaf (scan, P, block, KV, dh): the physical-block axis over
    the kv-cache batch axes, kv-heads over ``model`` when divisible; block
    positions are never cut (a block is the copy granule)."""
    shape = _shape(shape_like)
    ndim = len(shape)
    b_axes = norm_axes(rules["kv_cache_batch"])
    extent = axes_extent(mesh, b_axes)
    spec: List[object] = [None] * ndim
    pool_ax = s_ax - 1          # the axis the slot (batch) axis held
    if shape[pool_ax] % extent == 0 and shape[pool_ax] > 1:
        spec[pool_ax] = b_axes
    if ndim == 5:
        kv = shape[-2]
        if kv % mesh_sizes(mesh)["model"] == 0 and kv > 1:
            spec[-2] = "model"
    return tuple(spec)


def paged_pool_pspec_tree(paged_cache_shapes, rules, mesh, seq_axes):
    """Specs of the PAGED decode cache. ``seq_axes`` is the
    ``CacheSpec.paged.seq_axes`` tree: leaves marked −1 are direct per-slot
    rows and keep their contiguous placement; pool leaves shard their
    physical-block axis (``_pool_leaf_spec``)."""
    def one(t, s_ax):
        if s_ax < 0:
            return _cache_leaf_spec(t, rules, mesh)
        return _pool_leaf_spec(t, s_ax, rules, mesh)

    return tree_map(one, paged_cache_shapes, seq_axes)


# ---------------------------------------------------------------------------
# Specs → DTensor placements
# ---------------------------------------------------------------------------

def placements(spec: tuple, mesh) -> list:
    """DTensor placements of ``spec`` on ``mesh`` (a ``DeviceMesh``, or a
    sequence of its axis names): one entry per mesh dim, ``Shard(d)`` where
    tensor dim d names that mesh axis, ``Replicate()`` elsewhere. A dim
    named by several axes is split over them in mesh order, the first
    outermost — the reference's flattened order — so its axes must come in
    mesh order. On a ``DeviceMesh`` an axis of size 1 places every dim
    whole (the same layout; DTensor cannot reshape a dim of size 1 that it
    holds as split)."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh if isinstance(mesh, (tuple, list))
                 else mesh.mesh_dim_names)
    single = [False] * len(names) if isinstance(mesh, (tuple, list)) \
        else [mesh.size(i) == 1 for i in range(len(names))]
    out: list = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        axes = axes_tuple(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} is not in the mesh's "
                             f"axis order {tuple(names)}")
        for i in idx:
            if out[i] != Replicate():
                raise ValueError(f"mesh axis {names[i]!r} shards two dims "
                                 f"in {spec!r}")
            out[i] = Shard(d)
    return [Replicate() if one else p for one, p in zip(single, out)]


def local_shape(shape, spec: tuple, mesh) -> Tuple[int, ...]:
    """The shape of one device's shard of a ``shape`` tensor placed by
    ``spec`` (the dims evenly divided, as every rule here ensures)."""
    sizes = mesh_sizes(mesh)
    out = list(shape)
    for d, entry in enumerate(spec):
        n = axes_extent(sizes, entry)
        if out[d] % n:
            raise ValueError(f"dim {d} of {tuple(shape)} does not divide "
                             f"over {entry!r} ({n})")
        out[d] //= n
    return tuple(out)
