"""Weights made from the seed, on the device, in the type they are served
in: one normal draw of a whole group's elements from one generator (the
embedding, head and final norm are group 0, layer i is group i + 1), then
each leaf scaled in place. The program and the reference are handed the
same tensors, and the reference can draw any one group again by itself
(``draw_group``), so it never needs a copy of the program's."""
from __future__ import annotations

import math
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

Layout = Dict[str, Tuple[tuple, bool, object]]


def group_seed(seed: int, expert: int, group: int) -> int:
    state = np.random.SeedSequence([seed, expert, group]).generate_state(
        2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def _members(layout: Layout, group: int) -> Iterator[Tuple[str, tuple,
                                                           object]]:
    for path in sorted(layout):
        shape, per_layer, std = layout[path]
        if per_layer == (group > 0):
            yield path, shape, std


def draw_group(layout: Layout, seed: int, expert: int, group: int,
               device, dtype) -> Dict[str, torch.Tensor]:
    """Group ``group``'s leaves (a layer's: each leaf's slice for that
    layer) as {path: tensor}."""
    members = list(_members(layout, group))
    n = sum(math.prod(s) for _, s, std in members if std is not None)
    gen = torch.Generator(device=device).manual_seed(
        group_seed(seed, expert, group))
    buf = torch.randn(n, generator=gen, dtype=dtype, device=device)
    out, at = {}, 0
    for path, shape, std in members:
        if std is None:
            out[path] = torch.ones(shape, dtype=dtype, device=device)
            continue
        k = math.prod(shape)
        out[path] = buf[at:at + k].view(shape).mul_(std)
        at += k
    return out


def nest(flat: Dict[str, torch.Tensor]) -> Dict:
    tree: Dict = {}
    for path, t in flat.items():
        node = tree
        *head, last = path.split(".")
        for key in head:
            node = node.setdefault(key, {})
        node[last] = t
    return tree


def make_weights(layout: Layout, n_layers: int, seed: int, expert: int,
                 device, dtype) -> Dict:
    """Every leaf (layer leaves stacked on a leading dim) as a nested
    dict."""
    flat = dict(draw_group(layout, seed, expert, 0, device, dtype))
    for path, (shape, per_layer, _) in layout.items():
        if per_layer:
            flat[path] = torch.empty((n_layers, *shape), dtype=dtype,
                                     device=device)
    for i in range(n_layers):
        for path, t in draw_group(layout, seed, expert, i + 1, device,
                                  dtype).items():
            flat[path][i].copy_(t)
    return nest(flat)


def count(layout: Layout, n_layers: int, skip=()) -> int:
    """Parameters of the layout, leaves named in ``skip`` left out."""
    return sum(math.prod(s) * (n_layers if per else 1)
               for p, (s, per, _) in layout.items() if p not in skip)
