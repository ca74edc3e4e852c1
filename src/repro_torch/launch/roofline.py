"""Roofline terms of a placed step, and the collectives it issues (port of
``repro.launch.roofline``).

Three terms per (arch × shape × mesh), in seconds:

    compute    = FLOPs_per_device / peak_FLOP/s
    memory     = bytes_per_device / HBM_bw
    collective = collective_bytes_per_device / link_bw

The reference reads FLOPs and bytes from XLA's cost analysis and the
collectives from the compiled HLO. The port has no compiled module: the
dry run (``launch/dryrun.py``) runs the step on fake tensors and counts
what each device's shards go through. ``CollectiveRecorder`` is the HLO
parser's counterpart: a ``TorchDispatchMode`` that sees the
``_c10d_functional`` collectives DTensor issues, with one entry per op —
the op, its result's bytes, the ranks of its group, and whether that group
holds ranks of more than one pod — so the paper's zero-cross-pod property
of decentralized training is checked from the collectives themselves.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# NVIDIA H100 SXM5 80GB, dense figures from its data sheet ("NVIDIA H100
# Tensor Core GPU" datasheet, SXM5 column; the sparse figures are twice
# these). The port's roofline takes no other device's figures.
PEAK_FLOPS = 989e12          # bf16 Tensor Core FLOP/s per card (dense)
HBM_BW = 3.35e12             # HBM3 bytes/s per card
NVLINK_BW = 450e9            # NVLink 4: 900 GB/s per card, 450 GB/s each way
# A pod of 256 cards spans 32 hosts of 8, so its groups cross hosts: the
# link for such a group is one ConnectX-7 InfiniBand NDR port per card
# (400 Gb/s = 50 GB/s each way, the DGX H100 system's data sheet: 8 ports
# of 400 Gb/s for its 8 cards).
IB_BW = 50e9
HOST_SIZE = 8                # cards a host, joined all to all by NVLink

_COLLECTIVES = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all", "broadcast": "broadcast",
    "broadcast_": "broadcast", "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
}


@dataclass
class CollectiveOp:
    op: str
    bytes: int
    ranks: Optional[List[int]]
    crosses_pod: Optional[bool]


def _bytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_bytes(t) for t in x)
    return 0


def group_ranks(group_name: str) -> List[int]:
    """The global ranks of a functional collective's group."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group
    return dist.get_process_group_ranks(_resolve_process_group(group_name))


class CollectiveRecorder(TorchDispatchMode):
    """Records every ``_c10d_functional`` collective issued while it is
    active (``ops``). With ``count_costs`` it also counts, over every other
    aten op on plain (local) tensors, the FLOPs by
    ``torch.utils.flop_counter``'s per-op formulas (``flops``: those of
    ``FlopCounterMode``, which itself would count a DTensor op at its
    global shape) and the operand and result bytes (``bytes_accessed``: an
    unfused count — every op reads its inputs from and writes its output
    to memory, so it overstates what fused kernels move). DTensor ops are
    passed on to DTensor, so the recorder sees each device's local ops and
    the collectives they lower to. DTensor infers an op's output shape by
    running it on fake tensors of the global shape (cached, so only at
    times): the recorder counts nothing while that inference runs."""

    def __init__(self, *, pod_size: int = 256, count_costs: bool = False):
        super().__init__()
        self.pod_size, self.count_costs = pod_size, count_costs
        self.ops: List[CollectiveOp] = []
        self.flops = 0
        self.bytes_accessed = 0
        self._inferring = 0

    def __enter__(self):
        from torch.distributed.tensor._sharding_prop import ShardingPropagator
        name = "_propagate_tensor_meta_non_cached"
        infer = getattr(ShardingPropagator, name)
        recorder = self

        def quiet(prop, *args, **kwargs):
            recorder._inferring += 1
            try:
                return infer(prop, *args, **kwargs)
            finally:
                recorder._inferring -= 1

        self._restore = (ShardingPropagator, name, infer)
        setattr(ShardingPropagator, name, quiet)
        return super().__enter__()

    def __exit__(self, *exc):
        cls, name, infer = self._restore
        setattr(cls, name, infer)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._inferring:
            return out
        name = func._overloadpacket.__name__
        if func.namespace == "_c10d_functional" and name in _COLLECTIVES:
            group = [a for a in (*args, *kwargs.values())
                     if isinstance(a, str)][-1]
            ranks = group_ranks(group)
            pods = {r // self.pod_size for r in ranks}
            self.ops.append(CollectiveOp(_COLLECTIVES[name], _bytes(out),
                                         ranks, len(pods) > 1))
        elif self.count_costs and func.namespace == "aten":
            from torch.utils.flop_counter import flop_registry
            count = flop_registry.get(func._overloadpacket)
            if count is not None:
                self.flops += count(*args, **kwargs, out_val=out)
            self.bytes_accessed += _bytes(out) + sum(
                _bytes(a) for a in (*args, *kwargs.values()))
        return out


def collective_summary(ops: List[CollectiveOp]) -> Dict:
    """The reference's summary keys over recorded collectives."""
    per_op: Dict[str, int] = {}
    cross_bytes = 0
    for c in ops:
        per_op[c.op] = per_op.get(c.op, 0) + c.bytes
        if c.crosses_pod:
            cross_bytes += c.bytes
    return {
        "n_collectives": len(ops),
        "bytes_per_op": per_op,
        "total_bytes": sum(per_op.values()),
        "cross_pod_bytes": cross_bytes,
        "cross_pod_ops": sum(1 for c in ops if c.crosses_pod),
    }


def link_bw(ops: List[CollectiveOp]) -> float:
    """The link rate the collective term is taken at: NVLink when every
    group fits one host's 8 cards, the InfiniBand port otherwise."""
    inside = all(c.ranks is not None and
                 len({r // HOST_SIZE for r in c.ranks}) == 1 for c in ops)
    return NVLINK_BW if inside else IB_BW


@dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    mode: str
    flops_per_device: float
    bytes_per_device: float
    collective_bytes: float
    model_flops_per_device: float
    link_bw: float = IB_BW
    compute_s: float = 0.0
    memory_s: float = 0.0
    collective_s: float = 0.0
    bottleneck: str = ""
    useful_flops_ratio: float = 0.0

    def finalize(self) -> "RooflineReport":
        self.compute_s = self.flops_per_device / PEAK_FLOPS
        self.memory_s = self.bytes_per_device / HBM_BW
        self.collective_s = self.collective_bytes / self.link_bw
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        self.bottleneck = max(terms, key=terms.get)
        self.useful_flops_ratio = (
            self.model_flops_per_device / self.flops_per_device
            if self.flops_per_device else 0.0)
        return self


def model_flops(cfg, n_params_active: int, tokens: int, kind: str) -> float:
    """MODEL_FLOPS = 6·N·D (train) or 2·N·D (forward-only), N = active
    params (MoE: routed fraction + shared), D = tokens processed."""
    mult = 6.0 if kind == "train" else 2.0
    return mult * n_params_active * tokens


def active_params(cfg, total_params: int, model) -> int:
    """MoE: count routed experts at top_k/n_experts utilization."""
    if cfg.moe.n_experts == 0:
        return total_params
    specs = model.param_specs()
    expert_leaves = 0
    for path, leaf in _iter_specs(specs["blocks"]):
        if "moe" in path and path.split("/")[-1] in ("w_gate", "w_up",
                                                     "w_down"):
            expert_leaves += int(torch.Size(leaf.shape).numel())
    dense_part = total_params - expert_leaves
    return int(dense_part +
               expert_leaves * cfg.moe.top_k / cfg.moe.n_experts)


def _iter_specs(tree, prefix=""):
    from repro_torch.models.params import is_spec
    if is_spec(tree):
        yield prefix, tree
        return
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _iter_specs(v, f"{prefix}/{k}")
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _iter_specs(v, f"{prefix}/{i}")
