"""What a traced window's ``torch.profiler`` trace says: device busy
time, device time by kernel group and under each ``bench.op.<name>``
range, the device operations that took most time, and the longest idle
gaps by what the host was doing then.

``KERNEL_GROUPS`` is a frozen copy of the program's grouping of kernel
names (``launch/profile_serve.py``), so a later change to the program
cannot move the yardstick."""
from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Tuple

import torch

KERNEL_GROUPS = {
    "paged_decode_attention": ("pagedrows", "paged_decode_sm90",
                               "paged_decode_merge"),
    "decode_attention": ("contiguousrows", "contiguous_decode_sm90",
                         "contiguous_decode_merge"),
    "chunk_prefill_attention": ("chunk_prefill_kernel",
                                "chunk_prefill_sm90"),
    "paged_verify_attention": ("paged_verify_kernel", "paged_verify_sm90",
                               "verify_merge"),
    "chunk_scan": ("chunk_scan",),
    "flash_attention": ("flash_kernel", "flash_fwd_sm90"),
    "flash_attention_bwd": ("dq_kernel", "dkv_kernel", "dq_sm90",
                            "dkv_sm90"),
    "router_scores": ("router_kernel",),
    "matmul": ("gemm", "xmma", "cutlass", "cublas", "nvjet"),
}
PORT_KERNELS = tuple(g for g in KERNEL_GROUPS if g != "matmul")


def group(name: str) -> str:
    low = name.lower()
    for g, keys in KERNEL_GROUPS.items():
        if any(k in low for k in keys):
            return g
    return "other"


def _device(e) -> bool:
    return e.device_type == torch.autograd.DeviceType.CUDA


def _union(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _range_time(events, kernels, prefix: str) -> Dict[str, float]:
    """Device µs under each ``prefix<name>`` range: the kernels whose
    device interval lies inside one of the range's device-side intervals
    (the profiler's ``gpu_user_annotation`` of the range)."""
    spans: Dict[str, List[Tuple[float, float]]] = defaultdict(list)
    for e in events:
        if e.name.startswith(prefix) and _device(e):
            spans[e.name[len(prefix):]].append((e.time_range.start,
                                                e.time_range.end))
    starts = [k[0] for k in kernels]
    out = {}
    for name, sp in spans.items():
        t = 0.0
        for a, b in _union(sp):
            i = bisect.bisect_left(starts, a)
            while i < len(kernels) and kernels[i][0] < b:
                if kernels[i][1] <= b + 0.5:
                    t += kernels[i][1] - kernels[i][0]
                i += 1
        out[name] = t
    return out


def summarize(prof, window_s: float) -> dict:
    """The trace's numbers (device times in seconds). The host's ranges
    are read on the thread that ran the benchmark's own ``bench.host.``
    ranges."""
    events = prof.events()
    main_thread = next((e.thread for e in events
                        if e.name.startswith("bench.host.")), None)
    kernels = sorted((e.time_range.start, e.time_range.end, e.name)
                     for e in events if _device(e)
                     and not e.name.startswith("bench.")
                     and e.time_range.end > e.time_range.start
                     and not getattr(e, "is_user_annotation", False))
    busy = _union([(a, b) for a, b, _ in kernels])
    by_group: Dict[str, float] = defaultdict(float)
    by_name: Dict[str, float] = defaultdict(float)
    for a, b, n in kernels:
        by_group[group(n)] += (b - a) / 1e6
        by_name[n] += (b - a) / 1e6
    gaps = sorted(((b0, a1) for (_, b0), (a1, _) in zip(busy, busy[1:])),
                  key=lambda g: g[0] - g[1])[:10]
    host = sorted((e.time_range.start, e.time_range.end, e.name)
                  for e in events if not _device(e)
                  and e.thread == main_thread)
    idle = []
    for a, b in gaps:
        mid = (a + b) / 2
        inner = [h for h in host if h[0] <= mid <= h[1]]
        label = min(inner, key=lambda h: h[1] - h[0])[2] if inner \
            else "no host range"
        idle.append([f"idle during {label}", (b - a) / 1e6])
    return {
        "busy_s": sum(b - a for a, b in busy) / 1e6,
        "window_s": window_s,
        "group_s": dict(by_group),
        "range_s": {n: t / 1e6 for n, t in _range_time(
            events, [(a, b) for a, b, _ in kernels], "bench.op.").items()},
        "device_ops": sorted(([n[:120], s] for n, s in by_name.items()),
                             key=lambda x: -x[1])[:10],
        "idle_gaps": idle,
        "n_kernels": len(kernels),
    }
