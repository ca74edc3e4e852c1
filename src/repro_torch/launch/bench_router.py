"""Device time of the router kernel (``kernels/router_scores.py``) by batch.

    python3 src/repro_torch/launch/bench_router.py [--src DIR] [--label L]

Times the ``router_scores`` kernel of the checkout whose ``src`` directory
is ``--src`` (default: this one) on the card, at the serving path's D = 32,
K = 2 in float32 for B = 1, 16 and 65536: each call held against the
plain version, then ``--iters`` calls captured in one CUDA graph and
replayed three times between CUDA events (as ``chip_smoke.device_ms``).
Also times the card's floor for one launch in a graph (an in-place add on
one element). Two checkouts are compared by running this once on each in
one machine, alternating (parent, change, change, parent). Prints one JSON
line: the label, the card, each batch's device ms and byte bound, and the
floor.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

HBM_BPS = 3.35e12       # H100 SXM HBM3, bytes per second


def device_ms(torch, fn, iters):
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (3 * iters)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve()
                                         .parents[2]))
    ap.add_argument("--label", default="")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch
    from repro_torch.kernels import router_scores as rk

    if not torch.cuda.is_available():
        raise SystemExit("bench_router: needs a CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(0)
    D, K = 32, 2
    cent = torch.randn((K, D), generator=gen, device="cuda")
    by_b = {}
    for B in (1, 16, 65536):
        x = torch.randn((B, D), generator=gen, device="cuda")
        err = (rk.router_scores(x, cent, 10.0)
               - rk.router_scores_ref(x, cent, 10.0)).abs().max().item()
        if not err <= 5e-5:
            raise AssertionError(f"router_scores at B={B}: max abs err {err}")
        by_b[B] = {"device_ms": device_ms(
            torch, lambda: rk.router_scores(x, cent, 10.0), args.iters),
            "bound_ms": (B * D + K * D + B * K) * 4 / HBM_BPS * 1e3,
            "max_abs_err": err}
    one = torch.zeros(1, device="cuda")
    floor = device_ms(torch, lambda: one.add_(1.0), args.iters)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    rep = {"label": args.label, "src": args.src, "card": smi,
           "shape": f"D={D} K={K} float32", "by_batch": by_b,
           "launch_floor_device_ms": floor}
    print(json.dumps(rep), flush=True)
    return rep


if __name__ == "__main__":
    main()
