"""Device time of the chunk-scan kernel (``kernels/chunk_scan.py``) at the
serving paths' shapes, and a bit-for-bit A/B of two checkouts.

    python3 src/repro_torch/launch/bench_chunk_scan.py [--src DIR]
        [--label L] [--save FILE | --against FILE]

Runs the ``chunk_scan`` kernel of the checkout whose ``src`` directory is
``--src`` (default: this one) on the card:

* the TMA route's shapes (Zamba2's chunked-prefill chunk, L 256, H 32,
  dk 64, dv 160, and the edge shapes ``chip_smoke.py`` holds that route
  at), bf16, inputs from one seeded CUDA generator. ``--save`` writes the
  outputs to FILE; ``--against`` compares them with FILE's bit for bit and
  fails on any difference;
* device ms (``--iters`` calls captured in one CUDA graph, replayed three
  times between CUDA events, as ``chip_smoke.device_ms``) at Zamba2's
  shape in bf16 and at mLSTM's (xLSTM-125M: L 256, H 4, dk 384, dv 385) in
  bf16 and float32, each beside the plain version's ms (CUDA events) and
  its bound (bytes moved once over 3.35 TB/s, or the products over the
  peak rate of the inputs' type, whichever is larger), each call held at
  5e-5 against the plain version.

Two checkouts are compared by running this on each in one machine,
alternating (parent, change, change, parent). Prints one JSON line: the
label, the card, and the figures by shape.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

HBM_BPS = 3.35e12                       # H100 SXM HBM3, bytes per second
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # dense, data sheet
TOL = 5e-5
ZAMBA2 = (1, 1, 256, 32, 64, 160)       # B, NC, L, H, dk, dv
MLSTM = (1, 1, 256, 4, 384, 385)
# the TMA route's shapes in chip_smoke.py: (B, NC, L, H, dk, dv, decay)
TMA_SHAPES = [
    (1, 1, 256, 32, 64, 160, 0.1),
    (1, 4, 256, 32, 64, 160, 0.1),
    (1, 2, 16, 4, 16, 16, 0.1),
    (2, 3, 32, 4, 16, 48, 0.1),
    (1, 2, 100, 2, 16, 24, 0.1),
    (2, 3, 64, 4, 32, 32, 0.1),
    (1, 1, 192, 2, 128, 200, 0.1),
    (1, 1, 64, 2, 24, 72, 0.1),
    (1, 1, 256, 32, 64, 160, 5.0),
    (1, 4, 256, 32, 64, 160, 0.001),
]


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


def event_ms(torch, fn, iters):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def inputs(torch, gen, shape, dtype, decay=0.1):
    """qc, kc, vc in ``dtype`` and cum float32, as chip_smoke._scan_case."""
    B, NC, L, H, dk, dv = shape
    s = dk ** -0.25
    qc = torch.randn((B, NC, L, H, dk), generator=gen, device="cuda") * s
    kc = torch.randn((B, NC, L, H, dk), generator=gen, device="cuda") * s
    vc = torch.randn((B, NC, L, H, dv), generator=gen, device="cuda")
    logg = -torch.randn((B, NC, L, H), generator=gen,
                        device="cuda").abs() * decay
    return (qc.to(dtype), kc.to(dtype), vc.to(dtype),
            torch.cumsum(logg, dim=2).contiguous())


def bound_ms(shape, dtype_name, element_size):
    """The least time for one call: inputs read and outputs written once,
    or the causal q·k and P·v products and the dk × dv summary at the peak
    rate of the inputs' type."""
    B, NC, L, H, dk, dv = shape
    n = B * NC * H
    nbytes = B * NC * L * H * (2 * dk * element_size + dv * element_size
                               + 4 + dv * 4) + n * dk * dv * 4
    flops = n * (L * (L + 1) // 2 * 2 * (dk + dv) + 2 * L * dk * dv)
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve()
                                         .parents[2]))
    ap.add_argument("--label", default="")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--save", help="write the TMA route's outputs here")
    ap.add_argument("--against", help="compare them with this file's")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch
    from repro_torch.kernels import chunk_scan as cs

    if not torch.cuda.is_available():
        raise SystemExit("bench_chunk_scan: needs a CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(0)
    outs = []
    for B, NC, L, H, dk, dv, decay in TMA_SHAPES:
        args_ = inputs(torch, gen, (B, NC, L, H, dk, dv), torch.bfloat16,
                       decay)
        outs.append([t.cpu() for t in cs.chunk_scan(*args_)])
    rep = {"label": args.label, "src": args.src}
    if args.save:
        torch.save(outs, args.save)
    if args.against:
        theirs = torch.load(args.against)
        diff = [i for i, (a, b) in enumerate(zip(outs, theirs))
                if not all(torch.equal(x, y) for x, y in zip(a, b))]
        rep["bit_for_bit"] = {"against": args.against,
                              "shapes": len(outs), "differ": diff}
        if diff:
            print(json.dumps(rep), flush=True)
            raise SystemExit(f"bench_chunk_scan: shapes {diff} of "
                             f"{TMA_SHAPES} differ from {args.against}")
    by_shape = {}
    for name, shape, dtype in (("zamba2", ZAMBA2, torch.bfloat16),
                               ("mlstm", MLSTM, torch.bfloat16),
                               ("mlstm", MLSTM, torch.float32)):
        a = inputs(torch, gen, shape, dtype)
        got, want = cs.chunk_scan(*a), cs.chunk_scan_ref(*a)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=TOL, atol=TOL)
        err = max((g - w).abs().max().item() for g, w in zip(got, want))
        dname = str(dtype).split(".")[-1]
        b_ms, b_by = bound_ms(shape, dname, a[0].element_size())
        by_shape[f"{name} {dname}"] = {
            "shape": "B={} NC={} L={} H={} dk={} dv={}".format(*shape),
            "route": "tensor cores" if cs.tensor_core_route(
                dtype, shape[4], shape[5]) else "scalar",
            "device_ms": device_ms(torch, lambda: cs.chunk_scan(*a),
                                   args.iters),
            "plain_ms": event_ms(torch, lambda: cs.chunk_scan_ref(*a),
                                 args.iters),
            "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    rep.update({"card": smi, "by_shape": by_shape})
    print(json.dumps(rep), flush=True)
    return rep


if __name__ == "__main__":
    main()
