"""The readings each limit of ``bench/checks/<workload>.json`` is set
from, on the card, at the cell's own size: for each seed, the numbers the
sound program gives against the reference; with ``--control``, those of
the control (the reference computed with fp8 products, in the program's
place); with ``--fault NAME``, those of the program with a fault of
``bench/lib/faults.py`` planted (and, for training, ``half_batch_ref``:
the reference itself with half of each row left out of its loss). One JSON
line a seed; a benchmark run never runs any of this.

    python3 bench/calibrate.py --workload qwen3_8b.train_4k \
        --seconds 5 --seeds 11 12 13 [--control] [--fault half_batch]
"""
import argparse
import json
import math
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = str(ROOT / "build" / sub)
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", action="append", default=[])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from bench.lib import cell, checks, faults, serve_cell, train_cell
    from bench.lib.manifest import Manifest
    from bench.reference import decoder

    m = Manifest(ROOT)
    w = m.workload(args.workload)
    cfg, mix = m.config(w["config"]), m.traffic(w["traffic"])
    layout = decoder.model_module(cfg).layout(cfg)
    dev = torch.device(args.device, 0) if args.device == "cuda" \
        else torch.device("cpu")
    names = ["gap"] if mix["kind"] == "serve" else ["loss", "grad", "change"]
    loose = {n: math.inf for n in names}
    for seed in args.seeds:
        t = time.perf_counter()
        got = {}
        if args.control and mix["kind"] == "serve":
            serve_cell.served_gaps = _with_control(serve_cell.served_gaps,
                                                   got)
        try:
            r = cell.execute(m, args.workload, seed, args.seconds, False,
                             dev, t, limits=loose)
        finally:
            serve_cell.served_gaps = getattr(serve_cell.served_gaps,
                                             "inner",
                                             serve_cell.served_gaps)
        line = {"seed": seed, "program": {n: r["checks"][n]["value"]
                                          for n in names},
                "metrics": {k: v["value"] for k, v in r["metrics"].items()},
                "attempted": r["attempted"], "failed": r["failed"]}
        line["reference_s"] = r["_readings"]["reference_s"]
        if mix["kind"] == "serve":
            for k in ("checked_tokens", "engine_steps"):
                line[k] = r["_readings"][k]
        else:
            sound = r["_readings"]["reference"]
        if args.control and mix["kind"] == "train":
            ctl = train_cell.follow(cfg, mix, layout, seed, dev, "fp8")
            line["control"] = checks.train_numbers(ctl, sound)
        if args.control and mix["kind"] == "serve":
            line["control"] = {"gap": max(got["fp8"]),
                               "tokens": len(got["fp8"])}
        for f in args.fault:
            if f == "half_batch_ref":
                bad = train_cell.follow(cfg, mix, layout, seed, dev, "fp32",
                                        mask_half=True)
                line[f] = checks.train_numbers(bad, sound)
                continue
            with faults.FAULTS[f]():
                fr = cell.execute(m, args.workload, seed, args.seconds,
                                  False, dev, time.perf_counter(),
                                  limits=loose)
            line[f] = {n: fr["checks"][n]["value"] for n in names}
        line["seconds"] = time.perf_counter() - t
        print(json.dumps(line), flush=True)
    return 0


def _with_control(served_gaps, got):
    """``served_gaps`` reading, over the same sample of served requests,
    the gap of the token the fp8 reference puts first at each position
    too (into ``got``)."""
    def both(cfg, layout, seed, reqs, chosen, device, precisions):
        got.update(served_gaps(cfg, layout, seed, reqs, chosen, device,
                               ("served", "fp8")))
        return {"served": got["served"]}
    both.inner = served_gaps
    return both


if __name__ == "__main__":
    sys.exit(main())
