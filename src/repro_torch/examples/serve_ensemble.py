"""Serve a trained decentralized ensemble with batched requests, on the
port (twin of ``examples/serve_ensemble.py``).

Needs a run directory from ``repro_torch.examples.train_decentralized``
(or ``repro_torch.launch.train``). Routes each request on its
frozen-encoder features, decodes with the top-1 expert (compute-matched,
paper §5.2) and reports throughput and routing; ``--strategy mixture``
decodes with the exact Eq. 27 top-k probability mixture. ``--stream``
prints every request's token deltas as they decode, ``--stop-token ID``
(repeatable) retires requests early with ``finish_reason="stop"``.

    PYTHONPATH=src python -m repro_torch.examples.train_decentralized \
        --steps 100
    PYTHONPATH=src python -m repro_torch.examples.serve_ensemble [--device cpu]

Takes the reference script's flags plus ``--device`` (the card unless
``--device cpu``) and runs ``repro_torch.launch.serve`` in a subprocess,
as the reference runs ``repro.launch.serve``; exits with its code.
"""
from __future__ import annotations

import argparse
import subprocess
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--run", default="/tmp/repro_decentralized")
    ap.add_argument("--arch", default="xlstm_125m")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--strategy", choices=["top1", "mixture"],
                    default="top1")
    ap.add_argument("--stream", action="store_true",
                    help="print per-token deltas from the streaming API")
    ap.add_argument("--stop-token", type=int, action="append", default=None,
                    help="stop/eos token id (repeatable)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args(argv)

    cmd = [sys.executable, "-m", "repro_torch.launch.serve",
           "--run", args.run, "--arch", args.arch,
           "--requests", str(args.requests), "--strategy", args.strategy,
           "--new-tokens", "24", "--device", args.device]
    if args.stream:
        cmd.append("--stream")
    for t in args.stop_token or ():
        cmd += ["--stop-token", str(t)]
    print("running:", " ".join(cmd), flush=True)
    return subprocess.call(cmd)


if __name__ == "__main__":
    raise SystemExit(main())
