"""End-to-end run on the port (twin of ``examples/train_decentralized.py``):
decentralized training of the xLSTM-125M family at its smoke width for a
few hundred steps — feature extraction, the balanced k-means partition, K
independent expert runs (own data, optimizer and checkpoint, no
communication) and the router saved for serving
(``repro_torch.examples.serve_ensemble``).

    PYTHONPATH=src python -m repro_torch.examples.train_decentralized \\
        [--steps 300] [--device cpu]

Takes the reference script's flags plus ``--device`` (the card unless
``--device cpu``) and runs ``repro_torch.launch.train`` in a subprocess,
as the reference runs ``repro.launch.train``; exits with its code.
"""
from __future__ import annotations

import argparse
import subprocess
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--arch", default="xlstm_125m")
    ap.add_argument("--experts", type=int, default=2)
    ap.add_argument("--out", default="/tmp/repro_decentralized")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args(argv)

    cmd = [sys.executable, "-m", "repro_torch.launch.train",
           "--arch", args.arch, "--mode", "decentralized",
           "--experts", str(args.experts), "--steps", str(args.steps),
           "--batch", "16", "--samples", "2048", "--out", args.out,
           "--device", args.device]
    print("running:", " ".join(cmd), flush=True)
    return subprocess.call(cmd)


if __name__ == "__main__":
    raise SystemExit(main())
