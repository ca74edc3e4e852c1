"""Run one cell of the benchmark once, on the card of the machine it is
started on, and print its result as the last line of standard output:

    python3 bench/run.py --workload qwen3_8b.train_4k --seed 7 \
        --seconds 51 --trace 0

The cell (``BENCHMARK.json``'s ``workloads``) names a configuration and a
traffic mix; the mix's kind picks the runner. ``--trace 0`` measures the
cell's end-to-end metrics; ``--trace 1`` measures the same window, then
traces the mix's ``trace_seconds`` with ``torch.profiler``, and reports the
per-layer metrics. Every run checks what the timed path produced against
the plain reference (``correct``) and prints each compared number beside
its limit, as the last lines of standard error and under ``checks`` in the
result. Build and kernel caches
stay in ``build/`` inside the checkout. Exits non-zero, with no result,
where there is no card (or fewer than the cell asks for), and where JAX or
the JAX package is loaded once the window has closed.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = str(ROOT / "build" / sub)
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from bench.lib import cell as cell_lib
    from bench.lib.manifest import Manifest

    m = Manifest(ROOT)
    chips = m.workload(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"bench: {args.workload} needs {chips} CUDA card(s); "
              f"available: {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = cell_lib.execute(m, args.workload, args.seed, args.seconds,
                              bool(args.trace), torch.device("cuda", 0),
                              T_START)
    foreign = cell_lib.foreign_modules()
    if foreign:
        print(f"bench: loaded in the measuring process: {foreign}",
              file=sys.stderr)
        return 3
    readings = result.pop("_readings")
    print("readings " + json.dumps(readings), file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
