"""Where the time goes in one step of the port's training path: a
``torch.profiler`` window over one step of the deployment of
``launch/train_path.py`` (the one ``chip_smoke.py`` trains: full-width
Qwen3-8B cut to 8 layers, bf16, remat "full", one 4096-token sequence a
step; ``--arch`` another config of ``train_path.DEPTH_CUTS`` at its
depth there, e.g. ``zamba2_2_7b`` or ``xlstm_125m`` whole).

    PYTHONPATH=src python -m repro_torch.launch.profile_train \
        [--arch zamba2_2_7b] [--steps 3]

Expert 0 trains ``--steps`` unprofiled steps (the first builds the kernels
and fills the allocator's pools), one step under the profiler, then
``--steps`` more unprofiled. Each step ends, as in ``train_host_loop``
with ``log_every=1``, in its metrics' readback. Prints one JSON report:
the profiled step's device time by kernel group (the flash forward and
backward kernels, matrix products, everything else), the top kernels, the
median wall ms of the unprofiled steps after the profiled one, and the
device busy share (device ms of the profiled step over that median: one
stream, so kernels never overlap). ``--smoke --device cpu`` runs the same
steps at smoke size on the CPU to check the script; it reports no device
numbers there.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.launch import train_path
from repro_torch.launch.profile_serve import _device_report
from repro_torch.train.trainer import make_train_step, to_batch


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--arch", default=train_path.ARCH,
                    choices=sorted(train_path.DEPTH_CUTS))
    ap.add_argument("--smoke", action="store_true",
                    help="smoke-size config (script check on the CPU)")
    ap.add_argument("--steps", type=int, default=3,
                    help="unprofiled steps before and after the profiled one")
    args = ap.parse_args(argv)
    tp = train_path.build(args.device, smoke=args.smoke, arch=args.arch)
    on_card = tp.device.type == "cuda"
    state = tp.init_state(0)
    step_fn = make_train_step(tp.model, tp.config)
    loader = tp.loaders[0]

    def step():
        nonlocal state
        t0 = time.perf_counter()
        state, metrics = step_fn(state, to_batch(next(loader), tp.device))
        loss = float(metrics["loss"])
        if on_card:
            torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, loss

    before = [step() for _ in range(args.steps)]
    acts = [torch.profiler.ProfilerActivity.CPU]
    if on_card:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        profiled_ms, _ = step()
    after = [step() for _ in range(args.steps)]
    wall = float(np.median([ms for ms, _ in after]))
    report = {
        "device": torch.cuda.get_device_name(tp.device) if on_card
        else "cpu",
        "config": tp.cfg.arch_id, "layers": tp.cfg.n_layers,
        "tokens_per_step": tp.tokens_per_step,
        "step_ms_before": [ms for ms, _ in before],
        "profiled_step_wall_ms": profiled_ms,
        "step_ms_median_after": wall,
        "tokens_per_s": tp.tokens_per_step / wall * 1e3,
        "losses": [loss for _, loss in before + after],
    }
    if on_card:
        report.update(_device_report(prof))
        report["device_busy_share"] = report["device_ms"] / wall
        report["peak_gib"] = torch.cuda.max_memory_allocated(tp.device) \
            / 2 ** 30
    else:
        report["device_busy_share"] = "not measured (CPU run)"
    print(json.dumps(report, indent=1))
    return report


if __name__ == "__main__":
    main()
