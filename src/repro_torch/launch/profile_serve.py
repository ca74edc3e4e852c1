"""Where the time goes on the port's main path: ``torch.profiler`` windows
over the deployment of ``launch/main_path.py`` (the one ``chip_smoke.py``
serves: full-width Qwen3-8B, or another ported config with ``--arch``,
2 experts, 16 requests; Llama-3-405B at its full width is cut to 2
layers).

    PYTHONPATH=src python -m repro_torch.launch.profile_serve [--speculative]
        [--contiguous] [--mixture [--speculative]] [--arch zamba2_2_7b]

Serves every request to completion and times each engine step on the
host. Each step is of one kind: ``chunk`` (some pod consumed a prefill
chunk and none decoded: the first steps of the run), ``mixed`` (a
prefill chunk and a decode forward ran: the rest of the prefill phase),
``prefill`` (no chunk, and some request was admitted: a monolithic
prefill ran), ``spec_verify`` (no chunk, and some pod verified a
speculative span) or ``decode`` (vanilla decode forwards only).
``--speculative`` profiles the main path's deployment with n-gram
speculation (``main_path.speculative``); ``--contiguous`` the
reference's default deployment over the same model and requests
(``main_path.contiguous``: contiguous caches, monolithic prefill at
admission, so it has no mixed steps); ``--mixture`` the main path's
deployment under the Eq. 27 mixture (``main_path.mixture``: both experts
stacked, every step one stacked forward), and ``--mixture
--speculative`` that deployment with expert 0 drafting on the device and
the stacked verify; ``--arch zamba2_2_7b`` the same
deployment of the hybrid family (Mamba2 layers through the
``chunk_scan`` kernel, a shared attention block through the paged
kernels), ``--arch internvl2_2b`` that of the vlm family (each request
behind its 256 rows of image prefix), and ``granite_3_8b``,
``phi3_medium_14b`` and ``llama3_405b`` the dense family's other
configs. Two windows of ``WINDOW`` steps run under the profiler: the
first mixed steps (where there are any) and the first steps after the
last prompt was consumed (``decode``, or ``spec_verify`` with
``--speculative``). For
each window it prints the device time by kernel group (the port's CUDA
kernels, matrix products, everything else), the top kernels, and the
device busy share: kernel time over wall time, one stream, so kernels
never overlap. The profiler slows the host, so the wall time of a window
is taken as its steps times the unprofiled median of the ``WINDOW``
steps of the same kind that follow it. ``run_busy_share_est`` weighs
each window's device time per step by the run's count of steps of its
kind, over the wall time of those steps (the few chunk and prefill
steps are left out). ``--smoke --device cpu`` runs the same path at
smoke size on the CPU to check the script; it reports no device numbers
there.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.configs.base import PORTED_ARCH_IDS
from repro_torch.launch import main_path

WINDOW = 4            # engine steps under the profiler, per kind of step

# lower-case pieces of the demangled kernel names (the float32 paged and
# contiguous decode kernels are one template, told apart by its addressing
# argument; the bf16 ones and their merges have names of their own)
KERNEL_GROUPS = {
    "paged_decode_attention": ("pagedrows", "paged_decode_sm90",
                               "paged_decode_merge"),
    "decode_attention": ("contiguousrows", "contiguous_decode_sm90",
                         "contiguous_decode_merge"),
    "chunk_prefill_attention": ("chunk_prefill_kernel",
                                "chunk_prefill_sm90"),
    "paged_verify_attention": ("paged_verify_kernel", "paged_verify_sm90",
                               "verify_merge"),
    # the scalar chunk-scan kernels (chunk_scan_intra_kernel,
    # chunk_scan_kv_kernel) and the tensor-core one (chunk_scan_sm90) share
    # the group
    "chunk_scan": ("chunk_scan",),
    "flash_attention": ("flash_kernel", "flash_fwd_sm90"),
    "flash_attention_bwd": ("dq_kernel", "dkv_kernel", "dq_sm90",
                            "dkv_sm90"),
    "router_scores": ("router_kernel",),
    "matmul": ("gemm", "xmma", "cutlass", "cublas", "nvjet"),
}


def _group(name: str) -> str:
    low = name.lower()
    for group, keys in KERNEL_GROUPS.items():
        if any(k in low for k in keys):
            return group
    return "other"


def _kernel_us(evt) -> float:
    """Device time of a kernel row of ``key_averages()`` (0 for the CPU-op
    rows, whose device time repeats that of the kernels they launched)."""
    if evt.device_type != torch.autograd.DeviceType.CUDA:
        return 0.0
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def _device_report(prof) -> dict:
    groups, top = {}, []
    for evt in prof.key_averages():
        us = _kernel_us(evt)
        if us <= 0:
            continue
        g = _group(evt.key)
        groups[g] = groups.get(g, 0.0) + us / 1e3
        top.append((us / 1e3, evt.key, evt.count))
    return {"device_ms_by_group": groups,
            "device_ms": sum(groups.values()),
            "top_kernels": [{"ms": ms, "name": name[:80], "count": n}
                            for ms, name, n in sorted(top,
                                                      reverse=True)[:12]]}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true",
                    help="smoke-size config (script check on the CPU)")
    ap.add_argument("--speculative", action="store_true",
                    help="the main path with n-gram speculation (with "
                    "--mixture: expert-0 drafting)")
    ap.add_argument("--contiguous", action="store_true",
                    help="the reference's default deployment (contiguous "
                    "caches, monolithic prefill)")
    ap.add_argument("--mixture", action="store_true",
                    help="the main path under the Eq. 27 mixture (top_k 2)")
    ap.add_argument("--arch", choices=PORTED_ARCH_IDS,
                    default=main_path.ARCH)
    args = ap.parse_args(argv)
    if args.contiguous and (args.speculative or args.mixture):
        raise ValueError("--contiguous is a deployment of its own: pass it "
                         "without --speculative and --mixture")
    mp = main_path.build(args.device, smoke=args.smoke, arch=args.arch)
    if args.contiguous:
        mp = main_path.contiguous(mp)
    elif args.mixture:
        mp.engine = None             # the top-1 pools, before the stack
        mp = main_path.mixture(
            mp, speculative="expert" if args.speculative else None)
    elif args.speculative:
        mp = main_path.speculative(mp)
    engine = mp.engine
    on_card = engine.device.type == "cuda"
    mp.warm()
    mp.submit()

    def timed_step(window):
        # a pod runs a decode forward iff it has decoding slots before the
        # step (admission adds none; a finished prefill decodes next step)
        decoded = any(pod.decoding for pod in engine.pods)
        n0 = sum(pod.n_chunks for pod in engine.pods)
        v0 = sum(pod.n_spec_steps for pod in engine.pods)
        w0 = sum(len(pod.waiting) for pod in engine.pods)
        t0 = time.perf_counter()
        engine.step()
        if on_card:
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        chunked = sum(pod.n_chunks for pod in engine.pods) > n0
        verified = sum(pod.n_spec_steps for pod in engine.pods) > v0
        admitted = sum(len(pod.waiting) for pod in engine.pods) < w0
        kind = ("mixed" if decoded else "chunk") if chunked \
            else "prefill" if admitted \
            else "spec_verify" if verified else "decode"
        steps.append((kind, ms, window))

    def prefill_left():
        return any(pod.prefill_order or pod.waiting for pod in engine.pods)

    acts = [torch.profiler.ProfilerActivity.CPU]
    if on_card:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    steps, profs = [], {}

    def profiled(window):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(WINDOW):
                if engine.has_unfinished():
                    timed_step(window)
        profs[window] = prof

    while engine.has_unfinished() and prefill_left() and not any(
            pod.decoding for pod in engine.pods):
        timed_step(None)
    if engine.has_unfinished() and prefill_left():
        profiled("mixed")
    while engine.has_unfinished() and prefill_left():
        timed_step(None)
    if engine.has_unfinished():
        profiled("spec_verify" if args.speculative else "decode")
    while engine.has_unfinished():
        timed_step(None)

    kinds = ("chunk", "mixed", "prefill", "decode", "spec_verify")
    plain = {k: [ms for kind, ms, w in steps if kind == k and w is None]
             for k in kinds}
    report = {
        "device": torch.cuda.get_device_name(engine.device) if on_card
        else "cpu",
        "config": mp.cfg.arch_id, "layers": mp.cfg.n_layers,
        "strategy": mp.engine.config.strategy,
        "requests": len(mp.prompts), "steps": len(steps),
        "steps_by_kind": {k: sum(kind == k for kind, _, _ in steps)
                          for k in kinds},
        "step_ms_median": {k: float(np.median(v)) if v else None
                           for k, v in plain.items()},
        "windows": {},
    }
    run_device, run_wall = 0.0, 0.0
    for window, prof in profs.items():
        idx = [i for i, s in enumerate(steps) if s[2] == window]
        after = [ms for kind, ms, w in steps[idx[-1] + 1:]
                 if kind == window and w is None][:WINDOW]
        wall = len(idx) * float(np.median(after)) if after else None
        rec = {"steps": len(idx),
               "kinds": [steps[i][0] for i in idx],
               "unprofiled_wall_ms": wall}
        run_wall += sum(plain[window]) + (wall or 0.0)
        if on_card:
            rec.update(_device_report(prof))
            rec["device_busy_share"] = rec["device_ms"] / wall if wall \
                else None
            run_device += rec["device_ms"] / len(idx) \
                * report["steps_by_kind"][window]
        report["windows"][window] = rec
    report["wall_ms_of_windowed_kinds"] = run_wall
    if on_card and profs:
        report["run_busy_share_est"] = run_device / run_wall
    else:
        report["run_busy_share_est"] = "not measured" if on_card \
            else "not measured (CPU run)"
    print(json.dumps(report, indent=1))
    return report


if __name__ == "__main__":
    main()
