"""Multi-pod dry run (port of ``repro.launch.dryrun``): run one step of
every (arch × input shape × mesh) case on fake tensors placed on the
production mesh (no allocation), and report the per-device memory of the
placed arguments, the FLOPs and bytes each device's shards go through, the
collective schedule, the roofline terms against the H100's data-sheet
peaks, and the decentralized mode's zero-cross-pod property.

Inside ``main()`` (never at import) it starts ``torch.distributed`` with
the fake backend at the mesh's world size (256 or 512 ranks, this process
being rank 0), builds the production mesh, and — under ``FakeTensorMode``
with CPU fake tensors, so the kernel seam takes the plain versions — places
the state and batch by the sharding rules and runs the step: one placed
train step (``train/trainer.py``), or prefill, or one decode step, with the
serving rules' ``fsdp=False``, as the reference's ``build_case`` does.
What a device does is counted by ``roofline.CollectiveRecorder`` on the
local shards: FLOPs by ``torch.utils.flop_counter``'s formulas, bytes as an
unfused operand + result count (it overstates what the fused kernels
move), and each collective with its group's ranks. The world size is fixed
per process, so ``--all`` runs each case in a process of its own.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3_8b \\
        --shape train_4k --mesh multi --mode decentralized
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh multi \\
        --mode decentralized
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time
import traceback
from dataclasses import asdict, replace
from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import (INPUT_SHAPES, PORTED_ARCH_IDS,
                                      InputShape, ModelConfig, get_config)
from repro_torch.launch.roofline import (CollectiveRecorder, RooflineReport,
                                         active_params, collective_summary,
                                         link_bw, model_flops)
from repro_torch.models import build_model
from repro_torch.models.params import (count_params, mesh_sizes, norm_axes,
                                       tree_shapes, tree_shardings)
from repro_torch.sharding import rules as R
from repro_torch.train import trainer as T
from repro_torch.tree import flat_leaves, tree_map

LONG_DECODE_WINDOW = 8192      # sliding window applied at long_500k
POD_SIZE = 256


def shape_cfg(cfg: ModelConfig, shape: InputShape) -> ModelConfig:
    """long_500k needs sub-quadratic attention: window the attention archs
    (xLSTM has none; whisper is skipped upstream)."""
    if shape.name == "long_500k" and cfg.family in ("dense", "moe", "vlm",
                                                    "hybrid"):
        return replace(cfg, sliding_window=LONG_DECODE_WINDOW)
    return cfg


def is_skipped(arch: str, shape: InputShape) -> Optional[str]:
    if arch == "whisper_small" and shape.name == "long_500k":
        return ("enc-dec with a 448-position decoder by construction; "
                "524k-token decode is out of family (DESIGN.md §Shape/skip)")
    return None


def batch_shapes(cfg: ModelConfig, shape: InputShape,
                 decentralized_k: int = 0) -> Dict[str, torch.Tensor]:
    """The batch as ``meta`` tensors."""
    B = shape.global_batch
    if decentralized_k:
        B = B // decentralized_k
    lead = (decentralized_k,) if decentralized_k else ()
    S = shape.seq_len
    n_text = S - (cfg.n_patches if cfg.family == "vlm" else 0)

    def meta(s, dt):
        return torch.empty(s, dtype=dt, device="meta")

    out = {"tokens": meta(lead + (B, n_text), torch.int32),
           "labels": meta(lead + (B, n_text), torch.int32)}
    if cfg.family == "vlm":
        out["patches"] = meta(lead + (B, cfg.n_patches, cfg.vision_dim),
                              torch.bfloat16)
    if cfg.family == "audio":
        out["frames"] = meta(lead + (B, cfg.n_audio_frames, cfg.audio_dim),
                             torch.bfloat16)
    return out


def state_struct(model, cfg: ModelConfig, decentralized_k: int = 0):
    """The train state as ``meta`` tensors: bf16 params; f32 m/v/master;
    i32 count."""
    lead = (decentralized_k,) if decentralized_k else ()
    specs = model.param_specs()
    p = tree_shapes(specs, cfg.pdtype, extra_leading=lead)
    return {"params": p,
            "opt": {"m": tree_shapes(specs, torch.float32, lead),
                    "v": tree_shapes(specs, torch.float32, lead),
                    "master": tree_shapes(specs, torch.float32, lead),
                    "count": torch.empty(lead, dtype=torch.int32,
                                         device="meta")}}


def state_shardings(model, rules, mesh, decentralized_k: int = 0):
    """The dry run's variant of the state's specs: ``count`` over
    ``dexpert`` (``trainer.state_shardings`` keeps it whole). Returns
    (specs, the metrics' spec)."""
    specs = T.state_shardings(model, rules, mesh, decentralized_k,
                              count_over_experts=True)
    return specs, specs["opt"]["count"]


def _if_divisible(mesh, axes, dim: int):
    """Return the mesh axes only when they evenly divide the dimension."""
    if axes is None:
        return None
    t = axes if isinstance(axes, tuple) else (axes,)
    sizes = mesh_sizes(mesh)
    ext = math.prod(sizes[a] for a in t)
    return axes if (dim % ext == 0 and dim >= ext) else None


def batch_shardings(rules, mesh, cfg, shapes: Dict,
                    decentralized_k: int = 0) -> Dict[str, tuple]:
    lead = (norm_axes(rules["dexpert"]),) if decentralized_k else ()
    b = rules["act_batch"]
    out = {}
    for k, v in shapes.items():
        bdim = v.shape[len(lead)]
        trailing = (None,) * (len(v.shape) - len(lead) - 1)
        out[k] = (*lead, norm_axes(_if_divisible(mesh, b, bdim)), *trailing)
    return out


OVERRIDES: Dict[str, Any] = {}     # config variants, set by --override
RULE_OVERRIDES: Dict[str, Any] = {}  # sharding-rule variants (--no-fsdp)


def apply_overrides(cfg: ModelConfig) -> ModelConfig:
    return replace(cfg, **OVERRIDES) if OVERRIDES else cfg


def probe_cfg(cfg: ModelConfig, G: int) -> ModelConfig:
    """Depth-G variant of the config (same widths), for the fit f(G) =
    outside + G·per_group over G = 1, 2."""
    over: Dict[str, Any] = {"unroll": True}
    if cfg.family == "ssm":
        over["n_layers"] = cfg.ssm.slstm_every * G
    elif cfg.family == "hybrid":
        over["n_layers"] = cfg.ssm.shared_attn_every * G
    else:
        over["n_layers"] = G
    if cfg.family == "audio":
        over["n_enc_layers"] = G
    return replace(cfg, **over)


# ---------------------------------------------------------------------------
# Placing fake tensors
# ---------------------------------------------------------------------------

def start_fake_world(world: int) -> None:
    """The fake process group at ``world`` ranks, this process rank 0."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=world)


def _place(t, spec, mesh):
    """A DTensor of ``t``'s global shape and dtype placed by ``spec``,
    whose local shard is a fresh (fake) tensor: nothing is scattered."""
    from torch.distributed.tensor import DTensor
    shape = tuple(t.shape)
    local = torch.zeros(R.local_shape(shape, spec, mesh), dtype=t.dtype)
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(local, mesh, R.placements(spec, mesh),
                              run_check=False, shape=shape, stride=stride)


def place_tree(shapes, specs, mesh):
    return tree_map(lambda t, s: _place(t, s, mesh), shapes, specs)


def _local_bytes(tree) -> int:
    return sum(t.to_local().numel() * t.element_size()
               for t in flat_leaves(tree))


def build_case(arch: str, shape_name: str, mesh_name: str, mode: str,
               n_experts: int = 2, depth_probe: int = 0):
    """Returns (run, make, model, cfg, mesh, shape): ``run(*make())`` is
    the placed step of the case (call both under ``FakeTensorMode``:
    ``make`` places the fake state and inputs)."""
    from repro_torch.launch.mesh import make_production_mesh

    shape = INPUT_SHAPES[shape_name]
    multi_pod = mesh_name == "multi"
    decentralized = mode == "decentralized"
    K = n_experts if decentralized else 0
    cfg = apply_overrides(shape_cfg(get_config(arch), shape))
    if depth_probe:
        cfg = probe_cfg(cfg, depth_probe)
    model = build_model(cfg)
    start_fake_world(2 * POD_SIZE if multi_pod else POD_SIZE)
    mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    # serving has no optimizer state: FSDP weight sharding over ``data``
    # would only buy per-layer all-gathers, so the serving rules replicate
    # weights over ``data`` (tensor-parallel over ``model`` only); training
    # keeps FSDP (the 405B-scale optimizer state needs it)
    rule_kw = dict(RULE_OVERRIDES)
    rule_kw.setdefault("fsdp", shape.kind == "train")
    rules = R.logical_rules(multi_pod=multi_pod, decentralized=decentralized,
                            **rule_kw)
    tc = T.TrainConfig()

    if shape.kind == "train":
        st_specs, _ = state_shardings(model, rules, mesh, K)
        b_shapes = batch_shapes(cfg, shape, K)
        b_specs = batch_shardings(rules, mesh, cfg, b_shapes, K)
        run = (T.make_placed_decentralized_train_step(model, tc, mesh)
               if decentralized else T.make_placed_train_step(model, tc))

        def make():
            return (place_tree(state_struct(model, cfg, K), st_specs, mesh),
                    place_tree(b_shapes, b_specs, mesh))

    else:
        p_specs = tree_shardings(model.param_specs(), rules, mesh)
        B = shape.global_batch

        if shape.kind == "prefill":
            b_shapes = batch_shapes(cfg, shape)
            b_specs = batch_shardings(rules, mesh, cfg, b_shapes)

            def make():
                return (place_tree(tree_shapes(model.param_specs(),
                                               cfg.pdtype), p_specs, mesh),
                        place_tree(b_shapes, b_specs, mesh))

            def run(params, batch):
                return T.run_placed(model.prefill, params, batch,
                                    shape.seq_len)

        else:  # decode
            cache_sh = model.cache_shapes(B, shape.seq_len)
            cache_specs = R.cache_pspec_tree(cache_sh, rules, mesh)
            b_ax = norm_axes(_if_divisible(mesh, rules["act_batch"], B))

            def make():
                meta = dict(device="meta")
                return (place_tree(tree_shapes(model.param_specs(),
                                               cfg.pdtype), p_specs, mesh),
                        place_tree(cache_sh, cache_specs, mesh),
                        _place(torch.empty((B,), dtype=torch.int32, **meta),
                               (b_ax,), mesh),
                        _place(torch.empty((B,), dtype=torch.int32, **meta),
                               (b_ax,), mesh))

            def run(params, cache, tokens, pos):
                return T.run_placed(model.decode_step, params, cache,
                                    tokens, pos)

    return run, make, model, cfg, mesh, shape


def _measure(arch, shape_name, mesh_name, mode, n_experts, depth_probe=0):
    from torch._subclasses.fake_tensor import FakeTensorMode

    run, make, model, cfg, mesh, shape = build_case(
        arch, shape_name, mesh_name, mode, n_experts, depth_probe)
    t0 = time.time()
    with FakeTensorMode():
        args = make()
        arg_bytes = _local_bytes(args)
        with CollectiveRecorder(pod_size=POD_SIZE, count_costs=True) as rec:
            run(*args)
    return {"model": model, "cfg": cfg, "mesh": mesh, "shape": shape,
            "rec": rec, "arg_bytes": arg_bytes,
            "step_s": time.time() - t0, "kv_local": _kv_local(shape, args)}


def _kv_local(shape: InputShape, args) -> Optional[list]:
    """A decode case's device shard of one layer's K cache, (B, S, KV,
    dh): the shape its decode kernel runs at (the sequence cut where the
    rules split it); None for other cases and caches without K."""
    if shape.kind != "decode" or "k" not in args[1]:
        return None
    return list(args[1]["k"].to_local().shape[-4:])


def _roofline(arch, shape_name, mesh_name, mode, cfg, model, n_dev, flops,
              bytes_, coll, bw):
    shape = INPUT_SHAPES[shape_name]
    total_p = count_params(model.param_specs())
    act_p = active_params(cfg, total_p, model)
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    mf = model_flops(cfg, act_p, tokens, shape.kind) / n_dev
    report = RooflineReport(
        arch=arch, shape=shape_name, mesh=mesh_name, mode=mode,
        flops_per_device=flops, bytes_per_device=bytes_,
        collective_bytes=coll, model_flops_per_device=mf,
        link_bw=bw).finalize()
    return total_p, act_p, report


def run_case(arch: str, shape_name: str, mesh_name: str, mode: str,
             n_experts: int = 2, save_schedule: Optional[str] = None
             ) -> Dict:
    shape = INPUT_SHAPES[shape_name]
    skip = is_skipped(arch, shape)
    case_id = f"{arch}.{shape_name}.{mesh_name}.{mode}"
    if skip:
        return {"case": case_id, "status": "skipped", "reason": skip}
    m = _measure(arch, shape_name, mesh_name, mode, n_experts)
    rec, cfg, model = m["rec"], m["cfg"], m["model"]
    if save_schedule:
        with open(save_schedule, "w") as f:
            json.dump([asdict(c) for c in rec.ops], f)
    csum = collective_summary(rec.ops)
    n_dev = m["mesh"].size()
    total_p, act_p, report = _roofline(
        arch, shape_name, mesh_name, mode, cfg, model, n_dev,
        float(rec.flops), float(rec.bytes_accessed),
        float(csum["total_bytes"]), link_bw(rec.ops))
    return {
        "case": case_id, "status": "ok",
        "n_devices": n_dev,
        "params_total": total_p, "params_active": act_p,
        "step_s": round(m["step_s"], 1),
        "memory": {"argument_size_in_bytes": m["arg_bytes"]},
        "cost": {"flops": float(rec.flops),
                 "bytes accessed": float(rec.bytes_accessed)},
        "collectives": csum,
        "roofline": asdict(report),
        "kv_local": m["kv_local"],
    }


def run_probe(arch: str, shape_name: str, mesh_name: str, mode: str,
              n_experts: int = 2, save_schedule: Optional[str] = None
              ) -> Dict:
    """Two shallow runs (G = 1, 2) → per-group + outside costs →
    depth-corrected roofline terms for the FULL config. ``save_schedule``
    keeps the collectives of the G = 1 run."""
    shape = INPUT_SHAPES[shape_name]
    skip = is_skipped(arch, shape)
    case_id = f"{arch}.{shape_name}.{mesh_name}.{mode}"
    if skip:
        return {"case": case_id, "status": "skipped", "reason": skip}
    meas, t0, bw, arg = {}, time.time(), [], {}
    for G in (1, 2):
        m = _measure(arch, shape_name, mesh_name, mode, n_experts, G)
        if save_schedule and G == 1:
            with open(save_schedule, "w") as f:
                json.dump([asdict(c) for c in m["rec"].ops], f)
        csum = collective_summary(m["rec"].ops)
        meas[G] = {"flops": float(m["rec"].flops),
                   "bytes": float(m["rec"].bytes_accessed),
                   "coll": float(csum["total_bytes"]),
                   "xpod": float(csum["cross_pod_bytes"]),
                   "xpod_ops": float(csum["cross_pod_ops"]),
                   "args": float(m["arg_bytes"])}
        bw.append(link_bw(m["rec"].ops))
        n_dev, kv_local = m["mesh"].size(), m["kv_local"]
    full_model = build_model(shape_cfg(get_config(arch), shape))
    G_full = full_model.n_groups

    def fit(key):
        per = meas[2][key] - meas[1][key]
        outside = meas[1][key] - per
        return max(outside, 0.0) + G_full * max(per, 0.0)

    corr = {k: fit(k) for k in ("flops", "bytes", "coll", "xpod",
                                "xpod_ops", "args")}
    cfg = shape_cfg(get_config(arch), shape)
    total_p, act_p, report = _roofline(
        arch, shape_name, mesh_name, mode, cfg, full_model, n_dev,
        corr["flops"], corr["bytes"], corr["coll"], min(bw))
    return {"case": case_id, "status": "ok", "kind": "depth_probe",
            "n_devices": n_dev, "G_full": G_full,
            "params_total": total_p, "params_active": act_p,
            "measured": meas, "corrected": corr,
            "xpod_corrected": corr["xpod"],
            "memory": {"argument_size_in_bytes": corr["args"]},
            "cost": {"flops": corr["flops"], "bytes accessed": corr["bytes"]},
            "collectives": {"total_bytes": corr["coll"],
                            "cross_pod_bytes": corr["xpod"],
                            "cross_pod_ops": corr["xpod_ops"]},
            "wall_s": round(time.time() - t0, 1),
            "roofline": asdict(report), "kv_local": kv_local}


def _case_argv(args, arch, shape) -> list:
    argv = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
            arch, "--shape", shape, "--mesh", args.mesh, "--mode", args.mode,
            "--experts", str(args.experts), "--out", args.out]
    for flag in ("probe", "no_fsdp", "skip_existing", "save_schedule"):
        if getattr(args, flag):
            argv.append("--" + flag.replace("_", "-"))
    if args.override:
        argv += ["--override", args.override]
    if args.tag:
        argv += ["--tag", args.tag]
    return argv


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=PORTED_ARCH_IDS)
    ap.add_argument("--shape", choices=list(INPUT_SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi"], default="single")
    ap.add_argument("--mode", choices=["dense", "decentralized"],
                    default="dense")
    ap.add_argument("--experts", type=int, default=2)
    ap.add_argument("--all", action="store_true",
                    help="every arch × shape on the given mesh/mode, each "
                         "case in a process of its own")
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--save-schedule", action="store_true",
                    help="write the recorded collectives (op, bytes, ranks, "
                         "crosses_pod) beside the case's JSON (with "
                         "--probe: those of the depth-1 run)")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--probe", action="store_true",
                    help="depth-corrected costs from two shallow runs "
                         "(G = 1, 2) instead of the full depth")
    ap.add_argument("--override", default=None,
                    help="JSON dict of ModelConfig field overrides, e.g. "
                         "'{\"remat\": \"dots\"}'")
    ap.add_argument("--tag", default="",
                    help="suffix for output filenames (variants)")
    ap.add_argument("--no-fsdp", action="store_true",
                    help="ZeRO-1 (weights whole over the data axis) "
                         "instead of ZeRO-3 weight sharding")
    args = ap.parse_args(argv)
    if args.override:
        OVERRIDES.update(json.loads(args.override))
    if args.no_fsdp:
        RULE_OVERRIDES["fsdp"] = False

    os.makedirs(args.out, exist_ok=True)
    if args.all:
        failures = 0
        for arch in PORTED_ARCH_IDS:
            for shape in INPUT_SHAPES:
                failures += subprocess.run(_case_argv(args, arch, shape)
                                           ).returncode != 0
        if failures:
            raise SystemExit(f"{failures} case(s) failed")
        return
    if not (args.arch and args.shape):
        ap.error("--arch and --shape, or --all")
    torch.set_num_threads(1)
    cid = f"{args.arch}.{args.shape}.{args.mesh}.{args.mode}"
    if args.tag:
        cid += f".{args.tag}"
    if args.probe:
        cid += ".probe"
    out_json = os.path.join(args.out, cid + ".json")
    if args.skip_existing and os.path.exists(out_json):
        with open(out_json) as f:
            if json.load(f).get("status") in ("ok", "skipped"):
                print(f"[cached ] {cid}", flush=True)
                return
    schedule = (os.path.join(args.out, cid + ".schedule.json")
                if args.save_schedule else None)
    try:
        if args.probe:
            rec = run_probe(args.arch, args.shape, args.mesh, args.mode,
                            args.experts, save_schedule=schedule)
        else:
            rec = run_case(args.arch, args.shape, args.mesh, args.mode,
                           args.experts, save_schedule=schedule)
    except Exception as e:
        rec = {"case": cid, "status": "error",
               "error": f"{type(e).__name__}: {e}",
               "trace": traceback.format_exc()[-2000:]}
    with open(out_json, "w") as f:
        json.dump(rec, f, indent=1)
    status, extra = rec["status"], ""
    if status == "ok":
        r = rec["roofline"]
        extra = (f" bottleneck={r['bottleneck']}"
                 f" compute={r['compute_s']:.4f}s"
                 f" mem={r['memory_s']:.4f}s"
                 f" coll={r['collective_s']:.4f}s"
                 f" xpod={rec['collectives']['cross_pod_bytes']}"
                 f" args_GiB="
                 f"{rec['memory']['argument_size_in_bytes'] / 2**30:.3f}")
        if rec.get("kv_local"):
            extra += f" kv_local={tuple(rec['kv_local'])}"
    elif status == "error":
        extra = " " + rec["error"][:300]
    print(f"[{status:7s}] {cid}{extra}", flush=True)
    if status == "error":
        raise SystemExit(1)


if __name__ == "__main__":
    main()
