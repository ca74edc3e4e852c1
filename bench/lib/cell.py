"""One run of one cell: the runner of the mix's kind
(``bench/lib/<kind>_cell.py``), then the metrics the cell reports, the
comparison that decides ``correct``, and the result."""
from __future__ import annotations

import importlib.util
import sys
from types import SimpleNamespace
from typing import Dict

import torch

from bench.lib import checks, trace as trace_lib
from bench.lib.manifest import Manifest
from bench.lib.peaks import peaks
from bench.reference import decoder

JAX_NAMES = {"jax", "jaxlib", "flax", "repro"}


def load_reader(path):
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def foreign_modules(names=None):
    """Top-level names among ``names`` (``sys.modules`` by default) that
    are JAX or the JAX package, compared whole."""
    return sorted({m.split(".")[0] for m in (names or sys.modules)}
                  & JAX_NAMES)


def execute(m: Manifest, workload: str, seed: int, seconds: float,
            trace: bool, device: torch.device, t_start: float,
            limits: Dict[str, float] = None) -> dict:
    cell = m.workload(workload)
    cfg = m.config(cell["config"])
    mix = m.traffic(cell["traffic"])
    layer = m.metrics_of("per_layer", workload) if trace else []
    readers = {x["name"]: load_reader(m.metric_file(x["name"]))
               for x in layer}
    ops = sorted({op for r in readers.values()
                  for op in getattr(r, "OPS", ())})
    runner = importlib.import_module(f"bench.lib.{mix['kind']}_cell")
    run = runner.run(cell, cfg, mix, seed, seconds, trace, device, t_start,
                     probe_ops=ops)
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    result = {"correct": None, "attempted": run["attempted"],
              "failed": run["failed"], "metrics": {},
              "device": {"platform": "gpu" if device.type == "cuda"
                         else "cpu", "kind": kind,
                         "count": cell["chips"],
                         "memory_peak_bytes": run["memory_peak_bytes"]}}
    if trace:
        summary = trace_lib.summarize(run["prof"], run["trace_window_s"])
        ctx = SimpleNamespace(
            cfg=cfg, mix=mix, peaks=peaks(kind) if device.type == "cuda"
            else peaks("NVIDIA H100 80GB HBM3"),
            layout=decoder.model_module(cfg).layout(cfg), trace=summary,
            calls=run["probe"].calls, **run["context"])
        run["probe"].finish()
        for x in layer:
            v = readers[x["name"]].read(ctx)
            if v is not None:
                result["metrics"][x["name"]] = {"value": v,
                                                "unit": x["unit"]}
        result["device"]["busy_s"] = summary["busy_s"]
        result["device"]["window_s"] = summary["window_s"]
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    else:
        for x in m.metrics_of("end_to_end", workload):
            v = run["end_to_end"].get(x["name"])
            if v is not None:
                result["metrics"][x["name"]] = {"value": v,
                                                "unit": x["unit"]}
    if limits is None:
        limits = checks.load_limits(m.limits_file(workload))
    ok, table = checks.judge(run["numbers"], limits)
    result["correct"] = bool(ok and run["failed"] == 0)
    result["checks"] = table
    result["_readings"] = run["readings"]
    return result
