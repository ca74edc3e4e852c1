"""The one door from the benchmark into the program under test, the
PyTorch and CUDA package ``repro_torch`` under ``src/``: its model, train
step, optimizer state, serving engine, router and kernel entry points.
Nothing else in ``bench/`` imports the program, and nothing here imports
JAX or the JAX package."""
from __future__ import annotations

import importlib
import sys
from pathlib import Path
from typing import Dict

ROOT = Path(__file__).resolve().parents[2]


def _import():
    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    return importlib.import_module("repro_torch")


def model_config(cfg: dict, remat: str = "full"):
    _import()
    from repro_torch.configs.base import ModelConfig, MoEConfig
    adapter = importlib.import_module(f"bench.adapters.{cfg['model_type']}")
    return adapter.port_config(cfg, ModelConfig, MoEConfig, remat)


def build_model(cfg: dict, remat: str = "full"):
    _import()
    from repro_torch.models import build_model as build
    return build(model_config(cfg, remat))


def check_layout(model, layout) -> None:
    """The program's parameter tree has exactly the benchmark's leaves, at
    the benchmark's shapes (layer leaves with the layer dim in front)."""
    from repro_torch.models.params import ParamSpec
    n = model.cfg.n_layers
    got: Dict[str, tuple] = {}

    def walk(node, prefix):
        for k, v in node.items():
            path = f"{prefix}.{k}" if prefix else k
            if isinstance(v, ParamSpec):
                got[path] = tuple(v.shape)
            else:
                walk(v, path)

    walk(model.param_specs(), "")
    want = {p: ((n, *s) if per else tuple(s))
            for p, (s, per, _) in layout.items()}
    if got != want:
        raise ValueError(f"the program's parameters {got} are not the "
                         f"benchmark's layout {want}")


def train_step(model, opt_cfg):
    """The program's train step: (state, batch) → (state, metrics), the
    state updated in place."""
    from repro_torch.train.trainer import TrainConfig, make_train_step
    return make_train_step(model, TrainConfig(opt=opt_cfg))


def optimizer(opt: dict):
    from repro_torch.optim.adamw import AdamWConfig
    return AdamWConfig(**opt)


def train_state(params):
    """The program's train state around ``params``: its AdamW moments and
    float32 master copy."""
    from repro_torch.optim.adamw import init_state
    return {"params": params, "opt": init_state(params)}


def serving_engine(model, experts, centroids, deployment: dict, device):
    import torch

    from repro_torch.core.router import CentroidRouter, RouterConfig
    from repro_torch.serve.api import EngineConfig
    from repro_torch.serve.scheduler import make_engine
    d = deployment
    router = CentroidRouter(torch.as_tensor(centroids),
                            RouterConfig(temperature=d["router_temperature"],
                                         top_k=d["router_top_k"]))
    config = EngineConfig(
        n_slots=d["slots"], cache_len=d["cache_len"], paged=d["paged"],
        page_block=d["page_block"], chunked_prefill=d["chunked_prefill"],
        chunk=d["chunk"], fused_step=d["fused_step"],
        strategy=d["strategy"])
    return make_engine(model, experts=experts, router=router, device=device,
                       config=config)


def sampling(max_new: int):
    from repro_torch.serve.api import SamplingParams
    return SamplingParams(max_new=max_new)


def kernel_ops():
    """The kernel seam module, whose entry points a traced run wraps."""
    return importlib.import_module("repro_torch.kernels.ops")


def registries(engine):
    """Each pod's metrics registry."""
    return [pod.obs.registry for pod in engine.pods]
