"""The port's full-width training deployment, built in one place for
``chip_smoke.py``: decentralized expert training (paper §5.1) as the
training launcher runs it (``launch/train.py``'s partition, loaders, seeds
and schedule), of Qwen3-8B at its full width — D = 4096, 32 query and 8
KV heads of 128, d_ff 12288, the 151936-token vocabulary, untied
embeddings, qk-norm, bf16 params and compute, ``remat="full"`` — with the
depth cut to ``N_LAYERS`` of its 36 layers (the one cut: the AdamW state
of 36 layers, 16 bytes a parameter, would be 131 GB).

Two experts on the launcher's balanced spherical k-means partition of the
synthetic corpus (its defaults: 2048 samples, feature dim 32, seed 0; the
corpus at the launcher's vocab of 512, whose ids are valid ids of the full
vocabulary — a (K, V, V) transition table at V = 151936 would be 739 GB),
at ``seq_len`` 4096 (the ``train_4k`` shape) with the launcher's
``--batch 2`` over K = 2 (one sequence per expert step), ``STEPS`` steps
each with the launcher's schedule (lr 1e-3, warmup max(steps // 20, 5),
cosine). No checkpoint is written at full width (44.6 GB per expert).

``smoke=True`` builds it at smoke size: the float32 ``qwen3_8b`` smoke
config (2 layers, D = 128), ``SMOKE_SEQ_LEN`` tokens, ``SMOKE_STEPS``
steps.
"""
from __future__ import annotations

import argparse
from dataclasses import dataclass
from typing import Any, Dict, List

import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import INPUT_SHAPES, ModelConfig
from repro_torch.data.partition import Partition
from repro_torch.data.pipeline import ShardLoader
from repro_torch.device import resolve_device
from repro_torch.launch import train
from repro_torch.models import build_model
from repro_torch.models.model import Model
from repro_torch.train.trainer import TrainConfig, init_train_state

ARCH = "qwen3_8b"
N_LAYERS = 8
N_EXPERTS = 2
BATCH = 2                 # the launcher's --batch: one sequence per expert
SEQ_LEN = INPUT_SHAPES["train_4k"].seq_len
STEPS = 8
SMOKE_SEQ_LEN = 32
SMOKE_STEPS = 3


@dataclass
class TrainPath:
    cfg: ModelConfig
    model: Model
    args: argparse.Namespace     # the launcher's flags for this deployment
    partition: Partition
    loaders: List[ShardLoader]   # one per expert, each read once
    config: TrainConfig
    device: torch.device

    @property
    def steps(self) -> int:
        return self.args.steps

    @property
    def tokens_per_step(self) -> int:
        return max(self.args.batch // self.args.experts, 1) * \
            self.args.seq_len

    def init_state(self, k: int, device=None) -> Dict[str, Any]:
        """Expert k's fresh train state, drawn on ``device`` (the
        deployment's by default) from the launcher's seed for it."""
        dev = self.device if device is None else torch.device(device)
        return init_train_state(self.model,
                                train.expert_generator(self.args, k, dev),
                                self.config.opt)


def build(device="cuda", *, smoke: bool = False) -> TrainPath:
    dev = resolve_device(device)
    seq, steps = (SMOKE_SEQ_LEN, SMOKE_STEPS) if smoke else (SEQ_LEN, STEPS)
    args = train.parse_args(["--arch", ARCH, "--experts", str(N_EXPERTS),
                             "--batch", str(BATCH), "--steps", str(steps),
                             "--seq-len", str(seq), "--device", str(dev)])
    cfg = get_smoke_config(ARCH) if smoke else \
        get_config(ARCH).reduced(n_layers=N_LAYERS)
    part, loaders = train.partition_and_loaders(args,
                                                train.build_corpus(args))
    return TrainPath(cfg, build_model(cfg), args, part, loaders,
                     TrainConfig(opt=train.opt_config(args)), dev)
