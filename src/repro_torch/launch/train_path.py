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

``arch`` trains another ported config on the same deployment, cut to
``DEPTH_CUTS[arch]`` layers: ``deepseek_moe_16b`` (the moe family) at 4 of
its 28 layers, 2.77 B params with its tables, the size of Qwen3-8B's 8
layers; ``zamba2_2_7b`` (the hybrid family) whole, 54 Mamba2 layers in 9
groups and the shared attention block, 2.42 B params (38.7 GB of train
state), at the ``train_4k`` shape; ``xlstm_125m`` (the ssm family)
whole, 12 layers, 0.19 B params, at ``SSM_SEQ_LEN`` tokens, its own
2048-token training context (arXiv:2405.04517) — its one cut: at 4096 its
sLSTM's per-position loop took 25–26 s a step on the card, too much of
``chip_smoke.py``'s time limit; both with their scans in the training
form;
``whisper_small`` (the audio family) whole, 12 encoder and 12
decoder layers, 0.33 B params an expert: each expert step takes
``AUDIO_BATCH`` sequences of ``AUDIO_SEQ_LEN`` tokens (Whisper's decoder
context) and their frames. ``STEPS_BY_ARCH`` gives the configs that take
fewer than ``STEPS`` steps (4: enough for the falling-loss check under the
launcher's 5-step warmup). The launcher's corpus
has no audio and the reference's launcher cannot make frames, so
``FramesLoader`` adds each batch's seeded (B, 1500, 768) float32 frames
(30 s of audio at 50 frames a second), drawn on the device. ``smoke=True``
builds it at smoke size: the float32 smoke config of ``arch`` (2 layers,
D = 128), ``SMOKE_SEQ_LEN`` tokens, ``SMOKE_STEPS`` steps.
"""
from __future__ import annotations

import argparse
from dataclasses import dataclass
from typing import Any, Dict, Iterator, List

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
# each trained config's full-width depth: at 16 bytes of train state a
# parameter, ~2.8 B parameters fit one card beside the activations
DEPTH_CUTS = {ARCH: N_LAYERS, "deepseek_moe_16b": 4, "whisper_small": 12,
              "zamba2_2_7b": 54, "xlstm_125m": 12}
N_EXPERTS = 2
BATCH = 2                 # the launcher's --batch: one sequence per expert
SEQ_LEN = INPUT_SHAPES["train_4k"].seq_len
STEPS = 8
SMOKE_SEQ_LEN = 32
SMOKE_STEPS = 3
AUDIO_BATCH = 8           # sequences an expert step (the audio family)
AUDIO_SEQ_LEN = 448       # Whisper's decoder context (n_text_ctx)
STEPS_BY_ARCH = {"whisper_small": 4, "zamba2_2_7b": 4, "xlstm_125m": 4}
SSM_SEQ_LEN = 2048        # xLSTM's training context (the ssm family)
FRAME_SEED = 7000         # expert k's step s: seeded 7000 + 1000·k + s


class FramesLoader:
    """A shard loader whose batches also carry ``frames``: step s draws
    (B, n_audio_frames, audio_dim) float32 normal frames on ``device``
    from a generator seeded ``seed + s``."""

    def __init__(self, loader, cfg: ModelConfig, seed: int, device):
        self.loader, self.cfg, self.seed = loader, cfg, seed
        self.device, self.step = device, 0

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        return self

    def __next__(self) -> Dict[str, Any]:
        batch = next(self.loader)
        gen = torch.Generator(device=self.device).manual_seed(
            self.seed + self.step)
        self.step += 1
        return dict(batch, frames=torch.randn(
            (batch["tokens"].shape[0], self.cfg.n_audio_frames,
             self.cfg.audio_dim), generator=gen, device=self.device))


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


def build(device="cuda", *, smoke: bool = False, arch: str = ARCH
          ) -> TrainPath:
    dev = resolve_device(device)
    cfg = get_smoke_config(arch) if smoke else \
        get_config(arch).reduced(n_layers=DEPTH_CUTS[arch])
    audio = cfg.family == "audio"
    seq = SMOKE_SEQ_LEN if smoke else AUDIO_SEQ_LEN if audio else \
        SSM_SEQ_LEN if cfg.family == "ssm" else SEQ_LEN
    steps = SMOKE_STEPS if smoke else STEPS_BY_ARCH.get(arch, STEPS)
    batch = AUDIO_BATCH * N_EXPERTS if audio and not smoke else BATCH
    args = train.parse_args(["--arch", arch, "--experts", str(N_EXPERTS),
                             "--batch", str(batch), "--steps", str(steps),
                             "--seq-len", str(seq), "--device", str(dev)])
    part, loaders = train.partition_and_loaders(args,
                                                train.build_corpus(args))
    if audio:
        loaders = [FramesLoader(ld, cfg, FRAME_SEED + 1000 * k, dev)
                   for k, ld in enumerate(loaders)]
    return TrainPath(cfg, build_model(cfg), args, part, loaders,
                     TrainConfig(opt=train.opt_config(args)), dev)
