"""Architecture config + registry + input shapes (port of
``repro.configs.base``).

Field names, defaults and values are the reference's, so a port config and
its JAX counterpart compare equal field by field. Dtype fields stay strings;
``cdtype``/``pdtype`` map them to ``torch.dtype``. Only the families this
port has reached have config modules here (see ROADMAP.md).
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass, field, replace

import torch


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0            # routed experts
    top_k: int = 0
    n_shared: int = 0             # always-on shared experts (DeepSeek-MoE)
    d_ff_expert: int = 0          # per-expert FFN hidden dim
    capacity_factor: float = 1.25


@dataclass(frozen=True)
class SSMConfig:
    state: int = 64               # SSM state dim N (Mamba2) / mLSTM head dim
    conv: int = 4                 # local conv width (stubbed as identity-pad)
    expand: int = 2               # d_inner = expand * d_model
    chunk: int = 256              # chunkwise-scan block length
    slstm_every: int = 0          # xLSTM: every k-th block is an sLSTM block
    shared_attn_every: int = 0    # zamba2: shared attention block period


@dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str                   # dense | moe | vlm | audio | ssm | hybrid
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    source: str = ""              # citation for the assigned config
    d_head: int = 0               # 0 → d_model // n_heads
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    sliding_window: int = 0       # 0 → full attention; >0 → window size
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    moe: MoEConfig = field(default_factory=MoEConfig)
    ssm: SSMConfig = field(default_factory=SSMConfig)
    vision_dim: int = 0           # vlm: dim of incoming patch embeddings
    n_patches: int = 0            # vlm: image tokens per sample
    audio_dim: int = 0            # audio: dim of incoming frame embeddings
    n_audio_frames: int = 0       # audio: encoder sequence length
    n_enc_layers: int = 0         # audio: encoder depth (enc-dec)
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    attn_softmax_dtype: str = "float32"
    remat: str = "full"
    unroll: bool = False
    pad_vocab_to: int = 0

    @property
    def padded_vocab(self) -> int:
        if self.pad_vocab_to <= 0:
            return self.vocab
        m = self.pad_vocab_to
        return ((self.vocab + m - 1) // m) * m

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    @property
    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    @property
    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def is_enc_dec(self) -> bool:
        return self.family == "audio"

    def reduced(self, **overrides) -> "ModelConfig":
        return replace(self, **overrides)


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                     # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}

#: Architectures whose config module the port has (the others arrive with
#: their families — see ROADMAP.md).
PORTED_ARCH_IDS = ["qwen3_8b", "zamba2_2_7b", "granite_3_8b", "llama3_405b",
                   "phi3_medium_14b", "internvl2_2b"]


def _module(arch_id: str):
    name = arch_id.replace("-", "_")
    if name not in PORTED_ARCH_IDS:
        raise ValueError(
            f"arch {arch_id!r} is not ported to repro_torch yet (see "
            f"ROADMAP.md); ported: {PORTED_ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).CONFIG


def get_smoke_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).smoke_config()
