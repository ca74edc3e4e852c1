"""Zamba2-2.7B — Mamba2 backbone + periodically-applied *shared* attention
block [arXiv:2411.15242]."""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    arch_id="zamba2_2_7b", family="hybrid", n_layers=54, d_model=2_560,
    n_heads=32, n_kv_heads=32, d_ff=10_240, vocab=32_000, d_head=80,
    ssm=SSMConfig(state=64, expand=2, chunk=256, shared_attn_every=6),
    source="arXiv:2411.15242",
)


def smoke_config():
    return ModelConfig(
        arch_id="zamba2_smoke", family="hybrid", n_layers=2, d_model=128,
        n_heads=4, n_kv_heads=4, d_ff=256, vocab=512, d_head=32,
        ssm=SSMConfig(state=16, expand=2, chunk=16, shared_attn_every=2),
        param_dtype="float32", compute_dtype="float32",
    )
