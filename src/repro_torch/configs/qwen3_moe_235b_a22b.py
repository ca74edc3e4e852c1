"""Qwen3-MoE 235B-A22B — 128 experts, top-8, GQA, qk-norm
[hf:Qwen/Qwen3-30B-A3B family]."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="qwen3_moe_235b_a22b", family="moe", n_layers=94, d_model=4_096,
    n_heads=64, n_kv_heads=4, d_ff=1_536, vocab=151_936, d_head=128,
    qk_norm=True, rope_theta=1_000_000.0,
    moe=MoEConfig(n_experts=128, top_k=8, n_shared=0, d_ff_expert=1_536),
    source="hf:Qwen/Qwen3-30B-A3B",
)


def smoke_config():
    return ModelConfig(
        arch_id="qwen3_moe_smoke", family="moe", n_layers=2, d_model=128,
        n_heads=4, n_kv_heads=2, d_ff=128, vocab=512, d_head=32,
        qk_norm=True, moe=MoEConfig(n_experts=4, top_k=2, n_shared=0,
                                    d_ff_expert=128, capacity_factor=8.0),
        param_dtype="float32", compute_dtype="float32",
    )
