"""Llama-3 405B — dense GQA, 128k vocab [arXiv:2407.21783]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="llama3_405b", family="dense", n_layers=126, d_model=16_384,
    n_heads=128, n_kv_heads=8, d_ff=53_248, vocab=128_256, d_head=128,
    rope_theta=500_000.0, source="arXiv:2407.21783",
)


def smoke_config():
    return ModelConfig(
        arch_id="llama3_405b_smoke", family="dense", n_layers=2, d_model=256,
        n_heads=4, n_kv_heads=2, d_ff=512, vocab=512, d_head=64,
        rope_theta=500_000.0, param_dtype="float32", compute_dtype="float32",
    )
