"""Phi-3-medium 14B — RoPE + SwiGLU + GQA [arXiv:2404.14219]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="phi3_medium_14b", family="dense", n_layers=40, d_model=5_120,
    n_heads=40, n_kv_heads=10, d_ff=17_920, vocab=100_352, d_head=128,
    source="arXiv:2404.14219",
)


def smoke_config():
    return ModelConfig(
        arch_id="phi3_smoke", family="dense", n_layers=2, d_model=160,
        n_heads=4, n_kv_heads=2, d_ff=320, vocab=512, d_head=40,
        param_dtype="float32", compute_dtype="float32",
    )
