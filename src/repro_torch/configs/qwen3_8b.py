"""Qwen3-8B — dense GQA with qk-norm [hf:Qwen/Qwen3-8B]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen3_8b", family="dense", n_layers=36, d_model=4_096,
    n_heads=32, n_kv_heads=8, d_ff=12_288, vocab=151_936, d_head=128,
    qk_norm=True, rope_theta=1_000_000.0, source="hf:Qwen/Qwen3-8B",
)


def smoke_config():
    return ModelConfig(
        arch_id="qwen3_smoke", family="dense", n_layers=2, d_model=128,
        n_heads=4, n_kv_heads=2, d_ff=256, vocab=512, d_head=32,
        qk_norm=True, param_dtype="float32", compute_dtype="float32",
    )
