"""Granite-3 8B — dense GQA [hf:ibm-granite/granite-3.0 family]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="granite_3_8b", family="dense", n_layers=40, d_model=4_096,
    n_heads=32, n_kv_heads=8, d_ff=12_800, vocab=49_155, d_head=128,
    tie_embeddings=True, source="hf:ibm-granite/granite-3.0-2b-base",
)


def smoke_config():
    return ModelConfig(
        arch_id="granite_smoke", family="dense", n_layers=2, d_model=128,
        n_heads=4, n_kv_heads=2, d_ff=256, vocab=512, d_head=32,
        tie_embeddings=True, param_dtype="float32", compute_dtype="float32",
    )
