"""InternVL2-2B — InternViT (stub frontend) + InternLM2-1.8B LM backbone
[arXiv:2404.16821]. The LM consumes projected patch embeddings."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="internvl2_2b", family="vlm", n_layers=24, d_model=2_048,
    n_heads=16, n_kv_heads=8, d_ff=8_192, vocab=92_553, d_head=128,
    vision_dim=1_024, n_patches=256, source="arXiv:2404.16821",
)


def smoke_config():
    return ModelConfig(
        arch_id="internvl2_smoke", family="vlm", n_layers=2, d_model=128,
        n_heads=4, n_kv_heads=2, d_ff=256, vocab=512, d_head=32,
        vision_dim=64, n_patches=16,
        param_dtype="float32", compute_dtype="float32",
    )
