"""DeepSeekMoE-16B — 2 shared + 64 routed experts, top-6, fine-grained
[arXiv:2401.06066]."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="deepseek_moe_16b", family="moe", n_layers=28, d_model=2_048,
    n_heads=16, n_kv_heads=16, d_ff=1_408, vocab=102_400, d_head=128,
    moe=MoEConfig(n_experts=64, top_k=6, n_shared=2, d_ff_expert=1_408),
    source="arXiv:2401.06066",
)


def smoke_config():
    return ModelConfig(
        arch_id="deepseek_moe_smoke", family="moe", n_layers=2, d_model=128,
        n_heads=4, n_kv_heads=4, d_ff=128, vocab=512, d_head=32,
        moe=MoEConfig(n_experts=4, top_k=2, n_shared=1, d_ff_expert=128,
                      capacity_factor=8.0),
        param_dtype="float32", compute_dtype="float32",
    )
