"""xLSTM-125M — alternating mLSTM/sLSTM blocks, no FFN (d_ff=0)
[arXiv:2405.04517]."""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    arch_id="xlstm_125m", family="ssm", n_layers=12, d_model=768,
    n_heads=4, n_kv_heads=4, d_ff=0, vocab=50_304,
    ssm=SSMConfig(expand=2, chunk=256, slstm_every=4),
    source="arXiv:2405.04517",
)


def smoke_config():
    return ModelConfig(
        arch_id="xlstm_smoke", family="ssm", n_layers=2, d_model=128,
        n_heads=4, n_kv_heads=4, d_ff=0, vocab=512,
        ssm=SSMConfig(expand=2, chunk=16, slstm_every=2),
        param_dtype="float32", compute_dtype="float32",
    )
