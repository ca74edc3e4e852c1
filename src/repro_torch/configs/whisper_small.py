"""Whisper-small — encoder-decoder; the conv/mel frontend is a stub that
provides precomputed frame embeddings [arXiv:2212.04356]. RoPE in place of
learned positional embeddings, as in the reference."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="whisper_small", family="audio", n_layers=12, d_model=768,
    n_heads=12, n_kv_heads=12, d_ff=3_072, vocab=51_865, d_head=64,
    audio_dim=768, n_audio_frames=1_500, n_enc_layers=12,
    source="arXiv:2212.04356",
)


def smoke_config():
    return ModelConfig(
        arch_id="whisper_smoke", family="audio", n_layers=2, d_model=128,
        n_heads=4, n_kv_heads=4, d_ff=256, vocab=512, d_head=32,
        audio_dim=128, n_audio_frames=32, n_enc_layers=2,
        param_dtype="float32", compute_dtype="float32",
    )
