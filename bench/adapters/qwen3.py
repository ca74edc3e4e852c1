"""The program's model configuration for a ``qwen3`` configuration file:
the dense family with a per-head RMSNorm on queries and keys."""


def port_config(cfg: dict, ModelConfig, MoEConfig, remat: str):
    return ModelConfig(
        arch_id=cfg["name"], family="dense",
        n_layers=cfg["num_hidden_layers"], d_model=cfg["hidden_size"],
        n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg["num_key_value_heads"], d_ff=cfg["intermediate_size"],
        vocab=cfg["vocab_size"], d_head=cfg["head_dim"], qk_norm=True,
        rope_theta=float(cfg["rope_theta"]), norm_eps=cfg["rms_norm_eps"],
        tie_embeddings=cfg["tie_word_embeddings"],
        param_dtype=cfg["torch_dtype"], compute_dtype=cfg["torch_dtype"],
        remat=remat, source=cfg["source"])
