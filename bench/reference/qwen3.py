"""Plain float32 Qwen3 decoder layer (hf:Qwen/Qwen3-8B, "Qwen3 Technical
Report", arXiv:2505.09388): pre-norm RMSNorm, grouped-query attention with
a per-head RMSNorm on queries and keys before RoPE, SwiGLU FFN, untied
output head."""
from __future__ import annotations

import math
from typing import Dict

from .common import head_dim, swiglu


def layout(cfg: dict) -> Dict[str, tuple]:
    """path → (shape, per_layer, std): std None for a scale of ones, else
    the std of the normal draw (1/sqrt(fan-in) for a product's weight)."""
    D, F = cfg["hidden_size"], cfg["intermediate_size"]
    H, KV, V = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                cfg["vocab_size"])
    dh = head_dim(cfg)
    out = {
        "embed.embedding": ((V, D), False, 1.0),
        "final_norm": ((D,), False, None),
        "blocks.ln1": ((D,), True, None),
        "blocks.ln2": ((D,), True, None),
        "blocks.attn.wq": ((D, H, dh), True, 1 / math.sqrt(D)),
        "blocks.attn.wk": ((D, KV, dh), True, 1 / math.sqrt(D)),
        "blocks.attn.wv": ((D, KV, dh), True, 1 / math.sqrt(D)),
        "blocks.attn.wo": ((H, dh, D), True, 1 / math.sqrt(H * dh)),
        "blocks.attn.q_norm": ((dh,), True, None),
        "blocks.attn.k_norm": ((dh,), True, None),
        "blocks.ffn.w_gate": ((D, F), True, 1 / math.sqrt(D)),
        "blocks.ffn.w_up": ((D, F), True, 1 / math.sqrt(D)),
        "blocks.ffn.w_down": ((F, D), True, 1 / math.sqrt(F)),
    }
    if not cfg["tie_word_embeddings"]:
        out["embed.unembed"] = ((D, V), False, 1 / math.sqrt(D))
    return out


def ffn(prec, p, y, cfg):
    f = p["ffn"]
    return swiglu(prec, y, f["w_gate"], f["w_up"], f["w_down"])
