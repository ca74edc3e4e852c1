"""Operations and bytes: of the model's step (for the MFU metrics) and of
one call of each attention entry point (for its roofline), from shapes
alone, the same count whatever implements the op. Each input byte is
counted read once and each output byte written once; a causal op counts
the key positions each query row needs."""
from __future__ import annotations

from typing import Dict, Sequence

from bench.lib.weights import count


def dense_params(layout, cfg: dict) -> int:
    """Parameters every token passes through: all but the input embedding
    table."""
    n = count(layout, cfg["num_hidden_layers"], skip=("embed.embedding",))
    if cfg["tie_word_embeddings"]:        # the table is also the head
        n += cfg["vocab_size"] * cfg["hidden_size"]
    return n


def attn_width(cfg: dict) -> int:
    """H · dh: the query width of one layer's QKᵀ and PV products."""
    dh = cfg.get("head_dim") or cfg["hidden_size"] // \
        cfg["num_attention_heads"]
    return cfg["num_attention_heads"] * dh


def attn_flops(cfg: dict, keys: int) -> float:
    """QKᵀ and PV of one query row over ``keys`` key positions, all
    layers: 2 products x 2 operations x keys x H·dh each layer."""
    return 4.0 * keys * attn_width(cfg) * cfg["num_hidden_layers"]


def causal_pairs(start: int, n: int) -> float:
    """Σ (start + i + 1) for i < n: the key positions n causal query rows
    at positions start..start+n-1 need."""
    return n * start + n * (n + 1) / 2.0


def forward_flops(N: int, cfg: dict, start: int, n: int) -> float:
    """The model's forward over n tokens at positions start..start+n-1:
    2·N a token plus causal attention."""
    return 2.0 * N * n + attn_flops(cfg, 1) * causal_pairs(start, n)


def _size(dtype: str) -> int:
    return {"torch.bfloat16": 2, "torch.float16": 2,
            "torch.float32": 4}[dtype]


def chunk_prefill(call: Dict) -> Sequence[float]:
    """(FLOPs, bytes) of ``chunk_prefill_attention(q (B,C,H,dh), k_pool,
    v_pool (P,block,KV,dh), start, block_table)``."""
    q, kp, start = call["args"][0], call["args"][1], call["args"][3]
    shape = q["shape"] if len(q["shape"]) == 4 else (1, *q["shape"])
    B, C, H, dh = shape
    KV = kp["shape"][2]
    s = _size(q["dtype"])
    flops = 4.0 * H * dh * B * causal_pairs(start, C)
    data = s * (2 * B * C * H * dh + 2 * B * (start + C) * KV * dh)
    return flops, data


def paged_decode(call: Dict) -> Sequence[float]:
    """(FLOPs, bytes) of ``paged_decode_attention(q (B,H,dh), k_pool,
    v_pool (P,block,KV,dh), pos (B,), block_tables (B,NB))``: row b reads
    the keys up to min(pos_b, NB·block - 1)."""
    q, kp, pos, bt = (call["args"][i] for i in (0, 1, 3, 4))
    B, H, dh = q["shape"]
    _, block, KV, _ = kp["shape"]
    span = bt["shape"][1] * block
    keys = sum(min(int(p), span - 1) + 1 for p in pos["values"])
    s = _size(q["dtype"])
    flops = 4.0 * H * dh * keys
    data = s * (2 * B * H * dh + 2 * keys * KV * dh) + 4 * B * (1 + bt[
        "shape"][1])
    return flops, data


def _flash_shapes(call: Dict):
    q, k = call["args"][0], call["args"][1]
    B, S, H, dh = q["shape"]
    return B, S, H, k["shape"][2], dh, _size(q["dtype"]), \
        call["kwargs"].get("causal", True)


def flash_fwd(call: Dict) -> Sequence[float]:
    """(FLOPs, bytes) of ``_flash_fwd(q (B,S,H,dh), k, v (B,S,KV,dh))``:
    out and the float32 lse written."""
    B, S, H, KV, dh, s, causal = _flash_shapes(call)
    pairs = causal_pairs(0, S) if causal else float(S * S)
    flops = 4.0 * B * H * dh * pairs
    data = s * (2 * B * S * H * dh + 2 * B * S * KV * dh) + 4 * B * S * H
    return flops, data


def flash_bwd(call: Dict) -> Sequence[float]:
    """(FLOPs, bytes) of ``_flash_bwd(q, k, v, out, lse, do)``: five
    products (S and P again, dP, dV, dQ, dK) and q, k, v, out, do, lse
    read, dq, dk, dv written."""
    B, S, H, KV, dh, s, causal = _flash_shapes(call)
    pairs = causal_pairs(0, S) if causal else float(S * S)
    flops = 10.0 * B * H * dh * pairs
    data = s * (3 * B * S * H * dh + 2 * B * S * KV * dh) + 4 * B * S * H \
        + s * (B * S * H * dh + 2 * B * S * KV * dh)
    return flops, data
