"""Model assembly, dense family, paged serving path (port of
``repro.models.model``).

Parameters are nested dicts of tensors in the reference's pytree layout —
``{"embed": {...}, "blocks": {...}, "final_norm": ...}`` with every
``blocks`` leaf stacked on a leading layer dim — so weights cross between
the packages without transposes (``repro_torch.weights``). The reference's
``scan_layers`` over that dim is a Python loop here. Methods take the
params explicitly, as in the reference, so the pods of a decentralized
deployment share one ``Model``. Everything runs on the device of the
params and caches it is given.

Ported: ``cache_spec``, ``init_paged_cache``, ``embed_prompt``,
``init_chunk_carry``, ``prefill_chunk``, ``decode_step_paged`` and the
paged ``fused_decode_step``. The other families and the monolithic,
contiguous and speculative paths are not ported yet (see ROADMAP.md).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig

from . import attention as attn
from .layers import embed, embedding_specs, rms_norm, swiglu, swiglu_specs, unembed
from .params import ParamSpec, init_params, is_spec

Tensor = torch.Tensor


def stack_specs(tree, n: int):
    """Prepend a stacked layer dim to every ParamSpec in the tree."""
    if is_spec(tree):
        return ParamSpec((n,) + tree.shape, ("layer",) + tree.logical,
                         tree.init, tree.scale)
    return {k: stack_specs(v, n) for k, v in tree.items()}


def layer_slice(tree, i: int):
    """Layer ``i`` of a stacked parameter tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: layer_slice(v, i) for k, v in tree.items()}
    return tree[i]


def _norm_spec(d):
    return ParamSpec((d,), (None,), "ones")


@dataclass(frozen=True)
class PagedLayout:
    """Block-table indirection descriptor: ``seq_axes`` mirrors the cache
    dict and gives each pool leaf's sequence axis in the contiguous layout
    (−1 for leaves that stay per slot)."""
    block_size: int
    seq_axes: Any


@dataclass(frozen=True)
class CacheSpec:
    """Layout descriptor of a family's decode cache: the slot axis of each
    leaf, plus the paged layout when the cache pages through a pool."""
    batch_axes: Any
    paged: PagedLayout = None


class Model:
    def __init__(self, cfg: ModelConfig):
        if cfg.family != "dense":
            raise ValueError(
                f"family {cfg.family!r} is not ported to repro_torch yet "
                f"(see ROADMAP.md)")
        self.cfg = cfg

    # ------------------------------------------------------------------
    # Parameters
    # ------------------------------------------------------------------

    @property
    def n_groups(self) -> int:
        return self.cfg.n_layers

    def param_specs(self) -> Dict[str, Any]:
        cfg = self.cfg
        D = cfg.d_model
        block = {"ln1": _norm_spec(D), "attn": attn.attention_specs(cfg),
                 "ln2": _norm_spec(D), "ffn": swiglu_specs(D, cfg.d_ff)}
        return {
            "embed": embedding_specs(cfg.padded_vocab, D, cfg.tie_embeddings),
            "blocks": stack_specs(block, self.n_groups),
            "final_norm": _norm_spec(D),
        }

    def init(self, gen: torch.Generator, dtype=None):
        """Random parameters on ``gen.device`` (shape and scale parity with
        the reference's init; not its values)."""
        return init_params(gen, self.param_specs(), dtype or self.cfg.pdtype)

    # ------------------------------------------------------------------
    # Decode cache
    # ------------------------------------------------------------------

    def cache_spec(self, block_size: int = 0) -> CacheSpec:
        paged = PagedLayout(block_size, {"k": 2, "v": 2}) \
            if block_size > 0 else None
        return CacheSpec({"k": 1, "v": 1}, paged)

    def init_paged_cache(self, n_slots: int, n_blocks: int, block_size: int,
                         cache_len: int, device="cuda") -> Dict[str, Tensor]:
        """Zeroed (L, n_blocks, block_size, KV, dh) K and V pools in the
        compute dtype. ``n_slots``/``cache_len`` size only per-slot leaves,
        which the dense family does not have."""
        cfg = self.cfg
        shape = (self.n_groups, n_blocks, block_size, cfg.n_kv_heads,
                 cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=cfg.cdtype, device=device),
                "v": torch.zeros(shape, dtype=cfg.cdtype, device=device)}

    # ------------------------------------------------------------------
    # Chunked prefill
    # ------------------------------------------------------------------

    def embed_prompt(self, params, batch) -> Tensor:
        """Embedded prompt (1, W, D) for chunked prefill."""
        return embed(params["embed"], batch["tokens"], self.cfg.cdtype)

    def init_chunk_carry(self, params, batch, cache_len: int):
        """Per-request carry between chunks. Dense attention keeps no
        direct-leaf state — its chunks write straight into the pool — so
        the carry holds placeholders only, as in the reference."""
        dummy = torch.zeros((1,), dtype=self.cfg.cdtype,
                            device=params["final_norm"].device)
        return {"k": dummy, "v": dummy}

    def prefill_chunk(self, params, cache, carry, x: Tensor, start: int,
                      length: int, block_table: Tensor):
        """Consume one prompt chunk. x: (1,C,D) embedded rows at absolute
        positions start..start+C-1, ``length`` of them valid (host ints);
        block_table: (NB,) int32. Writes the chunk's K/V into the pool and
        returns (last_logits (1, V) at the final valid row, carry, cache)."""
        cfg = self.cfg
        blocks = params["blocks"]
        for i in range(self.n_groups):
            layer = layer_slice(blocks, i)
            a, _ = attn.chunk_attention(
                layer["attn"], rms_norm(x, layer["ln1"], cfg.norm_eps), cfg,
                (cache["k"][i], cache["v"][i]), start, length, block_table)
            h = x + a
            x = h + swiglu(layer["ffn"], rms_norm(h, layer["ln2"],
                                                  cfg.norm_eps))
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        h_last = x[:, length - 1:length]
        logits = unembed(params["embed"], h_last, cfg.tie_embeddings,
                         cfg.vocab)
        return logits[:, 0], carry, cache

    # ------------------------------------------------------------------
    # Decode
    # ------------------------------------------------------------------

    def decode_step_paged(self, params, cache, tokens: Tensor, pos: Tensor,
                          block_tables: Tensor):
        """One token per slot against the paged cache. tokens, pos: (B,)
        int32; block_tables: (B, NB) int32. Returns (logits (B, V), cache)."""
        cfg = self.cfg
        x = embed(params["embed"], tokens[:, None], cfg.cdtype)   # (B,1,D)
        blocks = params["blocks"]
        for i in range(self.n_groups):
            layer = layer_slice(blocks, i)
            a, _ = attn.paged_decode_attention(
                layer["attn"], rms_norm(x, layer["ln1"], cfg.norm_eps), cfg,
                (cache["k"][i], cache["v"][i]), pos, block_tables)
            h = x + a
            x = h + swiglu(layer["ffn"], rms_norm(h, layer["ln2"],
                                                  cfg.norm_eps))
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        logits = unembed(params["embed"], x, cfg.tie_embeddings, cfg.vocab)
        return logits[:, 0], cache

    def fused_decode_step(self, params, cache, state, *, cache_len: int):
        """One whole decode token: the paged forward followed by the serving
        epilogue (greedy pick, stop ids, budget and context bound, position
        advance). Returns (cache, new_state, next_tok, done)."""
        from repro_torch.serve.fused import decode_epilogue
        scores, cache = self.decode_step_paged(
            params, cache, state["tok"], state["pos"], state["tables"])
        state, nxt, done = decode_epilogue(scores, state, cache_len=cache_len)
        return cache, state, nxt, done


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
