"""Model assembly, dense family, serving paths (port of
``repro.models.model``).

Parameters are nested dicts of tensors in the reference's pytree layout —
``{"embed": {...}, "blocks": {...}, "final_norm": ...}`` with every
``blocks`` leaf stacked on a leading layer dim — so weights cross between
the packages without transposes (``repro_torch.weights``). The reference's
``scan_layers`` over that dim is a Python loop here. Methods take the
params explicitly, as in the reference, so the pods of a decentralized
deployment share one ``Model``. Everything runs on the device of the
params and caches it is given.

Ported: ``cache_spec`` (with ``CacheSpec.insert``/``insert_paged``),
``init_cache``, ``init_paged_cache``, the monolithic ``prefill``,
``embed_prompt``, ``init_chunk_carry``, ``prefill_chunk``, ``decode_step``,
``decode_step_paged`` and ``fused_decode_step`` over either cache, and
the speculative span verify over the paged cache
(``speculative_capable``, ``verify_step_paged``, ``fused_verify_step``).
The other families and ``forward`` (training) are not ported yet (see
ROADMAP.md).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

import torch
import torch.nn.functional as F

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
    leaf, plus the paged layout when the cache pages through a pool. The
    splices write the batched cache IN PLACE (the reference returns a new
    one) and return it; like the reference they write the whole padded
    row, so cache contents compare equal between the two."""
    batch_axes: Any
    paged: PagedLayout = None

    def insert(self, cache, row_cache, slot: int):
        """Write a single-request cache (extent 1 on each leaf's batch
        axis) into ``cache`` at slot index ``slot``."""
        for name, ax in self.batch_axes.items():
            full = cache[name]
            full.narrow(ax, slot, 1).copy_(row_cache[name].to(full.dtype))
        return cache

    def insert_paged(self, cache, row_cache, slot: int, blocks: Tensor):
        """Splice a single-request contiguous prefill cache into the paged
        cache: each pool leaf takes the row's first ``len(blocks) *
        block_size`` positions (zero-padded when the row is shorter) into
        the physical blocks listed in ``blocks`` ((nb,) int). Every leaf of
        the dense family pages, so ``slot`` (kept for the reference's
        signature) addresses nothing here."""
        bs, nb = self.paged.block_size, blocks.shape[0]
        idx = blocks.long()
        for name, ax in self.batch_axes.items():
            full = cache[name]
            row = row_cache[name].squeeze(ax)          # seq now at ax
            take = min(nb * bs, row.shape[ax])
            row = row.narrow(ax, 0, take)
            if take < nb * bs:                         # cache_len ∤ block
                pad = [0, 0] * (row.dim() - ax - 1) + [0, nb * bs - take]
                row = F.pad(row, pad)
            row = row.reshape(row.shape[:ax] + (nb, bs) + row.shape[ax + 1:])
            full[(slice(None),) * ax + (idx,)] = row.to(full.dtype)
        return cache


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

    @property
    def speculative_capable(self) -> bool:
        """True when a multi-token verify span can be rolled back by
        position: rejected-tail K/V writes sit at positions the causal
        fence hides, and the next span overwrites them. A sliding-window
        (ring) cache would overwrite live slots when the span wraps, so
        windowed configs degrade to the vanilla one-token step (the
        scheduler consults this flag)."""
        return self.cfg.sliding_window <= 0

    # ------------------------------------------------------------------
    # Decode cache
    # ------------------------------------------------------------------

    def cache_spec(self, block_size: int = 0) -> CacheSpec:
        paged = PagedLayout(block_size, {"k": 2, "v": 2}) \
            if block_size > 0 else None
        return CacheSpec({"k": 1, "v": 1}, paged)

    def init_cache(self, batch: int, cache_len: int,
                   device="cuda") -> Dict[str, Tensor]:
        """Zeroed contiguous (L, batch, S_kv, KV, dh) K and V caches in the
        compute dtype; S_kv = min(cache_len, window) for a sliding window
        (a ring of slot = pos % S_kv), else cache_len."""
        cfg = self.cfg
        win = cfg.sliding_window
        S_kv = min(cache_len, win) if win > 0 else cache_len
        shape = (self.n_groups, batch, S_kv, cfg.n_kv_heads, cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=cfg.cdtype, device=device),
                "v": torch.zeros(shape, dtype=cfg.cdtype, device=device)}

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
    # Prefill: the whole prompt in one forward
    # ------------------------------------------------------------------

    def prefill(self, params, batch, cache_len: int):
        """Returns (logits (B,S,V) float32, cache) with the cache leaves
        (L, B, S_kv, KV, dh): the prompt's K/V right-padded to S_kv, or,
        windowed, its last S_kv positions in the ring layout (slot =
        pos % S_kv)."""
        cfg = self.cfg
        x = embed(params["embed"], batch["tokens"], cfg.cdtype)
        S = x.shape[1]
        win = cfg.sliding_window
        S_kv = min(cache_len, win) if win > 0 else cache_len

        def pad_kv(k):
            """(B,S,KV,dh) → ring/right-padded (B,S_kv,KV,dh)."""
            if win > 0 and S >= S_kv:
                return torch.roll(k[:, S - S_kv:], (S - S_kv) % S_kv, dims=1)
            return F.pad(k, (0, 0, 0, 0, 0, S_kv - S))

        ks, vs = [], []
        blocks = params["blocks"]
        for i in range(self.n_groups):
            layer = layer_slice(blocks, i)
            a, (k, v) = attn.prefill_attention(
                layer["attn"], rms_norm(x, layer["ln1"], cfg.norm_eps), cfg,
                S)
            h = x + a
            x = h + swiglu(layer["ffn"], rms_norm(h, layer["ln2"],
                                                  cfg.norm_eps))
            ks.append(pad_kv(k))
            vs.append(pad_kv(v))
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        logits = unembed(params["embed"], x, cfg.tie_embeddings, cfg.vocab)
        return logits, {"k": torch.stack(ks), "v": torch.stack(vs)}

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

    def decode_step(self, params, cache, tokens: Tensor, pos: Tensor):
        """One token per slot against the contiguous cache (written in
        place). tokens: (B,) int32; pos: (B,) (or ()) int32. Returns
        (logits (B, V), cache)."""
        cfg = self.cfg
        x = embed(params["embed"], tokens[:, None], cfg.cdtype)   # (B,1,D)
        blocks = params["blocks"]
        for i in range(self.n_groups):
            layer = layer_slice(blocks, i)
            a, _ = attn.decode_attention(
                layer["attn"], rms_norm(x, layer["ln1"], cfg.norm_eps), cfg,
                (cache["k"][i], cache["v"][i]), pos)
            h = x + a
            x = h + swiglu(layer["ffn"], rms_norm(h, layer["ln2"],
                                                  cfg.norm_eps))
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        logits = unembed(params["embed"], x, cfg.tie_embeddings, cfg.vocab)
        return logits[:, 0], cache

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

    def verify_step_paged(self, params, cache, tokens: Tensor, pos: Tensor,
                          block_tables: Tensor):
        """Speculative span verify against the paged cache: score L
        candidate positions per slot in one forward. tokens: (B, L) int32,
        column 0 each slot's committed next token, columns 1..L-1 its
        drafts; pos: (B,) int32, where column 0 writes; block_tables:
        (B, NB) int32. Returns (logits (B, L, V), cache): logits row j is
        what ``decode_step_paged`` at position pos + j would give had
        drafts 0..j-1 been committed."""
        cfg = self.cfg
        if not self.speculative_capable:
            raise ValueError(
                f"family '{cfg.family}' (window={cfg.sliding_window}) "
                "cannot verify speculative spans — check "
                "speculative_capable before dispatching")
        x = embed(params["embed"], tokens, cfg.cdtype)            # (B,L,D)
        blocks = params["blocks"]
        for i in range(self.n_groups):
            layer = layer_slice(blocks, i)
            a, _ = attn.paged_verify_attention(
                layer["attn"], rms_norm(x, layer["ln1"], cfg.norm_eps), cfg,
                (cache["k"][i], cache["v"][i]), pos, block_tables)
            h = x + a
            x = h + swiglu(layer["ffn"], rms_norm(h, layer["ln2"],
                                                  cfg.norm_eps))
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        logits = unembed(params["embed"], x, cfg.tie_embeddings, cfg.vocab)
        return logits, cache

    def fused_verify_step(self, params, cache, state, drafts: Tensor, *,
                          cache_len: int):
        """One whole speculative step: the span verify forward over
        ``[committed token, drafts]`` followed by the greedy accept/reject
        epilogue (per-offset stop, budget and context checks, the
        variable-length position advance). drafts: (B, L-1) int32.
        Returns (cache, new_state, toks, n_emit, done)."""
        from repro_torch.serve.fused import verify_epilogue
        tokens = torch.cat([state["tok"][:, None], drafts], dim=1)
        scores, cache = self.verify_step_paged(
            params, cache, tokens, state["pos"], state["tables"])
        state, toks, n_emit, done = verify_epilogue(
            scores, drafts, state, cache_len=cache_len)
        return cache, state, toks, n_emit, done

    def fused_decode_step(self, params, cache, state, *, cache_len: int,
                          paged: bool = False):
        """One whole decode token: the forward (contiguous, or paged through
        ``state["tables"]``) followed by the serving epilogue (greedy pick,
        stop ids, budget and context bound, position advance). Returns
        (cache, new_state, next_tok, done)."""
        from repro_torch.serve.fused import decode_epilogue
        if paged:
            scores, cache = self.decode_step_paged(
                params, cache, state["tok"], state["pos"], state["tables"])
        else:
            scores, cache = self.decode_step(params, cache, state["tok"],
                                             state["pos"])
        state, nxt, done = decode_epilogue(scores, state, cache_len=cache_len)
        return cache, state, nxt, done


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
