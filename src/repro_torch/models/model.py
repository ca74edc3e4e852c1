"""Model assembly, every family (dense, vlm, moe, hybrid, ssm, audio),
serving paths (port of ``repro.models.model``).

Parameters are nested dicts of tensors in the reference's pytree layout —
``{"embed": {...}, "blocks": {...}, "final_norm": ...}`` with every
``blocks`` leaf stacked on a leading layer dim (the hybrid family's
Mamba2 leaves and the ssm family's mLSTM leaves on (G, gm, ...), plus the
hybrid family's plain ``shared_attn`` dict, and the audio family's
``encoder`` with its own stacked ``blocks``) — so
weights cross between the packages without transposes
(``repro_torch.weights``). The reference's ``scan_layers`` over that dim
is a Python loop here. Methods take the params explicitly, as in the
reference, so the pods of a decentralized deployment share one ``Model``.
Everything runs on the device of the params and caches it is given.

Ported: ``cache_spec`` (with ``CacheSpec.insert``/``insert_paged``/
``insert_direct`` and the preemption park's ``swap_out``/``swap_in``),
``init_cache``, ``init_paged_cache``, the monolithic
``prefill``, ``embed_prompt``, ``init_chunk_carry``, ``prefill_chunk``,
``decode_step``, ``decode_step_paged`` and ``fused_decode_step`` over
either cache, for the dense, vlm (the dense decoder behind an image-patch
prefix, ``_embed_inputs``), moe (DeepSeek-MoE, Qwen3-MoE: the dense
decoder with ``models.moe.moe_ffn`` for its FFN, each row of every site a
routing group of that site's width, so capacity drops fall where the
reference's do), hybrid (Zamba2: Mamba2 groups + one shared attention
block), ssm (xLSTM: groups of gm mLSTM layers and one sLSTM layer; its
cache holds recurrent state only, so it has no pageable leaves and the
paged paths take the direct one) and audio (Whisper: a non-causal encoder
over precomputed frame embeddings, ``_encode_audio``, and a decoder whose
blocks add cross-attention to the encoder's K/V; those per-layer K/V,
``xk``/``xv``, are direct per-slot cache leaves, computed once a request)
families; the speculative span verify over the paged cache for the dense,
vlm, moe and audio families (``speculative_capable``,
``verify_step_paged``, ``fused_verify_step``), also over an expert stack;
the teacher-forced ``forward`` and ``loss`` with their gradient for the
dense, vlm, moe and audio families (the hybrid and ssm families' forward
without it).

The serving paths (``prefill``, ``embed_prompt``, ``init_chunk_carry``,
``prefill_chunk``, ``decode_step``, ``decode_step_paged``,
``verify_step_paged``) also take a
stack of K experts' parameters (``core.ensemble.stack_experts_for_decode``:
``blocks`` and ``encoder/blocks`` leaves (L, K, ...), every other leaf
(K, ...)) with caches that
carry K at axis 1 of every leaf (``init_cache``/``init_paged_cache`` with
``experts=K``, ``CacheSpec.shifted(1)``), as the reference's ``jax.vmap``
over the expert dim does: the same body runs once with K folded into the
batch of every activation and kernel launch, rows expert-major. The paged
pool (L, K, P, block, KV, dh) is viewed as (L, K·P, ...), and expert k's
copy of each block table is offset by k·P, so the K experts of a slot
share one logical table; tokens and positions are shared too. Logits come
back with a leading K dim.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.tree import flat_leaves, tree_leaves, tree_map

from . import attention as attn
from . import moe as moe_lib
from . import ssm as ssm_lib
from .layers import (cross_entropy_loss, embed, embedding_specs, linear,
                     rms_norm, swiglu, swiglu_specs, unembed)
from .params import ParamSpec, init_params, is_spec

Tensor = torch.Tensor


def stack_specs(tree, n: int):
    """Prepend a stacked layer dim to every ParamSpec in the tree."""
    if is_spec(tree):
        return ParamSpec((n,) + tree.shape, ("layer",) + tree.logical,
                         tree.init, tree.scale)
    return {k: stack_specs(v, n) for k, v in tree.items()}


def layer_slice(tree, i: int, axis: int = 0):
    """Layer ``i`` (along ``axis``) of a stacked parameter tree (views, no
    copies)."""
    if isinstance(tree, dict):
        return {k: layer_slice(v, i, axis) for k, v in tree.items()}
    return tree.select(axis, i)


def n_stacked(params) -> int:
    """K for a stack of K experts' parameters, 0 for one model's: read from
    ``final_norm``, whose rank is 1 in every family's one model (a weight's
    rank does not tell: the moe family's routed weights are 3-D)."""
    norm = params["final_norm"]
    return norm.shape[0] if norm.dim() == 2 else 0


def _kv(leaf: Tensor, i: int, K: int) -> Tensor:
    """Attention layer ``i`` of a K/V cache or pool leaf; an expert stack's
    (K, B or P, ...) viewed as (K·B or K·P, ...)."""
    return leaf[i].flatten(0, 1) if K else leaf[i]


def _unfold(t: Tensor, K: int, axis: int) -> Tensor:
    """K·B rows at ``axis`` back to (K, B) there (no-op for one model)."""
    return t.unflatten(axis, (K, -1)) if K else t


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
    leaf, plus the paged layout when the cache pages through a pool (pool
    leaves have a sequence axis >= 0, direct per-slot leaves −1). The
    splices write the batched cache IN PLACE (the reference returns a new
    one) and return it; like the reference they write the whole padded
    row, so cache contents compare equal between the two."""
    batch_axes: Any
    paged: PagedLayout = None

    @staticmethod
    def _write_row(full: Tensor, row: Tensor, ax: int, slot: int) -> None:
        """``full``'s extent-1 slice at ``slot`` on axis ``ax`` takes
        ``row``, written at offset 0 of every other axis — the reference's
        ``dynamic_update_slice``, which also takes a row shorter than the
        slot (a prompt shorter than the conv window leaves a shorter conv
        carry)."""
        dst = full.narrow(ax, slot, 1)
        dst[tuple(slice(0, n) for n in row.shape)] = row.to(full.dtype)

    def _direct(self, name: str) -> bool:
        """True when leaf ``name`` stays per slot (no paged layout, or a
        seq axis of −1 on every one of its leaves)."""
        return self.paged is None or all(
            a < 0 for a in flat_leaves(self.paged.seq_axes[name]))

    def _write_rows(self, name: str, full, row, slot: int) -> None:
        """``_write_row`` over every leaf of entry ``name`` (the ssm
        family's sLSTM state is a tuple of four)."""
        for f, r, ax in zip(flat_leaves(full), flat_leaves(row),
                            flat_leaves(self.batch_axes[name])):
            self._write_row(f, r, ax, slot)

    def insert(self, cache, row_cache, slot: int):
        """Write a single-request cache (extent 1 on each leaf's batch
        axis) into ``cache`` at slot index ``slot``."""
        for name in self.batch_axes:
            self._write_rows(name, cache[name], row_cache[name], slot)
        return cache

    def insert_paged(self, cache, row_cache, slot: int, blocks: Tensor):
        """Splice a single-request contiguous prefill cache into the paged
        cache: each pool leaf takes the row's first ``len(blocks) *
        block_size`` positions (zero-padded when the row is shorter) into
        the physical blocks listed in ``blocks`` ((nb,) int); direct leaves
        behave exactly like ``insert`` at ``slot``."""
        bs, nb = self.paged.block_size, blocks.shape[0]
        idx = blocks.long()
        for name, ax in self.batch_axes.items():
            full = cache[name]
            if self._direct(name):
                self._write_rows(name, full, row_cache[name], slot)
                continue
            row = row_cache[name].squeeze(ax)          # seq now at ax
            take = min(nb * bs, row.shape[ax])
            row = row.narrow(ax, 0, take)
            if take < nb * bs:                         # cache_len ∤ block
                pad = [0, 0] * (row.dim() - ax - 1) + [0, nb * bs - take]
                row = F.pad(row, pad)
            row = row.reshape(row.shape[:ax] + (nb, bs) + row.shape[ax + 1:])
            full[(slice(None),) * ax + (idx,)] = row.to(full.dtype)
        return cache

    def shifted(self, n: int) -> "CacheSpec":
        """The layout with ``n`` more leading dims on every leaf (an expert
        stack's K at axis 1): batch and sequence axes move by ``n``."""
        paged = None if self.paged is None else PagedLayout(
            self.paged.block_size,
            tree_map(lambda a: a + n if a >= 0 else a, self.paged.seq_axes))
        return CacheSpec(tree_map(lambda a: a + n, self.batch_axes), paged)

    def insert_direct(self, cache, carry, slot: int):
        """Write a chunked-prefill carry (single-request direct-leaf decode
        states; its pool-leaf entries are placeholders, their data went
        into the pool chunk by chunk) into the batched cache at ``slot``.
        Without a paged layout every leaf is direct."""
        for name in self.batch_axes:
            if self._direct(name):
                self._write_rows(name, cache[name], carry[name], slot)
        return cache

    def swap_out(self, cache, slot: int, blocks) -> Dict[str, Tensor]:
        """Read one slot's paged decode state out for parking (preemption
        by swap): pool leaves gather the listed physical blocks on their
        block axis (an expert stack's, through ``shifted(1)``, for all K
        segments at once), direct leaves take the slot's row, extent 1
        kept. The payload is on the cache's device; the caller moves it to
        host memory (its one readback). It mirrors the cache dict and
        round-trips through ``swap_in``."""
        idx = torch.as_tensor(list(blocks), dtype=torch.long,
                              device=next(iter(cache.values())).device)
        out = {}
        for name, ax in self.batch_axes.items():
            full = cache[name]
            if self.paged.seq_axes[name] < 0:
                out[name] = full.narrow(ax, slot, 1).clone()
            else:
                out[name] = full.index_select(ax, idx)
        return out

    def swap_in(self, cache, payload, slot: int, blocks):
        """Scatter a ``swap_out`` payload back IN PLACE: pool-leaf contents
        land in the physical blocks listed in ``blocks``, in the payload's
        gather order, and direct leaves overwrite ``slot``'s row. Neither
        need match the ones swapped out; the caller rebuilds the block
        table."""
        for name, ax in self.batch_axes.items():
            full = cache[name]
            row = payload[name].to(device=full.device, dtype=full.dtype)
            if self.paged.seq_axes[name] < 0:
                full.narrow(ax, slot, 1).copy_(row)
            else:
                idx = torch.as_tensor(list(blocks), dtype=torch.long,
                                      device=full.device)
                full.index_copy_(ax, idx, row)
        return cache


class Model:
    def __init__(self, cfg: ModelConfig):
        if cfg.family not in ("dense", "vlm", "moe", "hybrid", "ssm",
                              "audio"):
            raise ValueError(f"unknown model family {cfg.family!r}")
        self.cfg = cfg
        self.audio = cfg.family == "audio"
        self.hybrid = cfg.family == "hybrid"
        self.ssm = cfg.family == "ssm"
        self.vlm = cfg.family == "vlm"
        self.moe = cfg.family == "moe"

    # ------------------------------------------------------------------
    # Parameters
    # ------------------------------------------------------------------

    @property
    def group_m(self) -> int:
        """Recurrent layers per group: Mamba2 layers, each group followed
        by the shared attention block (hybrid), or mLSTM layers, each
        group followed by one sLSTM layer (ssm); 1 for the other
        families."""
        if self.hybrid:
            return self.cfg.ssm.shared_attn_every or self.cfg.n_layers
        if self.ssm:
            k = self.cfg.ssm.slstm_every or self.cfg.n_layers
            return max(k - 1, 1)
        return 1

    @property
    def n_groups(self) -> int:
        if self.ssm:
            return self.cfg.n_layers // (self.group_m + 1)
        return self.cfg.n_layers // self.group_m

    @property
    def _recur_names(self) -> tuple:
        """The per-slot state leaves of a group's recurrent layers."""
        return ("mlstm",) if self.ssm else ("ssm", "conv")

    def _block_specs(self) -> Dict[str, Any]:
        cfg = self.cfg
        D = cfg.d_model
        if self.hybrid:                # Zamba2 group: gm Mamba2 layers
            gm = self.group_m
            return {"m_ln": stack_specs(_norm_spec(D), gm),
                    "mamba": stack_specs(ssm_lib.mamba2_specs(cfg), gm)}
        if self.ssm:                   # xLSTM group: gm mLSTM + 1 sLSTM
            gm = self.group_m
            return {"m_ln": stack_specs(_norm_spec(D), gm),
                    "mlstm": stack_specs(ssm_lib.mlstm_specs(cfg), gm),
                    "s_ln": _norm_spec(D),
                    "slstm": ssm_lib.slstm_specs(cfg)}
        if self.moe:
            return {"ln1": _norm_spec(D), "attn": attn.attention_specs(cfg),
                    "ln2": _norm_spec(D), "moe": moe_lib.moe_specs(cfg)}
        if self.audio:                 # decoder block
            return {"ln1": _norm_spec(D),
                    "self_attn": attn.attention_specs(cfg),
                    "ln2": _norm_spec(D),
                    "cross_attn": attn.attention_specs(cfg),
                    "ln3": _norm_spec(D), "ffn": swiglu_specs(D, cfg.d_ff)}
        return {"ln1": _norm_spec(D), "attn": attn.attention_specs(cfg),
                "ln2": _norm_spec(D), "ffn": swiglu_specs(D, cfg.d_ff)}

    def param_specs(self) -> Dict[str, Any]:
        cfg = self.cfg
        D = cfg.d_model
        specs = {
            "embed": embedding_specs(cfg.padded_vocab, D, cfg.tie_embeddings),
            "blocks": stack_specs(self._block_specs(), self.n_groups),
            "final_norm": _norm_spec(D),
        }
        if self.vlm:
            specs["projector"] = {
                "w1": ParamSpec((cfg.vision_dim, D), ("vision", "embed"),
                                "scaled"),
                "w2": ParamSpec((D, D), ("embed", None), "scaled"),
            }
        if self.audio:
            enc_block = {"ln1": _norm_spec(D),
                         "attn": attn.attention_specs(cfg),
                         "ln2": _norm_spec(D),
                         "ffn": swiglu_specs(D, cfg.d_ff)}
            specs["encoder"] = {
                "in_proj": ParamSpec((cfg.audio_dim, D), ("audio", "embed"),
                                     "scaled"),
                "blocks": stack_specs(enc_block, cfg.n_enc_layers),
                "norm": _norm_spec(D)}
        if self.hybrid:
            specs["shared_attn"] = {
                "ln1": _norm_spec(D), "attn": attn.attention_specs(cfg),
                "ln2": _norm_spec(D), "ffn": swiglu_specs(D, cfg.d_ff)}
        return specs

    def init(self, gen: torch.Generator, dtype=None):
        """Random parameters on ``gen.device`` (shape and scale parity with
        the reference's init; not its values)."""
        return init_params(gen, self.param_specs(), dtype or self.cfg.pdtype)

    @property
    def prefix_cacheable(self) -> bool:
        """True when a prompt's pool-resident K/V fully determines its
        decode state (the audio family's cross-attention K/V come from the
        request's frames, whatever its decoder positions, and the cache's
        key digests the frames). The recurrent families' (hybrid, ssm) state
        accumulates over every prompt position outside the pool, so a
        cached prefix cannot be spliced in."""
        return not (self.hybrid or self.ssm)

    @property
    def speculative_capable(self) -> bool:
        """True when a multi-token verify span can be rolled back by
        position: rejected-tail K/V writes sit at positions the causal
        fence hides, and the next span overwrites them. Recurrent state
        (hybrid) folds every fed token in and cannot be unwound, and a
        sliding-window (ring) cache would overwrite live slots when the
        span wraps: both degrade to the vanilla one-token step (the
        scheduler consults this flag)."""
        return not (self.hybrid or self.ssm) and self.cfg.sliding_window <= 0

    # ------------------------------------------------------------------
    # Decode cache
    # ------------------------------------------------------------------

    def cache_spec(self, block_size: int = 0) -> CacheSpec:
        """Slot axes of the cache leaves; with ``block_size > 0`` also the
        paged layout: attention K/V page through the pool, the recurrent
        states (the hybrid family's SSM and conv states, the ssm family's
        mLSTM memory and its tuple of four sLSTM leaves) stay per slot
        (seq axis −1), as do the audio family's cross-attention K/V (written
        once a request, fixed extent). The ssm family has no pageable
        leaf."""
        if self.audio:
            axes = {"k": 1, "v": 1, "xk": 1, "xv": 1}
            seq = {"k": 2, "v": 2, "xk": -1, "xv": -1}
        elif self.hybrid:
            axes = {"ssm": 2, "conv": 2, "k": 1, "v": 1}
            seq = {"ssm": -1, "conv": -1, "k": 2, "v": 2}
        elif self.ssm:
            axes = {"mlstm": 2, "slstm": (1, 1, 1, 1)}
            seq = {"mlstm": -1, "slstm": (-1, -1, -1, -1)}
        else:
            axes = {"k": 1, "v": 1}
            seq = {"k": 2, "v": 2}
        paged = PagedLayout(block_size, seq) if block_size > 0 else None
        return CacheSpec(axes, paged)

    def _direct_leaves(self, batch: int, device,
                       experts: int = 0) -> Dict[str, Tensor]:
        """Zeroed per-slot leaves: the hybrid family's SSM states (G, gm,
        batch, H, N, P) in float32 and conv windows (G, gm, batch, W−1, C)
        in the compute dtype; the ssm family's float32 mLSTM memories (G,
        gm, batch, H, dh, dh+1) and sLSTM (c, n, m, h), each (G, batch, Di);
        the audio family's cross-attention K/V (L, batch, n_audio_frames,
        KV, dh) in the compute dtype; (G, K, ...) for ``experts`` = K; none
        for the dense family."""
        lead_g = (self.n_groups, *((experts,) if experts else ()))
        lead = lead_g + (self.group_m,)
        if self.audio:
            cfg = self.cfg
            shape = lead_g + (batch, cfg.n_audio_frames, cfg.n_kv_heads,
                              cfg.head_dim)
            return {n: torch.zeros(shape, dtype=cfg.cdtype, device=device)
                    for n in ("xk", "xv")}
        if self.ssm:
            cfg = self.cfg
            f32 = dict(dtype=torch.float32, device=device)
            return {"mlstm": torch.zeros(
                        lead + ssm_lib.mlstm_state_shape(cfg, batch), **f32),
                    "slstm": tuple(torch.zeros(lead_g + s, **f32) for s in
                                   ssm_lib.slstm_state_shapes(cfg, batch))}
        if not self.hybrid:
            return {}
        ssm_s, conv_s = ssm_lib.mamba2_state_shapes(self.cfg, batch)
        return {"ssm": torch.zeros(lead + ssm_s, dtype=torch.float32,
                                   device=device),
                "conv": torch.zeros(lead + conv_s, dtype=self.cfg.cdtype,
                                    device=device)}

    def _kv_leaves(self, rows: tuple, experts: int, device):
        cfg = self.cfg
        shape = (self.n_groups, *((experts,) if experts else ()), *rows,
                 cfg.n_kv_heads, cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=cfg.cdtype, device=device),
                "v": torch.zeros(shape, dtype=cfg.cdtype, device=device)}

    def init_cache(self, batch: int, cache_len: int, device="cuda",
                   experts: int = 0) -> Dict[str, Tensor]:
        """Zeroed contiguous (L, batch, S_kv, KV, dh) K and V caches in the
        compute dtype (L = the attention layers: one per group for the
        hybrid family), beside any per-slot leaves; S_kv = min(cache_len,
        window) for a sliding window (a ring of slot = pos % S_kv), else
        cache_len. ``experts`` = K puts K at axis 1 of every leaf. The ssm
        family has its per-slot states only."""
        win = self.cfg.sliding_window
        S_kv = min(cache_len, win) if win > 0 else cache_len
        if self.ssm:
            return self._direct_leaves(batch, device, experts)
        return {**self._direct_leaves(batch, device, experts),
                **self._kv_leaves((batch, S_kv), experts, device)}

    def init_paged_cache(self, n_slots: int, n_blocks: int, block_size: int,
                         cache_len: int, device="cuda",
                         experts: int = 0) -> Dict[str, Tensor]:
        """Zeroed (L, n_blocks, block_size, KV, dh) K and V pools in the
        compute dtype; per-slot (direct) leaves keep their ``n_slots``
        rows. ``cache_len`` sizes nothing the ported families have.
        ``experts`` = K puts K at axis 1 of every leaf. The ssm family
        has no pool leaf: its paged cache is its contiguous one."""
        if self.ssm:
            return self._direct_leaves(n_slots, device, experts)
        return {**self._direct_leaves(n_slots, device, experts),
                **self._kv_leaves((n_blocks, block_size), experts, device)}

    # ------------------------------------------------------------------
    # The layer stack
    # ------------------------------------------------------------------

    def _stack(self, params, x: Tensor, attend, recur=None, slstm=None, *,
               cross=None, remat: bool = False) -> Tensor:
        """Run the layer stack on x and return the final-normed rows.
        ``attend(i, attn_params, h)`` is the attention of layer (or, for
        the hybrid family, group) i on its normed input h (the audio
        family's self-attention; ``cross(i, attn_params, h)`` its
        cross-attention to the encoder),
        ``recur(g, m, params, h)`` recurrent layer m of group g (Mamba2,
        or the ssm family's mLSTM) and ``slstm(g, params, h)`` the ssm
        family's sLSTM layer closing group g; each reads and writes its
        own cache or carry. ``remat``: each layer
        (group) runs under non-reentrant ``torch.utils.checkpoint``, so
        the backward recomputes its activations instead of keeping
        them. The moe family's FFN routes each row of x as one group of
        x's width, the site's: each caller's rows are what the reference
        hands ``moe_ffn`` at the same site, padding included."""
        cfg = self.cfg
        eps = cfg.norm_eps
        shared = params.get("shared_attn")
        K = n_stacked(params)
        m_axis = 1 if K else 0                   # a group's Mamba2 layers

        def block(i, layer, x):
            if self.hybrid or self.ssm:
                cores = layer["mlstm" if self.ssm else "mamba"]
                for m in range(self.group_m):
                    x = x + recur(i, m, layer_slice(cores, m, m_axis),
                                  rms_norm(x, layer["m_ln"].select(m_axis, m),
                                           eps))
                if self.ssm:
                    return x + slstm(i, layer["slstm"],
                                     rms_norm(x, layer["s_ln"], eps))
                layer = shared
            if self.audio:
                h = x + attend(i, layer["self_attn"],
                               rms_norm(x, layer["ln1"], eps))
                h = h + cross(i, layer["cross_attn"],
                              rms_norm(h, layer["ln2"], eps))
                return h + swiglu(layer["ffn"], rms_norm(h, layer["ln3"], eps))
            h = x + attend(i, layer["attn"], rms_norm(x, layer["ln1"], eps))
            y = rms_norm(h, layer["ln2"], eps)
            if self.moe:
                return h + moe_lib.moe_ffn(layer["moe"], y, cfg, K)
            return h + swiglu(layer["ffn"], y)

        for i in range(self.n_groups):
            layer = layer_slice(params["blocks"], i)
            x = checkpoint(block, i, layer, x, use_reentrant=False) if remat \
                else block(i, layer, x)
        return rms_norm(x, params["final_norm"], eps)

    def _recur_in_place(self, states, K: int, step, slstm_step=None):
        """``(recur, slstm)`` of ``_stack`` over the per-row states of
        ``states`` (a decode cache or a chunk carry): ``step(p, h, st)`` →
        (y, new st) for recurrent layer (g, m), st being the hybrid
        family's (ssm, conv) pair or the ssm family's mLSTM memory, and
        ``slstm_step(p, h, (c, n, m, h))`` → (y, new state) for group g's
        sLSTM; each layer's states advance in place. An expert stack's
        states (G, K, [gm,] B, ...) step as K·B rows."""
        names = self._recur_names

        def advance(rows, fn):
            y, new = fn(tuple(r.flatten(0, 1) if K else r for r in rows))
            for r, t in zip(rows, new if isinstance(new, tuple) else (new,)):
                r.copy_(t.reshape(r.shape))
            return y

        def recur(g, m, p, h):
            rows = [states[n][g, :, m] if K else states[n][g, m]
                    for n in names]
            return advance(rows, lambda st: step(
                p, h, st if len(st) > 1 else st[0]))

        def slstm(g, p, h):
            return advance([s[g] for s in states["slstm"]],
                           lambda st: slstm_step(p, h, st))
        return recur, slstm

    def _step_recur(self, cache, K: int = 0):
        """``(recur, slstm)`` of ``_stack`` for one decode token: each slot
        row's recurrent state advances in place."""
        cfg = self.cfg
        if self.ssm:
            return self._recur_in_place(
                cache, K, lambda p, h, st: ssm_lib.mlstm_step(p, h, cfg, st),
                lambda p, h, st: ssm_lib.slstm_scan(p, h, cfg, state=st))
        return self._recur_in_place(
            cache, K, lambda p, h, st: ssm_lib.mamba2_step(p, h, cfg, st))

    # ------------------------------------------------------------------
    # Input embedding
    # ------------------------------------------------------------------

    def _embed_inputs(self, params, batch) -> Tensor:
        """The decoder's input rows (B, W, D): the token embeddings, behind
        the projected image patches for the vlm family — ``gelu(patches @
        w1) @ w2`` (tanh gelu, ``jax.nn.gelu``'s default), ``n_patches``
        rows of prefix. An expert stack embeds the same batch with each
        expert's tables, (K·B, W, D) expert-major: the patches are repeated
        K times, expert-major, so each expert's projector sees all of them
        (``linear`` over a stack splits its rows K ways, it does not
        broadcast them)."""
        cfg = self.cfg
        x = embed(params["embed"], batch["tokens"], cfg.cdtype)
        if not self.vlm:
            return x
        if "patches" not in batch:
            raise ValueError(
                f"family 'vlm' ({cfg.arch_id}) prefills an image prefix: "
                f"the batch has no 'patches' — submit each request with "
                f"extras={{'patches': ({cfg.n_patches}, {cfg.vision_dim}) "
                f"array}}")
        p = params["projector"]
        patches = batch["patches"].to(cfg.cdtype)             # (B, Np, Dv)
        K = n_stacked(params)
        if K:
            patches = patches.repeat(K, 1, 1)
        proj = F.gelu(linear(patches, p["w1"]), approximate="tanh")
        return torch.cat([linear(proj, p["w2"]), x], dim=1)

    def _encode_audio(self, params, batch, *, remat: bool = False) -> Tensor:
        """The audio family's encoder over ``batch["frames"]`` (B, F, Da):
        ``frames @ in_proj``, then ``n_enc_layers`` blocks of non-causal
        self-attention (``full_attention(causal=False)``: the flash kernel
        on the card) and SwiGLU, then the encoder norm → (B, F, D). An
        expert stack encodes the frames repeated K times, expert-major,
        (K·B, F, D). ``remat`` recomputes each block in the backward, as
        ``_stack`` does."""
        cfg = self.cfg
        if "frames" not in batch:
            raise ValueError(
                f"family 'audio' ({cfg.arch_id}) encodes audio frames: the "
                f"batch has no 'frames' — submit each request with "
                f"extras={{'frames': ({cfg.n_audio_frames}, "
                f"{cfg.audio_dim}) array}}")
        eps = cfg.norm_eps
        enc = params["encoder"]
        frames = batch["frames"].to(cfg.cdtype)
        K = n_stacked(params)
        if K:
            frames = frames.repeat(K, 1, 1)
        x = linear(frames, enc["in_proj"])

        def block(layer, x):
            x = x + attn.full_attention(layer["attn"],
                                        rms_norm(x, layer["ln1"], eps), cfg,
                                        causal=False)
            return x + swiglu(layer["ffn"], rms_norm(x, layer["ln2"], eps))

        for i in range(cfg.n_enc_layers):
            layer = layer_slice(enc["blocks"], i)
            x = checkpoint(block, layer, x, use_reentrant=False) if remat \
                else block(layer, x)
        return rms_norm(x, enc["norm"], eps)

    def _cross_kv(self, params, enc_out: Tensor) -> Dict[str, Tensor]:
        """Every decoder layer's cross-attention K/V of ``enc_out``: the
        cache leaves ``xk``, ``xv`` (L, B, F, KV, dh), (L, K, B, ...) for an
        expert stack."""
        K = n_stacked(params)
        kvs = [attn.encode_kv(layer_slice(params["blocks"], i)["cross_attn"],
                              enc_out, self.cfg)
               for i in range(self.n_groups)]
        return {"xk": _unfold(torch.stack([k for k, _ in kvs]), K, 1),
                "xv": _unfold(torch.stack([v for _, v in kvs]), K, 1)}

    def _cross_from(self, leaves, K: int):
        """``cross`` of ``_stack`` over the ``xk``/``xv`` leaves of a cache
        or chunk carry (None for a family without an encoder)."""
        if not self.audio:
            return None
        cfg = self.cfg
        return lambda i, p, h: attn.cross_attention(
            p, h, (_kv(leaves["xk"], i, K), _kv(leaves["xv"], i, K)), cfg)

    # ------------------------------------------------------------------
    # Teacher-forced forward (training / eval)
    # ------------------------------------------------------------------

    def forward(self, params, batch) -> Tensor:
        """Teacher-forced logits (B, S, V) float32 of ``batch["tokens"]``
        (behind the image prefix for the vlm family: S = n_patches +
        tokens; the audio family's decoder cross-attends to the encoding of
        ``batch["frames"]``, and the gradient flows through both).

        Attention always goes through the kernel seam (``kernels.ops``):
        the CUDA kernels on the card, with the flash backward under
        autograd. While autograd records a graph of the params,
        ``cfg.remat="full"`` recomputes each layer in the backward
        (non-reentrant ``torch.utils.checkpoint`` per layer of the stacked
        ``blocks``) and ``"none"`` keeps every activation; ``"dots"`` and
        the hybrid and ssm families are refused then."""
        cfg = self.cfg
        training = torch.is_grad_enabled() and any(
            p.requires_grad for _, p in tree_leaves(params))
        if training and (self.hybrid or self.ssm):
            raise ValueError(f"training family {cfg.family!r} is not ported "
                             f"to repro_torch yet (see ROADMAP.md)")
        if training and cfg.remat not in ("full", "none"):
            raise ValueError(f"remat={cfg.remat!r} is not ported to "
                             f"repro_torch yet (see ROADMAP.md)")
        remat = training and cfg.remat == "full"
        cross = None
        if self.audio:
            enc_out = self._encode_audio(params, batch, remat=remat)

            def cross(i, p, h):
                return attn.cross_attention(
                    p, h, attn.encode_kv(p, enc_out, cfg), cfg)
        block = ssm_lib.mlstm_block if self.ssm else ssm_lib.mamba2_block
        x = self._stack(
            params, self._embed_inputs(params, batch),
            lambda i, p, h: attn.full_attention(p, h, cfg),
            lambda g, m, p, h: block(p, h, cfg),
            lambda g, p, h: ssm_lib.slstm_scan(p, h, cfg)[0],
            cross=cross, remat=remat)
        return unembed(params["embed"], x, cfg.tie_embeddings, cfg.vocab)

    def loss(self, params, batch):
        """(mean next-token NLL, {"loss": it}): logits of positions
        0..S-2 against labels 1..S-1, over ``batch["loss_mask"]`` when
        given. The vlm family's image prefix carries no loss."""
        logits = self.forward(params, batch)
        if self.vlm:
            logits = logits[:, self.cfg.n_patches:]
        mask = batch.get("loss_mask")
        nll = cross_entropy_loss(logits[:, :-1], batch["labels"][:, 1:],
                                 None if mask is None else mask[:, 1:])
        return nll, {"loss": nll}

    # ------------------------------------------------------------------
    # Prefill: the whole prompt in one forward
    # ------------------------------------------------------------------

    def prefill(self, params, batch, cache_len: int):
        """Returns (logits (B,S,V) float32 over the prompt's S positions,
        the vlm family's image prefix first, and the cache) with the K/V
        leaves (L, B, S_kv, KV, dh): the prompt's K/V right-padded to
        S_kv, or, windowed, its last S_kv positions in the ring layout
        (slot = pos % S_kv); the hybrid family adds each Mamba2 layer's
        SSM state and conv window after the prompt; the ssm family's cache
        is its mLSTM memories and sLSTM states after the prompt; the audio
        family adds every layer's cross-attention K/V of the request's
        frames, ``xk``/``xv`` (L, B, F, KV, dh). An expert
        stack gives logits (K,B,S,V) and K at axis 1 of every cache
        leaf."""
        cfg = self.cfg
        K = n_stacked(params)
        x = self._embed_inputs(params, batch)
        S = x.shape[1]
        win = cfg.sliding_window
        S_kv = min(cache_len, win) if win > 0 else cache_len

        def pad_kv(k):
            """(B,S,KV,dh) → ring/right-padded (B,S_kv,KV,dh)."""
            if win > 0 and S >= S_kv:
                return torch.roll(k[:, S - S_kv:], (S - S_kv) % S_kv, dims=1)
            return F.pad(k, (0, 0, 0, 0, 0, S_kv - S))

        ks, vs, states, s_states = [], [], [], []
        prefill_recur = ssm_lib.mlstm_prefill if self.ssm \
            else ssm_lib.mamba2_prefill

        def attend(i, p, h):
            a, (k, v) = attn.prefill_attention(p, h, cfg, S)
            ks.append(pad_kv(k))
            vs.append(pad_kv(v))
            return a

        def recur(g, m, p, h):
            y, st = prefill_recur(p, h, cfg)
            states.append(st if isinstance(st, tuple) else (st,))
            return y

        def slstm(g, p, h):
            y, st = ssm_lib.slstm_scan(p, h, cfg)
            s_states.append(st)
            return y

        xkv = self._cross_kv(params, self._encode_audio(params, batch)) \
            if self.audio else {}
        x = self._stack(params, x, attend, recur, slstm,
                        cross=self._cross_from(xkv, K))
        logits = unembed(params["embed"], x, cfg.tie_embeddings, cfg.vocab)
        cache = {}
        if states:
            lead = (self.n_groups, self.group_m)
            for j, name in enumerate(self._recur_names):
                t = torch.stack([st[j] for st in states])
                t = _unfold(t.reshape(lead + t.shape[1:]), K, 2)
                cache[name] = t.movedim(2, 1) if K else t
        if self.ssm:
            cache["slstm"] = tuple(
                _unfold(torch.stack([st[j] for st in s_states]), K, 1)
                for j in range(4))
            return _unfold(logits, K, 0), cache
        cache["k"] = _unfold(torch.stack(ks), K, 1)
        cache["v"] = _unfold(torch.stack(vs), K, 1)
        return _unfold(logits, K, 0), {**cache, **xkv}

    # ------------------------------------------------------------------
    # Chunked prefill
    # ------------------------------------------------------------------

    def embed_prompt(self, params, batch) -> Tensor:
        """Embedded prompt (1, W, D) for chunked prefill, behind any image
        prefix ((K, W, D) for an expert stack)."""
        return self._embed_inputs(params, batch)

    def init_chunk_carry(self, params, batch, cache_len: int):
        """Per-request carry between chunks: the direct (per-slot) decode
        leaves at batch extent 1 at their initial values — the hybrid
        family's SSM states and conv windows, zeroed, or the ssm family's
        mLSTM memories, zeroed, and sLSTM states with m at −1e30 (K at
        axis 1 for an expert stack). Attention K/V chunks write straight
        into the pool, so their entries are placeholders, as in the
        reference. The audio family's carry holds the request's
        cross-attention K/V: its encoder runs here, once a request, not once
        a chunk."""
        dev = params["final_norm"].device
        if self.audio:
            dummy = torch.zeros((1,), dtype=self.cfg.cdtype, device=dev)
            return {"k": dummy, "v": dummy,
                    **self._cross_kv(params,
                                     self._encode_audio(params, batch))}
        carry = self._direct_leaves(1, dev, n_stacked(params))
        if self.ssm:
            c, n, m, h = carry["slstm"]
            carry["slstm"] = (c, n, m.fill_(-1e30), h)
            return carry
        dummy = torch.zeros((1,), dtype=self.cfg.cdtype, device=dev)
        return {**carry, "k": dummy, "v": dummy}

    @staticmethod
    def _expert_tables(tables: Tensor, pool: Tensor, K: int) -> Tensor:
        """(B, NB) block tables for the attention kernels: one model's as
        they are; for an expert stack, whose pool leaf is (L, K, P, ...),
        expert k's copy offset by k·P into the (K·P, ...) view, (K·B, NB)
        expert-major (scratch entries land on expert k's block k·P)."""
        if not K:
            return tables
        off = torch.arange(K, dtype=tables.dtype, device=tables.device) \
            * pool.shape[2]
        return (tables[None] + off[:, None, None]).flatten(0, 1)

    def prefill_chunk(self, params, cache, carry, x: Tensor, start: int,
                      length: int, block_table: Tensor):
        """Consume one prompt chunk. x: (1,C,D) embedded rows at absolute
        positions start..start+C-1, ``length`` of them valid (host ints);
        block_table: (NB,) int32. Writes the chunk's K/V into the pool and
        advances the carry's recurrent state (both in place); padded rows
        are exact no-ops on both. Returns (last_logits (1, V) at the final
        valid row, carry, cache). An expert stack takes x (K,C,D), the
        request's one table shared by its K experts, and gives (K, 1, V)."""
        cfg = self.cfg
        K = n_stacked(params)
        tables = None if self.ssm else \
            self._expert_tables(block_table[None], cache["k"], K)

        def attend(i, p, h):
            a, _ = attn.chunk_attention(
                p, h, cfg, (_kv(cache["k"], i, K), _kv(cache["v"], i, K)),
                start, length, tables)
            return a

        if self.ssm:
            recur = self._recur_in_place(
                carry, K,
                lambda p, h, st: ssm_lib.mlstm_prefill(p, h, cfg, st, length),
                lambda p, h, st: ssm_lib.slstm_scan(p, h, cfg, state=st,
                                                    length=length))
        else:
            recur = self._recur_in_place(
                carry, K,
                lambda p, h, st: ssm_lib.mamba2_chunk(p, h, cfg, st, length))
        x = self._stack(params, x, attend, *recur,
                        cross=self._cross_from(carry, K))
        h_last = x[:, length - 1:length]
        logits = unembed(params["embed"], h_last, cfg.tie_embeddings,
                         cfg.vocab)
        return _unfold(logits[:, 0], K, 0), carry, cache

    # ------------------------------------------------------------------
    # Decode
    # ------------------------------------------------------------------

    def _decode(self, params, cache, tokens: Tensor, pos: Tensor, attend):
        """One token per slot through ``attend(i, p, h, k, v, pos)`` over
        attention layer i's cache or pool leaves: (logits (B, V), or
        (K, B, V) for an expert stack, cache)."""
        cfg = self.cfg
        K = n_stacked(params)
        if K:          # shared by the K experts of each slot
            pos = pos.expand(tokens.shape[0]).repeat(K)
        x = embed(params["embed"], tokens[:, None], cfg.cdtype)   # (B,1,D)
        x = self._stack(
            params, x,
            lambda i, p, h: attend(i, p, h, _kv(cache["k"], i, K),
                                   _kv(cache["v"], i, K), pos)[0],
            *self._step_recur(cache, K), cross=self._cross_from(cache, K))
        logits = unembed(params["embed"], x, cfg.tie_embeddings, cfg.vocab)
        return _unfold(logits[:, 0], K, 0), cache

    def decode_step(self, params, cache, tokens: Tensor, pos: Tensor):
        """One token per slot against the contiguous cache (written in
        place). tokens: (B,) int32; pos: (B,) (or ()) int32. Returns
        (logits (B, V), cache). Every slot row's recurrent state steps,
        idle ones included, as in the reference; admission overwrites it."""
        cfg = self.cfg
        return self._decode(
            params, cache, tokens, pos,
            lambda i, p, h, k, v, pos: attn.decode_attention(
                p, h, cfg, (k, v), pos))

    def decode_step_paged(self, params, cache, tokens: Tensor, pos: Tensor,
                          block_tables: Tensor):
        """One token per slot against the paged cache. tokens, pos: (B,)
        int32; block_tables: (B, NB) int32. Returns (logits (B, V), cache);
        the direct leaves step as in ``decode_step``. The ssm family has no
        pageable leaves and takes ``decode_step``."""
        cfg = self.cfg
        if self.ssm:
            return self.decode_step(params, cache, tokens, pos)
        tables = self._expert_tables(block_tables, cache["k"],
                                     n_stacked(params))
        return self._decode(
            params, cache, tokens, pos,
            lambda i, p, h, k, v, pos: attn.paged_decode_attention(
                p, h, cfg, (k, v), pos, tables))

    def verify_step_paged(self, params, cache, tokens: Tensor, pos: Tensor,
                          block_tables: Tensor):
        """Speculative span verify against the paged cache: score L
        candidate positions per slot in one forward. tokens: (B, L) int32,
        column 0 each slot's committed next token, columns 1..L-1 its
        drafts; pos: (B,) int32, where column 0 writes; block_tables:
        (B, NB) int32. Returns (logits (B, L, V), cache): logits row j is
        what ``decode_step_paged`` at position pos + j would give had
        drafts 0..j-1 been committed. An expert stack verifies its K·B
        rows in one launch a layer, as ``decode_step_paged`` does (tokens,
        positions and the logical tables shared by a slot's K experts),
        and gives (K, B, L, V). Span positions past the table horizon go
        to the absolute scratch block 0 of the (K·P) pool view, which is
        expert 0's scratch block, not expert k's block k·P: no fence ever
        admits a scratch position, so which scratch block takes the write
        does not matter."""
        cfg = self.cfg
        if not self.speculative_capable:
            raise ValueError(
                f"family '{cfg.family}' (window={cfg.sliding_window}) "
                "cannot verify speculative spans — check "
                "speculative_capable before dispatching")
        K = n_stacked(params)
        tables = self._expert_tables(block_tables, cache["k"], K)
        if K:
            pos = pos.repeat(K)
        x = embed(params["embed"], tokens, cfg.cdtype)          # (K·B,L,D)

        def attend(i, p, h):
            a, _ = attn.paged_verify_attention(
                p, h, cfg, (_kv(cache["k"], i, K), _kv(cache["v"], i, K)),
                pos, tables)
            return a

        x = self._stack(params, x, attend,
                        cross=self._cross_from(cache, K))
        logits = unembed(params["embed"], x, cfg.tie_embeddings, cfg.vocab)
        return _unfold(logits, K, 0), cache

    def fused_verify_step(self, params, cache, state, drafts: Tensor, *,
                          cache_len: int):
        """One whole speculative step: the span verify forward over
        ``[committed token, drafts]`` followed by the seeded accept/reject
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
        ``state["tables"]``) followed by the serving epilogue (the pick,
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
