"""Chunkwise linear attention and the Mamba2 (SSD) block (port of the
Mamba2 half of ``repro.models.ssm``; mLSTM and sLSTM arrive with the ssm
family, see ROADMAP.md).

The recurrence y_t = q_t · Σ_{s≤t} (Π_{r=s+1..t} g_r) k_s v_sᵀ runs in
chunks: the intra-chunk part goes through ``kernels.ops.chunk_scan`` (the
CUDA kernel on the card, its plain version on the CPU), the carry between
chunks is a loop over the chunks, as the reference's ``lax.scan``, and
decode is the O(1)-per-token state update. Casts follow the reference:
states and decays in float32, projections in the working dtype. The
Mamba2 functions also take a stack of K experts' parameters with K folded
into the batch of the activations and states (``layers``' expert-stack
convention).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops

from .layers import linear, per_expert, rms_norm
from .params import ParamSpec

Tensor = torch.Tensor


def chunked_linear_attention(q: Tensor, k: Tensor, v: Tensor, log_g: Tensor,
                             chunk: int, state: Optional[Tensor] = None
                             ) -> Tuple[Tensor, Tensor]:
    """q, k: (B,S,H,dk); v: (B,S,H,dv); log_g: (B,S,H) per-step log decay
    ≤ 0; state: (B,H,dk,dv) float32 carried in (zeros when None). Returns
    (y (B,S,H,dv) in v's dtype, final state (B,H,dk,dv) float32)."""
    B, S, H, dk = q.shape
    dv = v.shape[-1]
    pad = (-S) % chunk
    if pad:
        q, k, v = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (q, k, v))
        log_g = F.pad(log_g, (0, 0, 0, pad))
    NC = (S + pad) // chunk

    def cshape(a):
        return a.reshape(B, NC, chunk, *a.shape[2:]).contiguous()

    qc, kc, vc = cshape(q), cshape(k), cshape(v)
    cum = torch.cumsum(cshape(log_g).float(), dim=2)          # (B,NC,L,H)
    total = cum[:, :, -1]                                     # (B,NC,H)
    intra, chunk_kv = kops.chunk_scan(qc, kc, vc, cum)
    if state is None:
        state = torch.zeros((B, H, dk, dv), dtype=torch.float32,
                            device=q.device)
    inter = []
    for i in range(NC):
        # the carried state's contribution to every position of chunk i
        inter.append(torch.einsum(
            "blhd,bhdv->blhv",
            qc[:, i].float() * torch.exp(cum[:, i])[..., None], state))
        state = torch.exp(total[:, i])[:, :, None, None] * state \
            + chunk_kv[:, i]
    y = (intra + torch.stack(inter, dim=1)).reshape(B, NC * chunk, H, dv)
    return y[:, :S].to(v.dtype), state


def linear_attention_step(state: Tensor, q: Tensor, k: Tensor, v: Tensor,
                          g: Tensor) -> Tuple[Tensor, Tensor]:
    """O(1) decode update. state: (B,H,dk,dv) float32; q, k: (B,H,dk); v:
    (B,H,dv); g: (B,H) decay. Returns (y (B,H,dv) in v's dtype, new
    state); k·v is a product in the working dtype, promoted on the add."""
    state = g[..., None, None] * state + k[..., None] * v[..., None, :]
    y = torch.einsum("bhd,bhdv->bhv", q.float(), state)
    return y.to(v.dtype), state


def _d_inner(cfg) -> int:
    return cfg.ssm.expand * cfg.d_model


def mamba2_specs(cfg) -> Dict[str, ParamSpec]:
    D, Di, N, H = cfg.d_model, _d_inner(cfg), cfg.ssm.state, cfg.n_heads
    conv_ch = Di + 2 * N
    return {
        "w_in": ParamSpec((D, 2 * Di + 2 * N + H), ("embed", "inner"),
                          "scaled"),
        "conv_w": ParamSpec((cfg.ssm.conv, conv_ch), (None, "inner"),
                            "scaled"),
        "A_log": ParamSpec((H,), (None,), "zeros"),
        "D_skip": ParamSpec((H,), (None,), "ones"),
        "dt_bias": ParamSpec((H,), (None,), "zeros"),
        "norm": ParamSpec((Di,), (None,), "ones"),
        "w_out": ParamSpec((Di, D), ("inner", "embed"), "scaled"),
    }


def _causal_conv(x: Tensor, w: Tensor, carry: Optional[Tensor] = None):
    """Depthwise causal conv1d as the reference writes it: a sum of W
    shifted products, then SiLU (no cuDNN convolution, which would run
    float32 in TF32). x: (B,S,C); w: (W,C) (or an expert stack (K,W,C)).
    Returns (y, new_carry), the carry being the last W−1 inputs (decode
    state)."""
    W = w.shape[-2]
    if carry is None:
        carry = torch.zeros((x.shape[0], W - 1, x.shape[2]), dtype=x.dtype,
                            device=x.device)
    xp = torch.cat([carry, x], dim=1)
    S = x.shape[1]
    y = sum(per_expert(torch.mul, xp[:, i:i + S], w[..., i, :])
            for i in range(W))
    return F.silu(y), xp[:, -(W - 1):] if W > 1 else carry


def _mamba2_inner(params, x: Tensor, cfg):
    B, S, D = x.shape
    Di, N, H = _d_inner(cfg), cfg.ssm.state, cfg.n_heads
    P = Di // H
    proj = linear(x, params["w_in"])
    xs, z, Bm, Cm, dt_raw = torch.split(proj, [Di, Di, N, N, H], dim=-1)
    return xs, z, Bm, Cm, dt_raw, (B, S, Di, N, H, P)


def mamba2_scan_inputs(params, conv_out: Tensor, dt: Tensor, cfg, x_dtype):
    """(q, k, v, log_g) of the scan from the conv output and the float32
    step sizes dt (B,S,H): q = C and k = B·dt broadcast over the heads
    (materialized, as the kernel takes contiguous rows), v the heads of
    x."""
    B, S, _ = conv_out.shape
    Di, N, H = _d_inner(cfg), cfg.ssm.state, cfg.n_heads
    xs, Bm, Cm = torch.split(conv_out, [Di, N, N], dim=-1)
    A = -torch.exp(params["A_log"].float())                       # (H,)
    log_g = per_expert(torch.mul, dt, A)                          # (B,S,H)
    q = Cm[:, :, None, :].expand(B, S, H, N)
    k = Bm[:, :, None, :].expand(B, S, H, N) * dt[..., None].to(x_dtype)
    v = xs.reshape(B, S, H, Di // H)
    return q, k, v, log_g


def mamba2_out(params, y: Tensor, v: Tensor, z: Tensor, cfg) -> Tensor:
    """D-skip, SiLU gate, norm and the output projection."""
    B, S = y.shape[:2]
    dt_ = z.dtype
    y = y + per_expert(torch.mul, v, params["D_skip"].to(dt_)[..., None], 2)
    y = y.reshape(B, S, -1) * F.silu(z)
    y = rms_norm(y, params["norm"], cfg.norm_eps)
    return linear(y, params["w_out"])


def _softplus_dt(params, dt_raw: Tensor) -> Tensor:
    return F.softplus(per_expert(torch.add, dt_raw.float(),
                                 params["dt_bias"].float()))


def mamba2_block(params, x: Tensor, cfg) -> Tensor:
    """Full-sequence Mamba2 (pre-norm residual handled by the caller)."""
    y, _ = mamba2_prefill(params, x, cfg)
    return y


def mamba2_prefill(params, x: Tensor, cfg):
    """``mamba2_block`` that also returns the decode state (ssm_state
    (B,H,N,P) float32, conv_carry (B,W−1,C)) — the reference model's
    ``_mamba2_prefill``."""
    xs, z, Bm, Cm, dt_raw, _ = _mamba2_inner(params, x, cfg)
    conv_in = torch.cat([xs, Bm, Cm], dim=-1)
    conv_out, conv_carry = _causal_conv(conv_in,
                                        params["conv_w"].to(x.dtype))
    W = params["conv_w"].shape[-2]
    if W > 1:
        conv_carry = conv_in[:, -(W - 1):]
    dt = _softplus_dt(params, dt_raw)
    q, k, v, log_g = mamba2_scan_inputs(params, conv_out, dt, cfg, x.dtype)
    y, st = chunked_linear_attention(q, k, v, log_g, cfg.ssm.chunk)
    return mamba2_out(params, y, v, z, cfg), (st, conv_carry)


def mamba2_chunk(params, x: Tensor, cfg, state, length: int):
    """``mamba2_prefill`` of one right-padded prompt chunk with the carry
    (ssm_state, conv_carry) flowing in from the previous chunk — the
    reference model's ``_mamba2_chunk``. Rows at or past ``length`` (a host
    int) are exact no-ops on both: dt is zeroed there (zero k, unit
    decay), and the new conv carry is sliced at the valid end."""
    ssm_state, conv_carry = state
    xs, z, Bm, Cm, dt_raw, (B, S, _, _, _, _) = _mamba2_inner(params, x, cfg)
    conv_in = torch.cat([xs, Bm, Cm], dim=-1)
    W = params["conv_w"].shape[-2]
    conv_out, _ = _causal_conv(conv_in, params["conv_w"].to(x.dtype),
                               conv_carry)
    if W > 1:
        conv_carry = torch.cat([conv_carry, conv_in], dim=1)[
            :, length:length + W - 1]
    dt = _softplus_dt(params, dt_raw)
    valid = torch.arange(S, device=x.device) < length
    dt = torch.where(valid[None, :, None], dt, 0.0)
    q, k, v, log_g = mamba2_scan_inputs(params, conv_out, dt, cfg, x.dtype)
    y, st = chunked_linear_attention(q, k, v, log_g, cfg.ssm.chunk,
                                     state=ssm_state)
    return mamba2_out(params, y, v, z, cfg), (st, conv_carry)


def mamba2_step(params, x: Tensor, cfg, state):
    """One token per row. x: (B,1,D); state: (ssm_state (B,H,N,P) float32,
    conv_carry (B,W−1,C)). Returns (y (B,1,D), new state)."""
    ssm_state, conv_carry = state
    xs, z, Bm, Cm, dt_raw, (B, S, Di, N, H, P) = _mamba2_inner(params, x,
                                                               cfg)
    conv_in = torch.cat([xs, Bm, Cm], dim=-1)
    conv_out, conv_carry = _causal_conv(conv_in,
                                        params["conv_w"].to(x.dtype),
                                        conv_carry)
    xs, Bm, Cm = torch.split(conv_out, [Di, N, N], dim=-1)
    dt = _softplus_dt(params, dt_raw)[:, 0]                       # (B,H)
    A = -torch.exp(params["A_log"].float())
    g = torch.exp(per_expert(torch.mul, dt, A))                   # (B,H)
    q = Cm[:, 0, None, :].expand(B, H, N)
    k = Bm[:, 0, None, :].expand(B, H, N) * dt[..., None].to(x.dtype)
    v = xs[:, 0].reshape(B, H, P)
    y, ssm_state = linear_attention_step(ssm_state, q, k, v, g)
    y = y + per_expert(torch.mul, v, params["D_skip"].to(x.dtype)[..., None],
                       2)
    y = y.reshape(B, 1, Di) * F.silu(z)
    y = rms_norm(y, params["norm"], cfg.norm_eps)
    return linear(y, params["w_out"]), (ssm_state, conv_carry)


def mamba2_state_shapes(cfg, batch: int):
    Di, N, H = _d_inner(cfg), cfg.ssm.state, cfg.n_heads
    P = Di // H
    return ((batch, H, N, P), (batch, cfg.ssm.conv - 1, Di + 2 * N))
