"""Chunkwise linear attention, the xLSTM blocks (mLSTM, sLSTM) and the
Mamba2 (SSD) block (port of ``repro.models.ssm``).

The recurrence y_t = q_t · Σ_{s≤t} (Π_{r=s+1..t} g_r) k_s v_sᵀ runs in
chunks: the intra-chunk part goes through ``kernels.ops.chunk_scan`` (the
CUDA kernel on the card, its plain version on the CPU), or, when the
caller asks for a gradient (``differentiable=True``: training), through
``chunk_scan_differentiable``, the reference model's jnp branch under
autograd; the carry between chunks is a loop over the chunks, as the
reference's ``lax.scan``, and decode is the O(1)-per-token state update.
The sLSTM is a sequential per-token loop with no kernel, as in the
reference; it runs under autograd as it is. Casts follow the
reference: states and decays in float32, projections in the working
dtype. Every block also takes a stack of K experts' parameters with K
folded into the batch of the activations and states (``layers``'
expert-stack convention). On DTensors (a model placed on a mesh) each
block runs on each device's batch rows with its params gathered whole
(``layers.placed_rows``): DTensor has no placement for the scans.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops

from .layers import linear, per_expert, placed_rows, rms_norm
from .params import ParamSpec

Tensor = torch.Tensor


def chunk_scan_differentiable(qc: Tensor, kc: Tensor, vc: Tensor,
                              cum: Tensor) -> Tuple[Tensor, Tensor]:
    """The intra-chunk outputs and chunk summaries of ``kops.chunk_scan``
    (qc, kc (B,NC,L,H,dk); vc (B,NC,L,H,dv); cum (B,NC,L,H) float32
    cumulative log decay) in the reference model's training arithmetic
    (``repro/models/ssm.py:55-67``, its jnp branch), for autograd: the q·k
    product in the input dtype, upcast after; the decay matrix masked to
    −inf above the diagonal BEFORE the exp (masking after it would put
    inf into the gradient, as NaN); the intra part and the summaries as
    float32 products. Not the kernel's plain version (``chunk_scan_ref``
    upcasts q and k before their product, another rounding in bf16)."""
    L = qc.shape[2]
    decay = cum[:, :, :, None, :] - cum[:, :, None, :, :]     # (B,NC,L,L,H)
    tri = torch.ones((L, L), dtype=torch.bool, device=qc.device).tril()
    D = torch.exp(decay.masked_fill(~tri[None, None, :, :, None],
                                    float("-inf")))
    scores = torch.einsum("bclhd,bcmhd->bclmh", qc, kc).float()
    vf = vc.float()
    intra = torch.einsum("bclmh,bcmhv->bclhv", scores * D, vf)
    total = cum[:, :, -1]
    k_dec = kc.float() * torch.exp(total[:, :, None, :] - cum)[..., None]
    chunk_kv = torch.einsum("bclhd,bclhv->bchdv", k_dec, vf)
    return intra, chunk_kv


def chunked_linear_attention(q: Tensor, k: Tensor, v: Tensor, log_g: Tensor,
                             chunk: int, state: Optional[Tensor] = None, *,
                             differentiable: bool = False
                             ) -> Tuple[Tensor, Tensor]:
    """q, k: (B,S,H,dk); v: (B,S,H,dv); log_g: (B,S,H) per-step log decay
    ≤ 0; state: (B,H,dk,dv) float32 carried in (zeros when None). Returns
    (y (B,S,H,dv) in v's dtype, final state (B,H,dk,dv) float32).
    ``differentiable``: the intra-chunk part from
    ``chunk_scan_differentiable`` (training) instead of the kernel seam,
    whose chunk scan has no backward and refuses autograd."""
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
    scan = chunk_scan_differentiable if differentiable else kops.chunk_scan
    intra, chunk_kv = scan(qc, kc, vc, cum)
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


# ---------------------------------------------------------------------------
# mLSTM block (xLSTM): matrix memory, chunkwise in time
# ---------------------------------------------------------------------------

def mlstm_specs(cfg) -> Dict[str, ParamSpec]:
    D, Di, H = cfg.d_model, _d_inner(cfg), cfg.n_heads
    return {
        "w_in": ParamSpec((D, 2 * Di), ("embed", "inner"), "scaled"),
        "w_qkv": ParamSpec((Di, 3 * Di), ("inner", "inner_qkv"), "scaled"),
        "w_gates": ParamSpec((Di, 2 * H), ("inner", None), "scaled"),
        "b_gates": ParamSpec((2 * H,), (None,), "zeros"),
        "w_out": ParamSpec((Di, D), ("inner", "embed"), "scaled"),
        "norm": ParamSpec((Di,), (None,), "ones"),
    }


def _mlstm_qkvg(params, x: Tensor, cfg):
    """(q, k·i_gate, v, log_f, z): the heads (B,S,H,dh) in the working
    dtype, q over sqrt(dh) rounded to that dtype as the reference does,
    the float32 log forget gate (B,S,H) and the output gate's input z."""
    dt = x.dtype
    B, S, _ = x.shape
    Di, H = _d_inner(cfg), cfg.n_heads
    dh = Di // H
    xm, z = linear(x, params["w_in"]).chunk(2, dim=-1)
    q, k, v = linear(xm, params["w_qkv"]).chunk(3, dim=-1)
    shape = (B, S, H, dh)
    scale = torch.tensor(math.sqrt(dh), dtype=torch.float32).to(dt).item()
    q = q.reshape(shape) / scale
    k, v = k.reshape(shape), v.reshape(shape)
    gates = per_expert(torch.add, linear(xm, params["w_gates"]),
                       params["b_gates"].to(dt))
    i_pre, f_pre = gates.chunk(2, dim=-1)                   # (B,S,H) ×2
    log_f = F.logsigmoid(f_pre.float())
    i_gate = torch.sigmoid(i_pre.float()).to(dt)
    return q, k * i_gate[..., None], v, log_f, z


def _mlstm_out(params, y: Tensor, z: Tensor, cfg) -> Tensor:
    """The normalizer division, the norm, the output gate and the output
    projection of the scan's (B,S,H,dh+1) rows."""
    B, S = y.shape[:2]
    num, den = y[..., :-1], y[..., -1:]
    h = (num / (den.abs() + 1.0)).reshape(B, S, -1)
    h = rms_norm(h, params["norm"], cfg.norm_eps) * F.silu(z)
    return linear(h, params["w_out"])


def _with_ones(v: Tensor) -> Tensor:
    """v with the all-ones value channel of the matrix memory's
    normalizer appended."""
    return torch.cat([v, torch.ones_like(v[..., :1])], dim=-1)


@placed_rows
def mlstm_prefill(params, x: Tensor, cfg, state: Optional[Tensor] = None,
                  length: Optional[int] = None, *,
                  differentiable: bool = False):
    """The full-sequence mLSTM that also returns the decode state (B,H,dh,
    dh+1) float32, from ``state`` (zeros when None). With ``length`` (a host
    int: a right-padded prefill chunk) rows at or past it are exact no-ops
    on the state: their k is zeroed and their decay is 1.
    ``differentiable`` is ``chunked_linear_attention``'s."""
    q, k, v, log_f, z = _mlstm_qkvg(params, x, cfg)
    if length is not None:
        valid = torch.arange(x.shape[1], device=x.device) < length
        k = k * valid[None, :, None, None].to(k.dtype)
        log_f = torch.where(valid[None, :, None], log_f, 0.0)
    y, st = chunked_linear_attention(q, k, _with_ones(v), log_f,
                                     cfg.ssm.chunk, state=state,
                                     differentiable=differentiable)
    return _mlstm_out(params, y, z, cfg), st


def mlstm_block(params, x: Tensor, cfg, *,
                differentiable: bool = False) -> Tensor:
    """Full-sequence mLSTM (pre-norm residual handled by the caller);
    ``differentiable`` for training."""
    return mlstm_prefill(params, x, cfg, differentiable=differentiable)[0]


@placed_rows
def mlstm_step(params, x: Tensor, cfg, state: Tensor):
    """x: (B, 1, D); state: (B, H, dh, dh+1) float32 matrix memory with
    its normalizer column. Returns (y (B,1,D), new state)."""
    q, k, v, log_f, z = _mlstm_qkvg(params, x, cfg)
    y, state = linear_attention_step(state, q[:, 0], k[:, 0],
                                     _with_ones(v)[:, 0],
                                     torch.exp(log_f[:, 0]))
    return _mlstm_out(params, y[:, None], z, cfg), state


def mlstm_state_shape(cfg, batch: int) -> Tuple[int, ...]:
    Di, H = _d_inner(cfg), cfg.n_heads
    dh = Di // H
    return (batch, H, dh, dh + 1)


# ---------------------------------------------------------------------------
# sLSTM block (xLSTM): scalar memory, sequential
# ---------------------------------------------------------------------------

def slstm_specs(cfg) -> Dict[str, ParamSpec]:
    D, Di = cfg.d_model, _d_inner(cfg)
    return {
        "w_gates": ParamSpec((D, 4 * Di), ("embed", "inner"), "scaled"),
        "r_gates": ParamSpec((4 * Di,), (None,), "zeros"),
        "b_gates": ParamSpec((4 * Di,), (None,), "zeros"),
        "w_out": ParamSpec((Di, D), ("inner", "embed"), "scaled"),
        "norm": ParamSpec((Di,), (None,), "ones"),
    }


def slstm_init_state(batch: int, Di: int, device) -> Tuple[Tensor, ...]:
    """The sLSTM's initial (c, n, m, h), each (batch, Di) float32: zeros,
    with the stabilizer m at −1e30."""
    z = torch.zeros((batch, Di), dtype=torch.float32, device=device)
    return z, z.clone(), torch.full_like(z, -1e30), z.clone()


@placed_rows
def slstm_scan(params, x: Tensor, cfg, state=None,
               length: Optional[int] = None):
    """Sequential sLSTM with stabilized exponential gating, one step a
    position. state: (c, n, m, h), each (B, Di) float32 (the initial state
    when None). Returns (y (B,S,D), state). The recurrence is diagonal
    (elementwise h feedback), the reference's simplification.

    ``length`` (a host int) freezes the state from position ``length``
    on: chunked prefill right-pads its final chunk, and the padded steps
    are exact no-ops on (c, n, m, h) — they are not computed, and their
    output row repeats the last valid h, as the reference's select
    does."""
    dt = x.dtype
    B, S, _ = x.shape
    pre = per_expert(torch.add, linear(x, params["w_gates"]),
                     params["b_gates"].to(dt)).float()          # (B,S,4Di)
    r = params["r_gates"].float()
    if state is None:
        state = slstm_init_state(B, _d_inner(cfg), x.device)
    c, n, m, h = state
    steps = S if length is None else min(S, length)
    # one view a position, taken at once: under autograd their gradients
    # are stacked in one op (a per-step ``pre[:, t]`` would add a full
    # (B,S,4Di) zero-padded gradient a position, O(S²) in the backward)
    pres = pre.unbind(1)
    hs = []
    for t in range(steps):
        g = pres[t] + per_expert(torch.mul, h.repeat(1, 4), r)
        i_pre, f_pre, z_pre, o_pre = g.chunk(4, dim=-1)
        log_f = F.logsigmoid(f_pre)
        m_new = torch.maximum(log_f + m, i_pre)
        i_g = torch.exp(i_pre - m_new)
        f_g = torch.exp(log_f + m - m_new)
        c = f_g * c + i_g * torch.tanh(z_pre)
        n = f_g * n + i_g
        h = torch.sigmoid(o_pre) * c / n.clamp_min(1.0)
        m = m_new
        hs.append(h)
    hs += [h] * (S - steps)
    out = rms_norm(torch.stack(hs, dim=1).to(dt), params["norm"],
                   cfg.norm_eps)
    return linear(out, params["w_out"]), (c, n, m, h)


def slstm_state_shapes(cfg, batch: int):
    Di = _d_inner(cfg)
    return tuple((batch, Di) for _ in range(4))


# ---------------------------------------------------------------------------
# Mamba2 (SSD) block
# ---------------------------------------------------------------------------


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


def mamba2_block(params, x: Tensor, cfg, *,
                 differentiable: bool = False) -> Tensor:
    """Full-sequence Mamba2 (pre-norm residual handled by the caller);
    ``differentiable`` for training."""
    y, _ = mamba2_prefill(params, x, cfg, differentiable=differentiable)
    return y


@placed_rows
def mamba2_prefill(params, x: Tensor, cfg, *, differentiable: bool = False):
    """``mamba2_block`` that also returns the decode state (ssm_state
    (B,H,N,P) float32, conv_carry (B,W−1,C)) — the reference model's
    ``_mamba2_prefill``. ``differentiable`` is
    ``chunked_linear_attention``'s."""
    xs, z, Bm, Cm, dt_raw, _ = _mamba2_inner(params, x, cfg)
    conv_in = torch.cat([xs, Bm, Cm], dim=-1)
    conv_out, conv_carry = _causal_conv(conv_in,
                                        params["conv_w"].to(x.dtype))
    W = params["conv_w"].shape[-2]
    if W > 1:
        conv_carry = conv_in[:, -(W - 1):]
    dt = _softplus_dt(params, dt_raw)
    q, k, v, log_g = mamba2_scan_inputs(params, conv_out, dt, cfg, x.dtype)
    y, st = chunked_linear_attention(q, k, v, log_g, cfg.ssm.chunk,
                                     differentiable=differentiable)
    return mamba2_out(params, y, v, z, cfg), (st, conv_carry)


@placed_rows
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


@placed_rows
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
