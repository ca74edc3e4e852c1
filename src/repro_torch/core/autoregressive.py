"""Autoregressive sampling as an instance of discrete-time DFM (port of
``repro.core.autoregressive``; paper §4.2).

Eq. 18–22 exactly on the enumerable space ``[d]^N``, in float64 torch on
the device of the target ``q`` (positions 0-indexed: at timestep ``t``
exactly ``P + t`` tokens are revealed, and the one active position is
``j(t) = P + t``). ``ar_conditional_velocity`` builds from nothing and
takes ``device=`` (the card unless the caller asks for the CPU).

``next_token_conditional`` is what a trained language model approximates;
``velocity_from_conditional`` turns a model's next-token distribution into
the 1-sparse velocity slice, so the serving engine's ordinary
autoregressive decoding is ``apply_sampling_rule`` restricted to the
active position.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device

from .dfm import FactorizedPath, decode, encode, enumerate_states, n_states

Tensor = torch.Tensor


def mask_state(x1_tokens: np.ndarray, reveal: int, mask_id: int) -> np.ndarray:
    """First ``reveal`` tokens of x1, the rest the mask (the coupling of
    Eq. 18)."""
    out = np.full_like(x1_tokens, mask_id)
    out[..., :reveal] = x1_tokens[..., :reveal]
    return out


def _revealed(P: int, d: int, N: int, mask_id: int) -> np.ndarray:
    """(S,) the state index of ``mask_state(x1, P)`` for every x1."""
    return encode(mask_state(enumerate_states(d, N), P, mask_id), d)


def masked_coupling(q: Tensor, P: int, d: int, N: int, mask_id: int) -> Tensor:
    """π(x0, x1) of Eq. 18 for a fixed prefix length P: x0 = (x1[:P], m,
    ..., m), x1 ~ q. Shape (S, S), on ``q``'s device."""
    S = n_states(d, N)
    x0 = torch.as_tensor(_revealed(P, d, N, mask_id), device=q.device)
    pi = torch.zeros((S, S), dtype=q.dtype, device=q.device)
    pi[x0, torch.arange(S, device=q.device)] = q
    return pi


def ar_scheduler(P: int, N: int, T: int) -> np.ndarray:
    """κ_t^i of Eq. 20 (0-indexed): κ[t, i] = 1 iff position i is revealed
    at t, i.e. i < P + t. Shape (T+1, N)."""
    kappa = np.zeros((T + 1, N))
    for t in range(T + 1):
        kappa[t, : min(N, P + t)] = 1.0
    return kappa


def ar_path(q: Tensor, P: int, d: int, N: int, mask_id: int) -> FactorizedPath:
    """The AR conditional probability path of Eq. 19–20, T = N − P steps:
    ``cond[t][x0, x1, i, a] = κ_t^i δ_{x1^i}(a) + (1 − κ_t^i) δ_{x0^i}(a)``."""
    states = enumerate_states(d, N)
    pi = masked_coupling(q, P, d, N, mask_id)
    kappa = torch.as_tensor(ar_scheduler(P, N, N - P), dtype=q.dtype,
                            device=q.device)
    onehot = torch.as_tensor(np.eye(d)[states], dtype=q.dtype,
                             device=q.device)           # (S, N, d)
    cond = []
    for t in range(N - P + 1):
        k = kappa[t][None, None, :, None]
        cond.append(k * onehot[None] + (1 - k) * onehot[:, None])
    return FactorizedPath(d=d, N=N, pi=pi, cond=cond)


def ar_conditional_velocity(t: int, P: int, d: int, N: int, mask_id: int,
                            device="cuda") -> Tensor:
    """Eq. 22: ``u_t^i(a, z | x0, x1) = (δ_{x_{t+1}}(a) − δ_{x_t}(a))
    1[z = x_t]``, indexed (x0, x1, i, a, z); x0 is a function of x1 under
    the coupling, so only the x1 slice matters. Shape (S, S, N, d, S),
    float64 on ``device``."""
    dev = resolve_device(device)
    S = n_states(d, N)
    xt_idx = _revealed(P + t, d, N, mask_id)
    xt_toks = decode(xt_idx, d, N)
    xt1_toks = decode(_revealed(P + t + 1, d, N, mask_id), d, N)
    u = torch.zeros((S, S, N, d, S), dtype=torch.float64, device=dev)
    j = P + t                    # the one active position
    if j < N:
        x1 = torch.arange(S, device=dev)
        z = torch.as_tensor(xt_idx, device=dev)
        up = torch.as_tensor(xt1_toks[:, j], device=dev)
        down = torch.as_tensor(xt_toks[:, j], device=dev)
        u[:, x1, j, up, z] += 1.0
        u[:, x1, j, down, z] -= 1.0
    return u


def next_token_conditional(q: Tensor, prefix, d: int, N: int) -> Tensor:
    """``q(x^j = a | x^{<j} = prefix)`` for j = len(prefix): what an LM
    learns. (d,) on ``q``'s device; uniform where the prefix has no
    mass."""
    j = len(prefix)
    states = enumerate_states(d, N)
    sel = np.all(states[:, :j] == np.asarray(prefix)[None, :], axis=1)
    idx = torch.as_tensor(np.nonzero(sel)[0], device=q.device)
    a = torch.as_tensor(states[sel, j].astype(np.int64), device=q.device)
    probs = torch.zeros((d,), dtype=q.dtype, device=q.device)
    probs.index_add_(0, a, q[idx])
    tot = probs.sum()
    if tot.item() > 0:
        return probs / tot
    return torch.full((d,), 1.0 / d, dtype=q.dtype, device=q.device)


def ar_marginal_velocity(q: Tensor, P: int, t: int, d: int, N: int,
                         mask_id: int) -> Tensor:
    """Closed-form marginal velocity (Theorem 1 applied to Eq. 19–22): at
    the active position j = P + t and a reachable state z (the prefix of
    some x1 in supp(q), masks after), ``u^j(a, z) = q(x^j = a | z^{<j}) −
    δ(a = m)``; zero elsewhere. Shape (N, d, S). The reference loops over
    the reachable states; here every prefix's conditional comes from one
    scatter of q by (prefix state, next token)."""
    S = n_states(d, N)
    u = torch.zeros((N, d, S), dtype=q.dtype, device=q.device)
    j = P + t
    if j >= N:
        return u
    # q's mass by revealed prefix state z = x_t(x1) and next token x1^j
    z = torch.as_tensor(_revealed(j, d, N, mask_id), device=q.device)
    a = torch.as_tensor(enumerate_states(d, N)[:, j].astype(np.int64),
                        device=q.device)
    mass = torch.zeros((S, d), dtype=q.dtype, device=q.device)
    mass.index_put_((z, a), q, accumulate=True)
    tot = mass.sum(dim=1)
    reach = tot > 0
    cond = mass[reach] / tot[reach, None]                  # (R, d)
    cond[:, mask_id] -= 1.0
    u[j, :, reach] = cond.T
    return u


def velocity_from_conditional(cond_probs: Tensor, z_tok: Tensor) -> Tensor:
    """Production bridge: a model's next-token distribution ``cond_probs``
    (..., d) and the current token at the active position ``z_tok`` (...,)
    give the 1-sparse velocity slice ``u^j(·, z) = cond_probs −
    onehot(z_tok)``: all mass moves from the current (mask) token to the
    model's conditional."""
    d = cond_probs.shape[-1]
    return cond_probs - torch.eye(d, dtype=cond_probs.dtype,
                                  device=cond_probs.device)[z_tok]
