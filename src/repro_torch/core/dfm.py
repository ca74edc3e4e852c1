"""Discrete Flow Matching in discrete time (port of ``repro.core.dfm``;
paper §3–4.1).

The exact, enumerable form of the theory on the finite state space
``[d]^N`` (vocab ``d``, length ``N``): probability paths, velocities,
divergences and the Continuity Equation evaluated exactly, in float64
torch on the device of the inputs. The state-space helpers are numpy
copies of the reference's (tables, not tensors).

Conventions (the reference's):

* a state ``x ∈ [d]^N`` is an integer in ``[0, d**N)`` (base ``d``,
  position 0 the most significant digit); ``enumerate_states`` gives the
  decoded table;
* a distribution over states is a vector ``p`` of shape ``(d**N,)``;
* a coupling ``π(x0, x1)`` is a ``(d**N, d**N)`` matrix;
* a velocity ``u`` has shape ``(N, d, d**N)`` with ``u[i, a, z] =
  u_t^i(a, z)``, the rate of moving position ``i`` of state ``z`` to
  token ``a``.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass

import numpy as np
import torch

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# State-space enumeration (numpy, as in the reference)
# ---------------------------------------------------------------------------

def n_states(d: int, N: int) -> int:
    return d**N


def enumerate_states(d: int, N: int) -> np.ndarray:
    """All sequences in ``[d]^N`` as an ``(d**N, N)`` int array (base-d order)."""
    return np.array(list(itertools.product(range(d), repeat=N)), dtype=np.int32)


def encode(seqs: np.ndarray, d: int) -> np.ndarray:
    """Map ``(..., N)`` token sequences to state indices."""
    N = seqs.shape[-1]
    weights = d ** np.arange(N - 1, -1, -1)
    return (seqs * weights).sum(-1)


def decode(idx: np.ndarray, d: int, N: int) -> np.ndarray:
    """Map state indices to ``(..., N)`` token sequences."""
    idx = np.asarray(idx)
    out = np.zeros(idx.shape + (N,), dtype=np.int32)
    rem = idx.copy()
    for i in range(N - 1, -1, -1):
        out[..., i] = rem % d
        rem = rem // d
    return out


def neighbor_table(d: int, N: int) -> np.ndarray:
    """``nbr[z, i, a]``: the state equal to ``z`` except that position
    ``i`` holds token ``a``. Shape ``(d**N, N, d)``: the Hamming-1
    structure under the discrete divergence (Eq. 11–12)."""
    states = enumerate_states(d, N)
    S = states.shape[0]
    nbr = np.zeros((S, N, d), dtype=np.int64)
    weights = d ** np.arange(N - 1, -1, -1)
    base = encode(states, d)
    for i in range(N):
        stripped = base - states[:, i] * weights[i]
        for a in range(d):
            nbr[:, i, a] = stripped + a * weights[i]
    return nbr


def _index(table: np.ndarray, like: Tensor) -> Tensor:
    """A numpy index table as a long tensor on ``like``'s device."""
    return torch.as_tensor(np.asarray(table), dtype=torch.long,
                           device=like.device)


# ---------------------------------------------------------------------------
# Probability paths (Eq. 1–6)
# ---------------------------------------------------------------------------

@dataclass
class FactorizedPath:
    """A conditional probability path ``p_t(x | x0, x1)`` as a per-position
    factorized table, with the coupling π: ``cond[t]`` has shape
    ``(S0, S1, N, d)``, ``cond[t][x0, x1, i, a] = p_t(x^i = a | x0, x1)``."""

    d: int
    N: int
    pi: Tensor                     # (S, S) coupling π(x0, x1)
    cond: list                     # over t: (S, S, N, d)

    @property
    def T(self) -> int:
        return len(self.cond) - 1

    def conditional_joint(self, t: int) -> Tensor:
        """``p_t(x | x0, x1)`` over whole states: shape (S, S, S)."""
        S = n_states(self.d, self.N)
        c = self.cond[t]
        states = _index(enumerate_states(self.d, self.N), c)
        out = torch.ones((S, S, S), dtype=c.dtype, device=c.device)
        for i in range(self.N):
            out = out * c[:, :, i, states[:, i]]
        return out

    def marginal(self, t: int) -> Tensor:
        """``p_t(x)`` by Eq. 1: the coupling marginalized."""
        return torch.einsum("abx,ab->x", self.conditional_joint(t), self.pi)


def mixture_path(d: int, N: int, pi: Tensor, schedulers,
                 w: Tensor) -> FactorizedPath:
    """The convex-sum path of Eq. 5–6. schedulers: (T+1, N, J) with
    ``schedulers[t, i, j] = κ_t^{i,j}``, rows summing to 1 over j; w: (J,
    S0, S1, N, d) basis conditionals ``w^j(x^i | x0, x1)``."""
    kappa = torch.as_tensor(schedulers, dtype=w.dtype, device=w.device)
    cond = [torch.einsum("ij,jabid->abid", kappa[t], w)
            for t in range(kappa.shape[0])]
    return FactorizedPath(d=d, N=N, pi=pi, cond=cond)


# ---------------------------------------------------------------------------
# Velocities, divergence, Continuity Equation (Eq. 9–17)
# ---------------------------------------------------------------------------

def _stay_mask(u: Tensor) -> Tensor:
    """(N, d, S) bool: True at the diagonal (stay) entry ``u[i, z^i, z]``."""
    N, d, S = u.shape
    states = _index(enumerate_states(d, N), u)
    return torch.arange(d, device=u.device)[None, :, None] \
        == states.T[:, None, :]


def velocity_is_valid(u: Tensor, p: Tensor, atol: float = 1e-9) -> bool:
    """Eq. 15–16 on the support of ``p``: columns sum to zero, the stay
    entry lies in [-1, 0] and the others in [0, 1]."""
    if u.sum(dim=1).abs().max().item() > atol:
        return False
    support = p > atol
    stay = _stay_mask(u)
    diag = u.masked_fill(~stay, 0.0).sum(dim=1)[:, support]    # (N, S)
    off = u.masked_fill(stay, 0.0)[:, :, support]
    return not bool((diag < -1 - atol).any() or (diag > atol).any()
                    or (off < -atol).any() or (off > 1 + atol).any())


def divergence(p: Tensor, u: Tensor, nbr: np.ndarray) -> Tensor:
    """Discrete divergence ``div_x(p_t u_t)`` of Eq. 12:
    ``−Σ_z p(z) Σ_i δ_z(x^ī) u^i(x^i, z)``; for fixed i the states z with
    ``δ_z(x^ī) = 1`` are x's Hamming-1 neighbours at i, x included."""
    N, d, S = u.shape
    states = _index(enumerate_states(d, N), u)
    nb = _index(nbr, u)
    div = torch.zeros((S,), dtype=p.dtype, device=p.device)
    for i in range(N):
        zs = nb[:, i, :]                     # (S, d) neighbours at i
        u_vals = u[i, states[:, i, None], zs]
        div = div - (p[zs] * u_vals).sum(dim=1)
    return div


def continuity_residual(p_t: Tensor, p_next: Tensor, u: Tensor,
                        nbr: np.ndarray) -> Tensor:
    """Eq. 17 residual ``p_{t+1}(x) − p_t(x) + div_x(p_t u_t)`` (0 where
    it holds)."""
    return p_next - p_t + divergence(p_t, u, nbr)


def is_one_sparse(u: Tensor, p: Tensor, atol: float = 1e-12) -> bool:
    """Paper §4.2: off the diagonal, ``u^i ≡ 0`` for all but at most one
    position i, uniformly in z on the support of ``p``."""
    support = p > atol
    off = u.masked_fill(_stay_mask(u), 0.0)[:, :, support]
    if off.numel() == 0:
        return True
    active = off.abs().amax(dim=(1, 2)) > atol
    return int(active.sum().item()) <= 1


def apply_sampling_rule(p: Tensor, u: Tensor, nbr: np.ndarray) -> Tensor:
    """Exact pushforward of the sampling rule Eq. 13, ``X_{t+1}^i ~
    δ_{X_t^i}(·) + u^i(·, X_t)`` independently per position: the pmf
    ``Σ_z p(z) Π_i (δ_z(x^i) + u^i(x^i, z))``. Per position the kernel
    ``K_i[a, z] = δ(a = z^i) + u[i, a, z]``; gathering its rows at each
    state's token and multiplying over positions gives the (S_x, S_z)
    transition matrix, contracted once with ``p``."""
    N, d, S = u.shape
    states = _index(enumerate_states(d, N), u)
    kern = u + _stay_mask(u).to(u.dtype)                   # (N, d, S_z)
    trans = torch.ones((S, S), dtype=p.dtype, device=p.device)
    for i in range(N):
        trans = trans * kern[i, states[:, i]]              # (S_x, S_z)
    return trans @ p


def marginal_velocity(path: FactorizedPath, t: int, cond_u: Tensor) -> Tensor:
    """Theorem 1 (Eq. 9): conditional velocities marginalized against the
    posterior ``p_t(z|x0,x1) π(x0,x1) / p_t(z)``. cond_u: (S0, S1, N, d,
    S), ``cond_u[x0,x1,i,a,z] = u_t^i(a, z | x0, x1)``; returns (N, d, S)."""
    joint = path.conditional_joint(t)                      # (S0, S1, S_z)
    pz = torch.einsum("abz,ab->z", joint, path.pi)
    post = joint * path.pi[:, :, None]
    safe = torch.where(pz > 0, pz, torch.ones_like(pz))
    return torch.einsum("abidz,abz->idz", cond_u, post) / safe[None, None, :]


def chain_marginals(p0: Tensor, us: list, nbr: np.ndarray) -> list:
    """The sampling rule rolled forward: ``[p_0, p_1, ..., p_T]``."""
    ps = [p0]
    for u in us:
        ps.append(apply_sampling_rule(ps[-1], u, nbr))
    return ps
