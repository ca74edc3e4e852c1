"""Walk through the paper's §4 theory numerically, in float64 torch (twin
of ``examples/theory_walkthrough.py``):

1. discrete-time DFM: the AR path satisfies the Continuity Equation;
2. the sampling rule generates the path (1-sparsity ⇒ generation);
3. a 2-position counterexample shows why 1-sparsity is necessary;
4. next-token conditionals fitted by counting (a trained LM's limit),
   plugged in as the velocity, reach the target distribution — the bridge
   to the serving loop.

    PYTHONPATH=src python -m repro_torch.examples.theory_walkthrough [--device cpu]

Runs on the card unless ``--device cpu``; prints the reference's four
sections with the same numbers.
"""
from __future__ import annotations

import argparse
from typing import Dict

import numpy as np
import torch

from repro_torch.core.autoregressive import (ar_marginal_velocity, ar_path,
                                             next_token_conditional)
from repro_torch.core.dfm import (apply_sampling_rule, continuity_residual,
                                  enumerate_states, is_one_sparse, n_states,
                                  neighbor_table)
from repro_torch.device import resolve_device

D, N, P = 3, 3, 0


def _tv(a: torch.Tensor, b: torch.Tensor) -> float:
    return 0.5 * float((a - b).abs().sum())


def run(device="cuda", log=print) -> Dict[str, object]:
    """Run the four sections on ``device``, printing through ``log``.
    Returns their numbers: ``ce`` and ``one_sparse`` (one a step of the AR
    chain), ``tv_chain``, ``ce_counterexample``, ``tv_counterexample`` and
    ``tv_decoded``."""
    dev = resolve_device(device)
    f64 = dict(dtype=torch.float64, device=dev)
    mask = D - 1
    rng = np.random.default_rng(0)
    states = enumerate_states(D, N)
    q = rng.random(n_states(D, N))
    q[(states == mask).any(1)] = 0.0
    q /= q.sum()
    q = torch.as_tensor(q, **f64)
    out: Dict[str, object] = {"ce": [], "one_sparse": []}

    log("== 1–2. AR path: continuity + generation ==")
    path = ar_path(q, P, D, N, mask)
    nbr = neighbor_table(D, N)
    p = path.marginal(0)
    for t in range(N):
        u = ar_marginal_velocity(q, P, t, D, N, mask)
        r = float(continuity_residual(p, path.marginal(t + 1), u,
                                      nbr).abs().max())
        p = apply_sampling_rule(p, u, nbr)
        sparse = is_one_sparse(u, p)
        out["ce"].append(r)
        out["one_sparse"].append(sparse)
        log(f"  t={t}: 1-sparse={sparse}  CE residual={r:.2e}")
    out["tv_chain"] = _tv(p, q)
    log(f"  final TV(p_T, q) = {out['tv_chain']:.2e} ✓\n")

    log("== 3. Why 1-sparsity is necessary ==")
    d2 = 2
    nbr2 = neighbor_table(d2, 2)
    p0 = torch.zeros(4, **f64)
    p0[0] = 1.0
    p1 = torch.zeros(4, **f64)
    p1[1] = p1[2] = 0.5
    u_bad = torch.zeros((2, d2, 4), **f64)
    u_bad[:, 1, 0], u_bad[:, 0, 0] = 0.5, -0.5
    ce = float(continuity_residual(p0, p1, u_bad, nbr2).abs().max())
    pushed = apply_sampling_rule(p0, u_bad, nbr2)
    out["ce_counterexample"] = ce
    out["tv_counterexample"] = _tv(pushed, p1)
    log(f"  2-position velocity: CE residual={ce:.1e} (holds!) but "
        f"TV(pushed, p1)={out['tv_counterexample']:.3f} ≠ 0\n")

    log("== 4. A learned LM as the generating velocity ==")
    # next-token conditionals fitted by counting (the LM limit), decoded
    # with the sampling rule: the chain must land on the target
    p = path.marginal(0)
    for t in range(N):
        u = torch.zeros((N, D, n_states(D, N)), **f64)
        for z in torch.nonzero(p > 0)[:, 0].tolist():
            u[t, :, z] = next_token_conditional(q, states[z, :t], D, N)
            u[t, mask, z] -= 1.0
        p = apply_sampling_rule(p, u, nbr)
    out["tv_decoded"] = _tv(p, q)
    log(f"  TV(decoded, q) = {out['tv_decoded']:.2e} ✓")
    log("\ntheory walkthrough complete ✓")
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default) or 'cpu'")
    run(ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
