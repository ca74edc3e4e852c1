"""The port's §4 theory (``repro_torch.core.dfm``, ``.autoregressive`` and
the theory half of ``.decentralize``) against the JAX reference, float64 on
both sides (``jax_enable_x64``, set by ``tests/conftest.py``), on the same numpy-seeded
inputs: the numpy tables equal exactly, every tensor within 1e-12, over
the reference tests' grids (``test_dfm.py``'s (d, N, P) and
``test_decentralize.py``'s (d, N, P, K)); the decomposition residual
itself ≤ 1e-12 on every grid case; one property case drawn as the
reference's are; and the walkthrough twin's numbers on the CPU equal to
the reference walkthrough's.
"""
import numpy as np
import pytest
from _hyp import given, settings, st

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import autoregressive as jar  # noqa: E402
from repro.core import decentralize as jdec  # noqa: E402
from repro.core import dfm as jdfm  # noqa: E402
from repro_torch.core import autoregressive as tar  # noqa: E402
from repro_torch.core import decentralize as tdec  # noqa: E402
from repro_torch.core import dfm as tdfm  # noqa: E402
from repro_torch.core import router as trouter  # noqa: E402
from repro_torch.examples import theory_walkthrough  # noqa: E402

TOL = 1e-12
DFM_GRID = [(3, 3, 0), (3, 3, 1), (2, 4, 2), (4, 2, 0)]
SPLIT_GRID = [(3, 3, 0, 2), (3, 3, 1, 3), (2, 4, 0, 2), (4, 2, 0, 4)]


def close(got, want, tol=TOL):
    np.testing.assert_allclose(got.cpu().numpy(), np.asarray(want),
                               rtol=0, atol=tol)


def t64(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def target(d, N, seed, sparse=False):
    """A target q with no mask token (the reference tests' ``random_q``
    with the mask rows zeroed), numpy float64."""
    rng = np.random.default_rng(seed)
    S = d**N
    q = rng.random(S)
    if sparse:
        q[rng.random(S) < 0.5] = 0.0
    q[(jdfm.enumerate_states(d, N) == d - 1).any(1)] = 0.0
    if q.sum() == 0:
        q[np.where(~(jdfm.enumerate_states(d, N) == d - 1).any(1))[0][0]] = 1.0
    return q / q.sum()


def make_split(d, N, K, seed):
    """``test_decentralize.make_split``'s inputs: (q, assignment)."""
    rng = np.random.default_rng(seed)
    S = d**N
    states = jdfm.enumerate_states(d, N)
    q = rng.random(S)
    q[(states == d - 1).any(1)] = 0.0
    q[rng.random(S) < 0.3] = 0.0
    if q.sum() == 0:
        q[np.where(~(states == d - 1).any(1))[0][0]] = 1.0
    q = q / q.sum()
    assignment = rng.integers(0, K, size=S)
    supp = np.where(q > 0)[0]
    for k in range(min(K, len(supp))):
        assignment[supp[k]] = k
    return q, assignment


# ---------------------------------------------------------------------------
# Tables: exactly the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d,N", [(2, 2), (3, 3), (2, 4), (4, 2), (4, 3)])
def test_tables_equal_reference(d, N):
    assert tdfm.n_states(d, N) == jdfm.n_states(d, N)
    states = tdfm.enumerate_states(d, N)
    np.testing.assert_array_equal(states, jdfm.enumerate_states(d, N))
    assert states.dtype == jdfm.enumerate_states(d, N).dtype
    idx = tdfm.encode(states, d)
    np.testing.assert_array_equal(idx, jdfm.encode(states, d))
    np.testing.assert_array_equal(tdfm.decode(idx, d, N),
                                  jdfm.decode(idx, d, N))
    np.testing.assert_array_equal(tdfm.neighbor_table(d, N),
                                  jdfm.neighbor_table(d, N))
    for P in range(N + 1):
        np.testing.assert_array_equal(tar.mask_state(states, P, d - 1),
                                      jar.mask_state(states, P, d - 1))
        np.testing.assert_array_equal(tar.ar_scheduler(P, N, N - P),
                                      jar.ar_scheduler(P, N, N - P))


# ---------------------------------------------------------------------------
# dfm + autoregressive over test_dfm.py's grid
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d,N,P", DFM_GRID)
def test_ar_path_and_velocities_match_reference(d, N, P):
    """The coupling, the path's joint and marginals, the closed-form and
    Theorem-1 velocities, validity, 1-sparsity, the divergence, the
    Continuity Equation residual, the sampling rule and the chain."""
    mask = d - 1
    qn = target(d, N, seed=0)
    jq, q = jnp.asarray(qn), t64(qn)
    close(tar.masked_coupling(q, P, d, N, mask),
          jar.masked_coupling(jq, P, d, N, mask))
    jpath, path = jar.ar_path(jq, P, d, N, mask), tar.ar_path(q, P, d, N, mask)
    assert path.T == jpath.T == N - P
    nbr = tdfm.neighbor_table(d, N)
    us, jus = [], []
    for t in range(N - P + 1):
        close(path.cond[t], jpath.cond[t])
        close(path.conditional_joint(t), jpath.conditional_joint(t))
        close(path.marginal(t), jpath.marginal(t))
    for t in range(N - P):
        p_t, jp_t = path.marginal(t), jpath.marginal(t)
        u = tar.ar_marginal_velocity(q, P, t, d, N, mask)
        ju = jar.ar_marginal_velocity(jq, P, t, d, N, mask)
        close(u, ju)
        us.append(u)
        jus.append(ju)
        assert tdfm.velocity_is_valid(u, p_t) == \
            jdfm.velocity_is_valid(ju, jp_t) is True
        assert tdfm.is_one_sparse(u, p_t) == jdfm.is_one_sparse(ju, jp_t) \
            is True
        close(tdfm.divergence(p_t, u, nbr), jdfm.divergence(jp_t, ju, nbr))
        res = tdfm.continuity_residual(p_t, path.marginal(t + 1), u, nbr)
        close(res, jdfm.continuity_residual(jp_t, jpath.marginal(t + 1), ju,
                                            nbr))
        close(res, np.zeros(d**N))
        pushed = tdfm.apply_sampling_rule(p_t, u, nbr)
        close(pushed, jdfm.apply_sampling_rule(jp_t, ju, nbr))
        close(pushed, path.marginal(t + 1).numpy())
        cond_u = tar.ar_conditional_velocity(t, P, d, N, mask, device="cpu")
        jcond_u = jar.ar_conditional_velocity(t, P, d, N, mask)
        close(cond_u, jcond_u)
        close(tdfm.marginal_velocity(path, t, cond_u),
              jdfm.marginal_velocity(jpath, t, jcond_u))
    chain = tdfm.chain_marginals(path.marginal(0), us, nbr)
    jchain = jdfm.chain_marginals(jpath.marginal(0), jus, nbr)
    for got, want in zip(chain, jchain):
        close(got, want)
    close(chain[-1], qn)


def test_general_velocities_match_reference():
    """Velocities that are not the AR path's: random ones (invalid, not
    1-sparse) through every dfm function, the 2-position counterexample,
    and ``mixture_path`` over random schedulers and basis conditionals."""
    rng = np.random.default_rng(4)
    for d, N in ((3, 3), (2, 4)):
        S = d**N
        un = rng.normal(size=(N, d, S))
        pn = rng.random(S)
        pn[rng.random(S) < 0.3] = 0.0
        pn /= pn.sum()
        u, p, ju, jp = t64(un), t64(pn), jnp.asarray(un), jnp.asarray(pn)
        nbr = tdfm.neighbor_table(d, N)
        close(tdfm.apply_sampling_rule(p, u, nbr),
              jdfm.apply_sampling_rule(jp, ju, nbr))
        close(tdfm.divergence(p, u, nbr), jdfm.divergence(jp, ju, nbr))
        assert tdfm.velocity_is_valid(u, p) == jdfm.velocity_is_valid(ju, jp)
        assert tdfm.is_one_sparse(u, p) == jdfm.is_one_sparse(ju, jp)
        # a valid velocity at one position: moves all of p's stay mass
        # toward token 0 at rate 1/2
        vn = np.zeros((N, d, S))
        st_ = jdfm.enumerate_states(d, N)
        for z in range(S):
            if st_[z, 1] != 0:
                vn[1, 0, z], vn[1, st_[z, 1], z] = 0.5, -0.5
        assert tdfm.velocity_is_valid(t64(vn), p) == \
            jdfm.velocity_is_valid(jnp.asarray(vn), jp) is True
        assert tdfm.is_one_sparse(t64(vn), p) == \
            jdfm.is_one_sparse(jnp.asarray(vn), jp) is True
        close(tdfm.apply_sampling_rule(p, t64(vn), nbr),
              jdfm.apply_sampling_rule(jp, jnp.asarray(vn), nbr))
    # the counterexample of test_dfm.py and the walkthrough
    nbr2 = tdfm.neighbor_table(2, 2)
    un = np.zeros((2, 2, 4))
    un[:, 1, 0], un[:, 0, 0] = 0.5, -0.5
    p0 = np.eye(4)[0]
    assert not tdfm.is_one_sparse(t64(un), t64(p0))
    close(tdfm.apply_sampling_rule(t64(p0), t64(un), nbr2),
          jdfm.apply_sampling_rule(jnp.asarray(p0), jnp.asarray(un), nbr2))
    # mixture_path (Eq. 5–6)
    d, N, J, T = 2, 2, 3, 2
    S = d**N
    kappa = rng.random((T + 1, N, J))
    kappa /= kappa.sum(-1, keepdims=True)
    w = rng.random((J, S, S, N, d))
    w /= w.sum(-1, keepdims=True)
    pi = rng.random((S, S))
    pi /= pi.sum()
    path = tdfm.mixture_path(d, N, t64(pi), kappa, t64(w))
    jpath = jdfm.mixture_path(d, N, jnp.asarray(pi), jnp.asarray(kappa),
                              jnp.asarray(w))
    for t in range(T + 1):
        close(path.cond[t], jpath.cond[t])
        close(path.marginal(t), jpath.marginal(t))


def test_next_token_conditional_and_bridge_match_reference():
    d, N = 3, 3
    qn = target(d, N, seed=6, sparse=True)
    q, jq = t64(qn), jnp.asarray(qn)
    for prefix in ([], [0], [1], [2], [0, 1], [1, 0], [2, 2]):
        close(tar.next_token_conditional(q, np.asarray(prefix, np.int32),
                                         d, N),
              jar.next_token_conditional(jq, np.asarray(prefix, np.int32),
                                         d, N))
    rng = np.random.default_rng(7)
    probs = rng.random((5, d))
    probs /= probs.sum(-1, keepdims=True)
    z = rng.integers(0, d, 5)
    close(tar.velocity_from_conditional(t64(probs), torch.as_tensor(z)),
          jar.velocity_from_conditional(jnp.asarray(probs), jnp.asarray(z)))


def test_builders_default_to_the_card():
    """The one function that makes tensors from nothing runs on the card
    unless asked for the CPU; every other function follows its inputs."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        tar.ar_conditional_velocity(0, 0, 3, 3, 2)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        theory_walkthrough.run(log=lambda _: None)


# ---------------------------------------------------------------------------
# decentralize over test_decentralize.py's grid
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d,N,P,K", SPLIT_GRID)
def test_decomposition_matches_reference(d, N, P, K):
    """Prior, cluster targets, expert velocities, the exact router, the
    Eq. 27 recomposition and the residual, which is ≤ 1e-12 at every
    step."""
    mask = d - 1
    qn, assignment = make_split(d, N, K, seed=0)
    split = tdec.ClusterSplit(q=t64(qn), assignment=assignment, K=K)
    jsplit = jdec.ClusterSplit(q=jnp.asarray(qn), assignment=assignment, K=K)
    close(split.prior(), jsplit.prior())
    for k in range(K):
        close(split.cluster_target(k), jsplit.cluster_target(k))
    for t in range(N - P):
        u_k = tdec.expert_velocities(split, P, t, d, N, mask)
        close(u_k, jdec.expert_velocities(jsplit, P, t, d, N, mask))
        r = tdec.router_weights(split, P, t, d, N, mask)
        close(r, jdec.router_weights(jsplit, P, t, d, N, mask))
        close(r.sum(0), np.ones(d**N))
        close(tdec.global_velocity_from_experts(u_k, r),
              jdec.global_velocity_from_experts(jnp.asarray(u_k.numpy()),
                                                jnp.asarray(r.numpy())))
        res = tdec.decomposition_residual(split, P, t, d, N, mask)
        assert res.dim() == 0 and float(res) <= TOL
        assert abs(float(res) - float(jdec.decomposition_residual(
            jsplit, P, t, d, N, mask))) <= TOL


@settings(max_examples=4, deadline=None)
@given(K=st.integers(2, 5), seed=st.integers(0, 10_000), t=st.integers(0, 2))
def test_property_decomposition_matches_reference(K, seed, t):
    d, N, P = 3, 3, 0
    qn, assignment = make_split(d, N, K, seed)
    split = tdec.ClusterSplit(q=t64(qn), assignment=assignment, K=K)
    jsplit = jdec.ClusterSplit(q=jnp.asarray(qn), assignment=assignment, K=K)
    close(tdec.router_weights(split, P, t, d, N, d - 1),
          jdec.router_weights(jsplit, P, t, d, N, d - 1))
    assert float(tdec.decomposition_residual(split, P, t, d, N, d - 1)) \
        <= TOL


def test_production_form_matches_reference():
    """``topk_filter_renorm`` is the router's, and it and
    ``mix_expert_distributions`` equal the reference's."""
    assert tdec.topk_filter_renorm is trouter.topk_filter_renorm
    rng = np.random.default_rng(3)
    w = rng.random((4, 6))
    for k in (1, 2, 4):
        close(tdec.topk_filter_renorm(t64(w), k),
              jdec.topk_filter_renorm(jnp.asarray(w), k))
    probs = rng.random((4, 5, 7))
    probs /= probs.sum(-1, keepdims=True)
    wn = w[:, :5] / w[:, :5].sum(0, keepdims=True)
    close(tdec.mix_expert_distributions(t64(probs), t64(wn)),
          jdec.mix_expert_distributions(jnp.asarray(probs), jnp.asarray(wn)))


# ---------------------------------------------------------------------------
# The walkthrough twin
# ---------------------------------------------------------------------------

def test_walkthrough_twin_prints_the_reference_numbers(capsys):
    """The reference walkthrough's printed numbers (run in this process)
    against the twin's on the CPU: the CE residuals and TVs within 1e-12,
    1-sparsity at every step, the counterexample's TV of 0.5."""
    import runpy
    from pathlib import Path
    runpy.run_path(str(Path(__file__).resolve().parents[1] / "examples"
                       / "theory_walkthrough.py"), run_name="__main__")
    ref = capsys.readouterr().out
    lines = []
    got = theory_walkthrough.run("cpu", log=lines.append)
    assert len(got["ce"]) == 3 and all(got["one_sparse"])
    assert max(got["ce"]) <= TOL and got["tv_chain"] <= TOL
    assert got["ce_counterexample"] <= TOL
    assert got["tv_counterexample"] == pytest.approx(0.5, abs=TOL)
    assert got["tv_decoded"] <= TOL
    ref_lines, our_lines = ref.splitlines(), "\n".join(lines).splitlines()
    assert len(ref_lines) == len(our_lines)
    for r, o in zip(ref_lines, our_lines):
        if "=" not in r:
            assert r == o
    assert "TV(pushed, p1)=0.500" in "\n".join(our_lines)
