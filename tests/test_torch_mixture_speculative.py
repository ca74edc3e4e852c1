"""Speculation under the port's Eq. 27 mixture against the JAX reference,
dense family (the float32 ``qwen3_8b`` smoke config, 3 experts carried
across from the reference's pytrees by ``repro_torch.weights``,
``RouterConfig(top_k=2)``), with greedy and seeded-sampled requests in
the same traffic.

The whole slice: with ``speculative="ngram"`` (host drafts) and
``"expert"`` (expert 0 drafts on the device), in paged + chunked and
paged + monolithic serving, the port emits exactly the reference
``MixtureSlotServer``'s tokens, finish reasons (stop, length and
truncated among them) and speculation counters; within the port,
speculation on ≡ off exactly, for greedy and sampled requests. A sampled
request's tokens do not depend on its slot or on the traffic beside it;
``spec_len=1`` is vanilla; a pool that cannot cover a span falls back to
vanilla steps; a stop lands at every span offset. The stacked verify
makes one paged-verify launch per attention layer for all K·B rows, and
expert drafting in place leaves the pool's live blocks (everything but
scratch block 0) as an n-gram step given the same drafts does, for a slot
whose span runs past its context too. A request routed with weight
≥ 0.99 on expert 0 accepts expert drafts. The hybrid family is not
``speculative_capable``: its mixture with ``speculative`` set serves the
same tokens as without.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_smoke_config as jax_smoke  # noqa: E402
from repro.core.router import CentroidRouter as JaxRouter  # noqa: E402
from repro.core.router import RouterConfig as JaxRouterConfig  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.serve import api as japi  # noqa: E402
from repro.serve.scheduler import make_engine as jax_make_engine  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import ensemble  # noqa: E402
from repro_torch.core.router import CentroidRouter, RouterConfig  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serve.api import EngineConfig, SamplingParams  # noqa: E402
from repro_torch.serve.scheduler import make_engine  # noqa: E402
from repro_torch.weights import from_tree  # noqa: E402

ARCH = "qwen3_8b"
K, FEAT, CACHE_LEN, BLOCK, SPEC_LEN = 3, 16, 40, 8, 4
# three prompt widths (each monolithic width is one reference trace);
# request 4 runs to the end of the context (30 + 12 > 40: truncated, its
# last spans reach past the table horizon)
LENS = [6, 13, 6, 13, 30, 13]
CONFIGS = {"paged-chunked": dict(paged=True, page_block=BLOCK,
                                 chunked_prefill=True, chunk=BLOCK),
           "paged-monolithic": dict(paged=True, page_block=BLOCK)}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def dep():
    jm = jax_build(jax_smoke(ARCH))
    jexperts = [jm.init(jax.random.PRNGKey(k)) for k in range(K)]
    texperts = [from_tree(jax.tree.map(np.asarray, p)) for p in jexperts]
    rng = np.random.default_rng(3)
    cent = rng.normal(size=(K, FEAT)).astype(np.float32)
    prompts = [rng.integers(0, 512, n).astype(np.int32) for n in LENS]
    feats = rng.normal(size=(len(LENS), FEAT)).astype(np.float32)
    feats[5] = cent[0]           # routed ≥ 0.99 onto expert 0
    return dict(jm=jm, jexperts=jexperts, texperts=texperts, cent=cent,
                prompts=prompts, feats=feats)


SAMPLED = {1: 0, 3: 40, 4: 0}          # rid → top_k; the rest are greedy


def params(i, sp_cls, stops=(), max_new=12):
    samp = dict(temperature=0.7, top_k=SAMPLED[i], seed=1000 + i) \
        if i in SAMPLED else {}
    return sp_cls(max_new=max_new, stop_token_ids=stops, **samp)


def drive(engine, sp_cls, dep, stops=None, rids=None):
    stops = stops or {}
    for i in (range(len(LENS)) if rids is None else rids):
        engine.add_request(dep["prompts"][i],
                           params(i, sp_cls, stops.get(i, ())),
                           features=dep["feats"][i], rid=i)
    res = {}
    while engine.has_unfinished():
        for o in engine.step():
            if o.finished:
                res[o.rid] = (o.token_ids, o.finish_reason)
    return res


def port_engine(dep, kind="paged-chunked", arch=ARCH, experts=None, **over):
    return make_engine(
        build_model(get_smoke_config(arch)),
        experts=experts or dep["texperts"],
        router=CentroidRouter(torch.as_tensor(dep["cent"]),
                              RouterConfig(top_k=2)),
        config=EngineConfig(**{"n_slots": 2, "cache_len": CACHE_LEN,
                               "strategy": "mixture", "spec_len": SPEC_LEN,
                               **CONFIGS[kind], **over}),
        device="cpu")


def spec_counts(engine):
    st = engine.core.stats()
    return st.get("spec_steps", 0), st.get("spec_tokens", 0)


@pytest.fixture(scope="module")
def free(dep):
    """A vanilla paged + chunked run of every request, no stop ids."""
    return drive(port_engine(dep), SamplingParams, dep)


@pytest.fixture(scope="module")
def stops(free):
    """Stop ids that requests 1 (sampled) and 2 (greedy) generate
    mid-stream."""
    return {1: (free[1][0][5],), 2: (free[2][0][2],)}


@pytest.fixture(scope="module")
def vanilla(dep, stops):
    return {kind: drive(port_engine(dep, kind), SamplingParams, dep, stops)
            for kind in CONFIGS}


# ---------------------------------------------------------------------------
# The whole slice against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", list(CONFIGS))
@pytest.mark.parametrize("drafter", ["ngram", "expert"])
def test_mixture_speculation_matches_reference(dep, stops, vanilla, kind,
                                               drafter):
    eng = port_engine(dep, kind, speculative=drafter)
    got = drive(eng, SamplingParams, dep, stops)
    jeng = jax_make_engine(
        dep["jm"], experts=dep["jexperts"],
        router=JaxRouter(jnp.asarray(dep["cent"]), JaxRouterConfig(top_k=2)),
        config=japi.EngineConfig(n_slots=2, cache_len=CACHE_LEN,
                                 strategy="mixture", speculative=drafter,
                                 spec_len=SPEC_LEN, **CONFIGS[kind]))
    want = drive(jeng, japi.SamplingParams, dep, stops)
    assert got == want
    assert got == vanilla[kind]                 # speculation on ≡ off
    assert {r for _, r in got.values()} == {"stop", "length", "truncated"}
    jst = jeng.core.stats()
    steps, toks = spec_counts(eng)
    assert (steps, toks) == (jst["spec_steps"], jst["spec_tokens"])
    assert steps > 0
    assert eng.core.allocator.n_free == eng.core.allocator.n_blocks - 1


# ---------------------------------------------------------------------------
# The port's own invariants
# ---------------------------------------------------------------------------

def test_sampled_tokens_independent_of_slot_and_traffic(dep, free):
    """Each sampled request served alone (slot 0) gives the tokens it gave
    beside the others, in whichever slot it had there; with speculation
    too."""
    for drafter in (None, "expert"):
        for i in SAMPLED:
            alone = drive(port_engine(dep, speculative=drafter),
                          SamplingParams, dep, rids=[i])
            assert alone[i] == free[i]
    # two sampled requests swap slots and keep their tokens
    fwd = drive(port_engine(dep), SamplingParams, dep, rids=[1, 3])
    rev = drive(port_engine(dep), SamplingParams, dep, rids=[3, 1])
    assert fwd == rev


def test_spec_len_one_is_vanilla(dep, stops, vanilla):
    eng = port_engine(dep, speculative="expert", spec_len=1)
    assert drive(eng, SamplingParams, dep, stops) == vanilla["paged-chunked"]
    assert not eng.core._can_spec and spec_counts(eng) == (0, 0)


def test_pool_pressure_falls_back_to_vanilla(dep):
    """One slot over 3 usable blocks: a request of at most 24 positions
    grows through them with vanilla steps, but a span near its end reaches
    a fourth block the pool cannot give, so that step decodes one vanilla
    token; the tokens are unchanged."""
    over = dict(n_slots=1, pool_blocks=4)
    rids = [0, 1, 2, 5]
    want = drive(port_engine(dep, **over), SamplingParams, dep, rids=rids)
    eng = port_engine(dep, speculative="expert", **over)
    calls = {"vanilla": 0}
    run = eng.core._run_fused

    def counted(st):
        calls["vanilla"] += 1
        return run(st)
    eng.core._run_fused = counted
    assert drive(eng, SamplingParams, dep, rids=rids) == want
    assert calls["vanilla"] > 0 and spec_counts(eng)[0] > 0


@pytest.mark.parametrize("offset", range(SPEC_LEN))
def test_stop_at_every_span_offset(dep, offset):
    """Request 5 (weight ≥ 0.99 on expert 0) with oracle n-gram drafts —
    its own vanilla trajectory — accepts every span in full, so a stop
    lands at span offset ``offset``; expert drafting then stops at the
    same token."""
    traj = drive(port_engine(dep), SamplingParams, dep, rids=[5])[5][0]
    stop_id = traj[1 + offset]
    want = (traj[:traj.index(stop_id) + 1], "stop")
    stops = {5: (stop_id,)}
    eng = port_engine(dep, speculative="ngram")
    core = eng.core

    def oracle(dec):
        drafts = np.zeros((core.n_slots, SPEC_LEN - 1), np.int32)
        for s in dec:
            fut = traj[len(core.slot_req[s].out):][:SPEC_LEN - 1]
            drafts[s, :len(fut)] = fut
        return torch.as_tensor(drafts)
    core._draft_tokens = oracle
    assert drive(eng, SamplingParams, dep, stops, rids=[5])[5] == want
    assert core.stats()["stopped"] == 1
    eng = port_engine(dep, speculative="expert")
    assert drive(eng, SamplingParams, dep, stops, rids=[5])[5] == want


def test_expert_zero_drafts_are_accepted(dep):
    """Request 5 sits on expert 0's centroid: its weight on expert 0 is
    ≥ 0.99, expert 0's greedy drafts match the mixture's picks, and
    speculation emits more tokens than it takes steps."""
    eng = port_engine(dep, speculative="expert")
    assert eng.core._route(_req(dep, 5))[0] >= 0.99
    drive(eng, SamplingParams, dep, rids=[5])
    steps, toks = spec_counts(eng)
    assert toks > steps > 0


def _req(dep, i):
    from repro_torch.serve.scheduler import Request
    return Request(i, dep["prompts"][i], 12, features=dep["feats"][i])


def _decoding_core(dep, rids):
    """A mixture core with ``rids`` admitted and decoding (paged +
    chunked, expert drafting), its state grown for one span."""
    eng = port_engine(dep, speculative="expert")
    core = eng.core
    for i in rids:
        eng.add_request(dep["prompts"][i], params(i, SamplingParams),
                        features=dep["feats"][i], rid=i)
    while core.waiting or core.prefill_order:
        eng.step()
    assert core.decoding and core._grow_active_span(SPEC_LEN)
    core._step_span = SPEC_LEN
    return core, core._device_state()


def _live(cache):
    return {n: leaf[:, :, 1:].clone() for n, leaf in cache.items()}


def test_expert_drafting_in_place_equals_ngram_given_its_drafts(dep):
    """One speculative step: expert 0 drafting in the real pool leaves the
    live blocks, tokens and state of the n-gram step given the drafts that
    expert 0 computes on a copy of its pool slice (the reference's way).
    Request 4's prompt of 30 tokens is advanced to position 38, so its
    drafts write positions 38..40, past the table horizon at 40."""
    core, st = _decoding_core(dep, [4, 1])
    slot4 = [s for s in core.decoding if core.slot_req[s].rid == 4][0]
    core._can_spec = False           # one position a step up to 38
    while core.pos[slot4] < CACHE_LEN - 2:
        core.step()
    core._can_spec = True
    assert core.slot_req[slot4].rid == 4
    assert core._grow_active_span(SPEC_LEN)
    core._step_span = SPEC_LEN
    st = core._device_state()
    # drafts the reference's way: expert 0 on a copy of its pool slice
    model, sp = core.model, core.stacked
    draft_c = {n: leaf.select(1, 0).clone() for n, leaf in core.cache.items()}
    p0 = ensemble.expert_slice(sp, 0)
    tables = torch.nn.functional.pad(st["tables"], (0, 1))
    tok, drafts = st["tok"], []
    for j in range(SPEC_LEN - 1):
        logits, _ = model.decode_step_paged(p0, draft_c, tok, st["pos"] + j,
                                            tables)
        tok = logits.argmax(-1).to(torch.int32)
        drafts.append(tok)
    drafts = torch.stack(drafts, dim=1)
    runs = []
    for d in (None, drafts):
        cache = {n: leaf.clone() for n, leaf in core.cache.items()}
        cache, new, toks, n_emit, done = core._vstep(sp, cache, dict(st), d)
        runs.append((_live(cache), new, toks, n_emit, done))
    (ca, na, *oa), (cb, nb, *ob) = runs
    for n in ca:
        assert torch.equal(ca[n], cb[n]), n
    for a, b in zip(oa, ob):
        assert torch.equal(a, b)
    for k in ("tok", "pos", "counts", "active"):
        assert torch.equal(na[k], nb[k])


def test_stacked_verify_is_one_launch_per_layer(dep, monkeypatch):
    """The stacked verify runs ``paged_verify_attention`` once per
    attention layer on all K·B rows (no loop over experts), and expert
    drafting runs paged decode L − 1 times per layer on B rows."""
    core, st = _decoding_core(dep, [0, 2])
    calls = {"verify": [], "decode": []}
    for name, kind in (("paged_verify_attention", "verify"),
                       ("paged_decode_attention", "decode")):
        fn = getattr(ops, name)

        def counted(q, *a, fn=fn, kind=kind, **kw):
            calls[kind].append(q.shape[0])
            return fn(q, *a, **kw)
        monkeypatch.setattr(ops, name, counted)
    layers = core.model.n_groups
    core._vstep(core.stacked, core.cache, st, None)
    assert calls["verify"] == [K * core.n_slots] * layers
    assert calls["decode"] == [core.n_slots] * layers * (SPEC_LEN - 1)


def test_hybrid_mixture_with_speculation_is_vanilla(dep):
    """Zamba2 (hybrid) cannot roll a span back: its mixture with
    ``speculative`` set serves the same tokens, greedy and sampled, and
    never verifies."""
    model = build_model(get_smoke_config("zamba2_2_7b"))
    experts = [model.init(torch.Generator().manual_seed(k))
               for k in range(K)]
    res = []
    for spec in (None, "expert", "ngram"):
        eng = port_engine(dep, arch="zamba2_2_7b", experts=experts,
                          speculative=spec, chunk=16)
        res.append(drive(eng, SamplingParams, dep, rids=[0, 1, 4]))
        assert not eng.core._can_spec and spec_counts(eng) == (0, 0)
    assert res[0] == res[1] == res[2]


def test_profile_script_rehearses_mixture_speculation_on_cpu():
    """``launch/profile_serve.py --mixture --speculative --smoke --device
    cpu``: the mixture's decode-only steps verify spans drafted by expert
    0, in a window of their own."""
    from repro_torch.launch import profile_serve
    rep = profile_serve.main(["--smoke", "--device", "cpu", "--mixture",
                              "--speculative"])
    kinds = rep["steps_by_kind"]
    assert rep["strategy"] == "mixture"
    assert sum(kinds.values()) == rep["steps"]
    assert kinds["spec_verify"] > 0 and kinds["decode"] == 0
    assert rep["windows"]["spec_verify"]["kinds"] == \
        ["spec_verify"] * profile_serve.WINDOW
