"""The port's seeded sampling against ``jax.random`` 0.9.0 and
``repro.serve.fused``.

The PRNG (``repro_torch.core.prng``) is bit-exact: raw keys of
``PRNGKey(seed)`` for seeds 0, 1, 2³¹, 2³² − 1 and a negative seed
wrapped to uint32 (``seed & 0xFFFFFFFF``, as the reference's schedulers
wrap it), ``fold_in`` keys, the 32-bit words for a (V,) shape (the
partitionable threefry layout, ``jax_threefry_partitionable`` on), the
float32 uniforms, and Threefry-2x32 itself on the Random123 known-answer
vector. The Gumbel noise ``-log(-log(u))`` takes two float32 logs, and
XLA's CPU log differs from torch's in the last ulp on ~14% of inputs, so
the noise is held within 1e-6 (measured ≤ 4.8e-7).

A sampled token is the argmax of noise plus scaled scores, so it can
differ only where the two largest entries are within an ulp or two of
each other. Measured over 8192 draws (V = 256, temperatures 0.5–1.5,
top-k 0, 17, 64, 300): 0 tokens differ. The bound asserted below over
4096 draws: at most 1 differs, and a differing draw's reference margin
(``fused.sample_margin``) is within ``MARGIN_ULPS`` ulps of its top
value. Every other comparison here — greedy rows, top_k = 1, the
first-token pick, the decode epilogue, the seeded verify epilogue at
every span offset with a stop, a budget and the context end, with and
without ``from_probs`` — is exact on its inputs.

The whole top-1 slice with sampling: 2 expert pods, paged + chunked,
n-gram speculation on, greedy and sampled requests side by side, gives
exactly the reference engine's tokens, finish reasons and spec counters,
and exactly the port's own tokens with speculation off. The launcher twin
serves ``--strategy mixture --speculative expert`` with a sampled slot
(``--slot-temperature``, ``--slot-top-k``) with the reference launcher's
streamed tokens.
"""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax._src import prng as jax_prng  # noqa: E402

from repro.checkpoint import ckpt as jckpt  # noqa: E402
from repro.configs.base import get_smoke_config as jax_smoke  # noqa: E402
from repro.core.router import CentroidRouter as JaxRouter  # noqa: E402
from repro.launch import serve as jax_launch_serve  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.serve import api as japi  # noqa: E402
from repro.serve import fused as jfused  # noqa: E402
from repro.serve.scheduler import make_engine as jax_make_engine  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core.router import CentroidRouter  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serve import fused  # noqa: E402
from repro_torch.serve.api import EngineConfig, SamplingParams  # noqa: E402
from repro_torch.serve.scheduler import make_engine  # noqa: E402
from repro_torch.weights import from_tree  # noqa: E402

SEEDS = [0, 1, 2**31, 2**32 - 1, -7 & 0xFFFFFFFF]
COUNTS = [0, 1, 13, 2**31 - 1]
V = 1001
MARGIN_ULPS = 4
L = 4


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _key(k):
    return [int(k[0]), int(k[1])]


# ---------------------------------------------------------------------------
# The PRNG, bit for bit
# ---------------------------------------------------------------------------

def test_threefry_known_answer_and_random_counters():
    """The Random123 known-answer vector, and random keys and counters
    against ``jax._src.prng.threefry_2x32``."""
    t = lambda v: torch.tensor(v, dtype=torch.int64)  # noqa: E731
    y = prng.threefry2x32((t(0x13198A2E), t(0x03707344)), t(0x243F6A88),
                          t(0x85A308D3))
    assert [int(v) for v in y] == [0xC4923A9C, 0x483DF7A0]
    rng = np.random.default_rng(3)
    key = rng.integers(0, 2**32, 2, dtype=np.uint64).astype(np.uint32)
    cnt = rng.integers(0, 2**32, 64, dtype=np.uint64).astype(np.uint32)
    want = np.asarray(jax_prng.threefry_2x32(jnp.asarray(key),
                                             jnp.asarray(cnt)))
    x0, x1 = np.split(cnt.astype(np.int64), 2)
    y0, y1 = prng.threefry2x32(tuple(t(int(k)) for k in key),
                               torch.as_tensor(x0), torch.as_tensor(x1))
    got = torch.cat([y0, y1]).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_bits_and_uniforms_are_bit_exact(seed):
    key = jax.random.PRNGKey(jnp.uint32(seed))
    tkey = prng.threefry_seed(torch.tensor([seed]))
    assert _key([k[0] for k in tkey]) == np.asarray(key).tolist()
    counts = torch.tensor(COUNTS, dtype=torch.int32)
    folded = prng.fold_in(tkey, counts)
    bits = prng.random_bits(folded, V)
    unif = prng.uniform(bits)
    noise = prng.gumbel(bits)
    for i, c in enumerate(COUNTS):
        jk = jax.random.fold_in(key, jnp.int32(c))
        assert _key([k[i] for k in folded]) == np.asarray(jk).tolist()
        jb = np.asarray(jax.random.bits(jk, (V,), jnp.uint32))
        np.testing.assert_array_equal(bits[i].numpy(), jb.astype(np.int64))
        ju = np.asarray(jax.random.uniform(
            jk, (V,), jnp.float32, minval=np.finfo(np.float32).tiny,
            maxval=1.0))
        np.testing.assert_array_equal(unif[i].numpy().view(np.int32),
                                      ju.view(np.int32))
        jg = np.asarray(jax.random.gumbel(jk, (V,), jnp.float32))
        np.testing.assert_allclose(noise[i].numpy(), jg, rtol=0, atol=1e-6)


def test_int64_seed_key_matches_prng_key():
    """A seed past 32 bits keeps its high word, as ``PRNGKey`` of an
    int64 does."""
    seed = (5 << 32) | 9
    assert _key([k[0] for k in prng.threefry_seed(torch.tensor([seed]))]) \
        == np.asarray(jax.random.PRNGKey(np.int64(seed))).tolist()


# ---------------------------------------------------------------------------
# _sample_tokens and its probability form
# ---------------------------------------------------------------------------

def _rows(rng, B, Vs, *, temps=None, top_ks=None):
    scores = (rng.normal(size=(B, Vs)) * 3).astype(np.float32)
    temps = rng.choice([0.5, 0.7, 1.0, 1.5], B).astype(np.float32) \
        if temps is None else np.asarray(temps, np.float32)
    top_ks = rng.choice([0, 17, 64, 300], B).astype(np.int32) \
        if top_ks is None else np.asarray(top_ks, np.int32)
    seeds = rng.integers(0, 2**32, B, dtype=np.uint64).astype(np.uint32)
    counts = rng.integers(0, 2**31 - 1, B).astype(np.int32)
    return scores, temps, top_ks, seeds, counts


def _both(fn_t, fn_j, scores, temps, top_ks, seeds, counts):
    got = fn_t(torch.as_tensor(scores), torch.as_tensor(temps),
               torch.as_tensor(top_ks),
               torch.as_tensor(seeds.astype(np.int64)),
               torch.as_tensor(counts))
    want = fn_j(jnp.asarray(scores), jnp.asarray(temps),
                jnp.asarray(top_ks), jnp.asarray(seeds),
                jnp.asarray(counts))
    assert got.dtype == torch.int32
    return got.numpy(), np.asarray(want)


def test_sampled_tokens_differ_only_within_the_stated_bound():
    """4096 seeded draws against the reference: at most one differs, and
    only at a near-tie (module docstring)."""
    rng = np.random.default_rng(0)
    args = _rows(rng, 4096, 256)
    got, want = _both(fused._sample_tokens, jfused._sample_tokens, *args)
    differ = np.nonzero(got != want)[0]
    assert len(differ) <= 1
    if len(differ):
        targs = [torch.as_tensor(a[differ].astype(
            np.int64 if a.dtype == np.uint32 else a.dtype)) for a in args]
        margin = fused.sample_margin(*targs).numpy()
        top = np.abs(args[0][differ]).max(-1) / args[1][differ] + 16
        assert (margin <= MARGIN_ULPS * np.spacing(top.astype(np.float32))
                ).all()


@pytest.mark.parametrize("case", ["greedy_mixed", "top_k_edges", "ties",
                                  "probs"])
def test_sample_tokens_match_reference(case):
    rng = np.random.default_rng(len(case))
    B, Vs = 64, 40
    if case == "greedy_mixed":        # temps <= 0 rows take the argmax
        args = _rows(rng, B, Vs, temps=rng.choice([-1.0, 0.0, 0.8], B))
    elif case == "top_k_edges":       # 0, 1, below V, above V
        args = _rows(rng, B, Vs, top_ks=rng.choice([0, 1, 7, Vs + 9], B))
    else:
        args = _rows(rng, B, Vs, top_ks=rng.choice([1, 3, 5], B))
    scores = args[0]
    if case == "ties":                # every score tied at the threshold
        scores = np.round(scores).astype(np.float32)
        assert all(len(np.unique(r)) < Vs for r in scores)
    if case == "probs":
        p = np.exp(scores - scores.max(-1, keepdims=True))
        p /= p.sum(-1, keepdims=True)
        p[:, :3] = 0.0                # below the floor: ties at the floor
        got, want = _both(fused._sample_tokens_probs,
                          jfused._sample_tokens_probs,
                          p.astype(np.float32), *args[1:])
    else:
        got, want = _both(fused._sample_tokens, jfused._sample_tokens,
                          scores, *args[1:])
    np.testing.assert_array_equal(got, want)
    greedy = args[1] <= 0
    if case == "top_k_edges":
        greedy |= args[2] == 1        # top_k = 1 is exactly greedy
    if greedy.any():
        base = scores if case != "probs" else np.log(np.maximum(
            p, fused.PROB_FLOOR))
        np.testing.assert_array_equal(got[greedy],
                                      base[greedy].argmax(-1))


@pytest.mark.parametrize("from_probs", [False, True])
@pytest.mark.parametrize("temp", [0.0, 0.9])
def test_pick_first_matches_reference(from_probs, temp):
    rng = np.random.default_rng(5)
    row = rng.normal(size=(1, 50)).astype(np.float32)
    if from_probs:
        row = np.exp(row) / np.exp(row).sum()
    for seed in SEEDS:
        jargs = (jnp.asarray([temp], jnp.float32), jnp.asarray([9], jnp.int32),
                 jnp.asarray([seed], jnp.uint32))
        want = np.asarray(jfused.pick_first(jnp.asarray(row), *jargs,
                                            from_probs=from_probs))
        targs = () if temp <= 0 else (
            torch.tensor([temp]), torch.tensor([9], dtype=torch.int32),
            torch.tensor([seed], dtype=torch.int64))
        got = fused.pick_first(torch.as_tensor(row), *targs,
                               from_probs=from_probs)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# The epilogues
# ---------------------------------------------------------------------------

def _state(rng, B, Vs):
    temps = np.array([0.8, 0.0, 1.3, 0.6][:B], np.float32)
    return {"tok": rng.integers(0, Vs, B).astype(np.int32),
            "pos": np.full(B, 10, np.int32),
            "active": np.ones(B, bool),
            "temps": temps,
            "top_ks": np.array([0, 0, 5, 1][:B], np.int32),
            "seeds": np.array([3, 4, 2**32 - 1, 2**31][:B], np.uint32),
            "counts": np.full(B, 3, np.int32),
            "max_new": np.full(B, 100, np.int32),
            "stop_ids": np.full((B, 2), -1, np.int32)}


def _port_state(st):
    out = {k: torch.as_tensor(v.astype(np.int64) if k == "seeds" else v)
           for k, v in st.items()}
    out["sampled"] = bool((st["temps"] > 0).any())
    return out


@pytest.mark.parametrize("from_probs", [False, True])
def test_sampled_decode_epilogue_matches_reference(from_probs):
    rng = np.random.default_rng(1)
    B, Vs = 4, 64
    st = _state(rng, B, Vs)
    st["active"][3] = False
    st["stop_ids"][0, 0] = 7
    scores = rng.normal(size=(B, Vs)).astype(np.float32)
    if from_probs:
        scores = np.exp(scores) / np.exp(scores).sum(-1, keepdims=True)
    new, nxt, done = fused.decode_epilogue(
        torch.as_tensor(scores), _port_state(st), cache_len=40,
        from_probs=from_probs)
    jnew, jnxt, jdone = jfused.decode_epilogue(
        jnp.asarray(scores), {k: jnp.asarray(v) for k, v in st.items()},
        cache_len=40, from_probs=from_probs)
    np.testing.assert_array_equal(nxt.numpy(), np.asarray(jnxt))
    np.testing.assert_array_equal(done.numpy(), np.asarray(jdone))
    for k in ("tok", "pos", "counts", "active"):
        np.testing.assert_array_equal(new[k].numpy(), np.asarray(jnew[k]))


def _verify_case(case, offset, from_probs):
    """A sampled verify span (B = 4, L = 4, V = 32) whose drafts follow the
    reference's seeded trajectory (count c0 + j at offset j) unless the
    case says otherwise."""
    rng = np.random.default_rng(offset + 11 * len(case))
    B, Vs = 4, 32
    st = _state(rng, B, Vs)
    scores = rng.normal(size=(B, L, Vs)).astype(np.float32)
    if from_probs:
        scores = np.exp(scores) / np.exp(scores).sum(-1, keepdims=True)
    log = np.log(np.maximum(scores, fused.PROB_FLOOR)) if from_probs \
        else scores
    true = np.stack([np.asarray(jfused._sample_tokens(
        jnp.asarray(log[:, j]), jnp.asarray(st["temps"]),
        jnp.asarray(st["top_ks"]), jnp.asarray(st["seeds"]),
        jnp.asarray(st["counts"] + j))) for j in range(L)], axis=1)
    drafts = true[:, :L - 1].astype(np.int32)
    if case == "accept_reject":
        drafts[1] = (true[1, :L - 1] + 1) % Vs          # all reject
        drafts[2, 1] = (true[2, 1] + 1) % Vs            # accept 1 of 3
    elif case == "stop":
        st["stop_ids"][:, 0] = true[:, offset]
    elif case == "length":
        st["max_new"][:] = st["counts"] + 1 + offset
    elif case == "truncated":
        st["pos"][:] = 40 - 1 - offset                  # cache_len 40
        st["pos"][1] = 5
    return scores, drafts, st, true


@pytest.mark.parametrize("from_probs", [False, True])
@pytest.mark.parametrize("case,offset", [
    ("accept_reject", 0),
    *[(c, j) for c in ("stop", "length", "truncated") for j in range(L)]])
def test_seeded_verify_epilogue_matches_reference(case, offset, from_probs):
    scores, drafts, st, true = _verify_case(case, offset, from_probs)
    new, toks, n_emit, done = fused.verify_epilogue(
        torch.as_tensor(scores), torch.as_tensor(drafts), _port_state(st),
        cache_len=40, from_probs=from_probs)
    jnew, jtoks, jn, jdone = jfused.verify_epilogue(
        jnp.asarray(scores), jnp.asarray(drafts),
        {k: jnp.asarray(v) for k, v in st.items()}, cache_len=40,
        from_probs=from_probs)
    for got, want in ((toks, jtoks), (n_emit, jn), (done, jdone),
                      *((new[k], jnew[k]) for k in
                        ("tok", "pos", "counts", "active"))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(toks.numpy(), true)
    if case == "accept_reject":
        assert n_emit.tolist() == [L, 1, 2, L]
    if case in ("stop", "length", "truncated"):
        assert done[0].item() == {"stop": 1, "length": 2,
                                  "truncated": 3}[case]


def test_greedy_epilogues_draw_no_random_bits(monkeypatch):
    """An all-greedy state (``sampled`` False, or absent) takes the argmax
    epilogue: no threefry pass runs, and the tokens are the argmax."""
    def refuse(*a, **k):
        raise AssertionError("a greedy step drew random bits")
    monkeypatch.setattr(prng, "threefry2x32", refuse)
    rng = np.random.default_rng(2)
    st = _port_state(_state(rng, 4, 16))
    st["sampled"] = False
    scores = torch.as_tensor(rng.normal(size=(4, L, 16)).astype(np.float32))
    _, nxt, _ = fused.decode_epilogue(scores[:, 0], st, cache_len=40)
    np.testing.assert_array_equal(nxt.numpy(), scores[:, 0].argmax(-1))
    drafts = scores[:, :L - 1].argmax(-1).to(torch.int32)
    _, toks, n_emit, _ = fused.verify_epilogue(scores, drafts, st,
                                               cache_len=40)
    np.testing.assert_array_equal(toks.numpy(), scores.argmax(-1))
    assert n_emit.tolist() == [L] * 4
    assert fused.pick_first(scores[:1, 0]).tolist() == \
        [int(scores[0, 0].argmax())]


# ---------------------------------------------------------------------------
# The whole top-1 slice, sampled, and the launcher twin
# ---------------------------------------------------------------------------

ECFG = dict(n_slots=2, cache_len=40, paged=True, page_block=8,
            chunked_prefill=True, chunk=8)
LENS = [7, 11, 5, 9, 13, 30]            # 30 + 12 passes cache_len


def _drive(engine, sp_cls, prompts, feats):
    """Requests 1, 2, 4 and 5 sample (top_k 0, 1, 40 and 0; seed 77 + i
    wrapped from a negative one for request 5), the rest are greedy."""
    samp = {1: 0, 2: 1, 4: 40, 5: 0}
    for i, p in enumerate(prompts):
        kw = dict(temperature=0.8, top_k=samp[i],
                  seed=77 + i if i != 5 else -77) if i in samp else {}
        engine.add_request(p, sp_cls(max_new=12, **kw), features=feats[i],
                           rid=i)
    res = {}
    while engine.has_unfinished():
        for o in engine.step():
            if o.finished:
                res[o.rid] = (o.token_ids, o.finish_reason)
    return res


def test_top1_sampled_slice_matches_reference():
    jm = jax_build(jax_smoke("qwen3_8b"))
    jexperts = [jm.init(jax.random.PRNGKey(k)) for k in (0, 1)]
    texperts = [from_tree(jax.tree.map(np.asarray, p)) for p in jexperts]
    rng = np.random.default_rng(4)
    cent = rng.normal(size=(2, 32)).astype(np.float32)
    prompts = [np.tile(rng.integers(1, 512, 4), n // 4 + 1)[:n]
               .astype(np.int32) for n in LENS]       # n-gram friendly
    feats = rng.normal(size=(len(LENS), 32)).astype(np.float32)

    def port(**over):
        return make_engine(build_model(get_smoke_config("qwen3_8b")),
                           experts=texperts,
                           router=CentroidRouter(torch.as_tensor(cent)),
                           config=EngineConfig(**ECFG, **over), device="cpu")
    eng = port(speculative="ngram")
    got = _drive(eng, SamplingParams, prompts, feats)
    jeng = jax_make_engine(jm, experts=jexperts,
                           router=JaxRouter(jnp.asarray(cent)),
                           config=japi.EngineConfig(**ECFG,
                                                    speculative="ngram"))
    assert got == _drive(jeng, japi.SamplingParams, prompts, feats)
    assert got == _drive(port(), SamplingParams, prompts, feats)
    assert {r for _, r in got.values()} == {"length", "truncated"}
    counts = [(p.stats()["spec_steps"], p.stats()["spec_tokens"])
              for p in eng.pods]
    assert counts == [(p.stats()["spec_steps"], p.stats()["spec_tokens"])
                      for p in jeng.pods]
    assert sum(t for _, t in counts) > sum(s for s, _ in counts) > 0


def test_launcher_twin_serves_expert_drafts_and_a_sampled_slot(
        tmp_path, capsys, monkeypatch):
    jm = jax_build(jax_smoke("qwen3_8b").reduced(vocab=256))
    for k in range(2):
        jckpt.save_expert(str(tmp_path), k, 1,
                          {"params": jm.init(jax.random.PRNGKey(k))})
    jckpt.save_router(str(tmp_path), np.random.default_rng(0).normal(
        size=(2, 32)).astype(np.float32), 10.0, 1)
    args = ["--run", str(tmp_path), "--requests", "3", "--prompt-len", "10",
            "--new-tokens", "8", "--slots", "2", "--vocab", "256",
            "--paged", "--page-block", "8", "--chunked-prefill",
            "--prefill-chunk", "8", "--strategy", "mixture", "--top-k", "2",
            "--speculative", "expert", "--slot-temperature", "0.8",
            "--slot-top-k", "20", "--seed", "5"]
    monkeypatch.setattr("sys.argv", ["serve"] + args + ["--stream"])
    jax_launch_serve.main()
    want = {}
    for rid, toks in re.findall(r"rid=\s*(\d+) \+(\[[^\]]*\])",
                                capsys.readouterr().out):
        want.setdefault(int(rid), []).extend(eval(toks))
    report = launch_serve.main(args + ["--device", "cpu"])
    assert report["tokens"] == want and len(want) == 3
    assert report["spec"]["spec_steps"] > 0
