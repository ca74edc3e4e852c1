"""The port's moe family against the JAX reference: ``models/moe.py`` and
the family's ``Model``, on the float32 smoke configs of DeepSeek-MoE-16B
(4 routed experts, top-2, one shared expert) and Qwen3-MoE-235B-A22B (4
routed, top-2, no shared, qk-norm), with weights carried across from the
reference's pytrees by ``repro_torch.weights``.

Routing: ``route_topk`` gives the reference's choices and weights,
planted ties included (the first index wins; the choices come out in
descending order), in float32 and bf16. ``_capacity`` is the reference's
formula. ``moe_ffn`` matches the reference's within rtol 1e-5 and 1e-5 of
the output's largest magnitude (measured 5e-7 of it: the same float32
products, the combine summed in another order) at the smoke configs'
capacity factor 8.0, where nothing is dropped, and at 1.0, where the test
asserts that pairs are dropped, so the port drops the reference's pairs.
``load_balance_stats`` matches within 1e-6.

The rank fault: ``moe_ffn`` takes the size of a decentralized expert
stack from its caller (``n_stacked(params)``), never from a weight's rank.
Over a stack of two models' layers, (2, E, D, Fe) routed weights and rows
(2·B, S, D) expert-major, it gives each model's own call (at cf 1.0, so
drops are per row); and the stacked model's chunked prefill, paged decode
and span verify give each expert's own steps, within 1e-5.

Training: ``Model.forward`` logits, ``loss`` and every gradient leaf
against ``jax.grad`` for both configs at cf 8.0 and 1.0
(``test_torch_vlm.check_loss_and_grads``: the loss to 1e-5 relative,
each leaf within 5e-4 of its largest element).

The launchers: ``repro_torch.launch.train --arch deepseek_moe_16b`` trains
a 2-expert run, which the port's serving launcher serves with the
reference's serving launcher's tokens.
"""
import re
from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_vlm import check_loss_and_grads  # noqa: E402

from repro.configs.base import get_smoke_config as jax_smoke  # noqa: E402
from repro.launch import serve as jax_launch_serve  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import ensemble  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import build_model, moe  # noqa: E402
from repro_torch.models.model import layer_slice, n_stacked  # noqa: E402
from repro_torch.weights import from_tree  # noqa: E402

ARCHS = ["deepseek_moe_16b", "qwen3_moe_235b_a22b"]
CFS = [8.0, 1.0]           # the smoke configs' own, and one that drops
FFN_TOL = 1e-5             # rtol, and atol of the largest magnitude


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def with_cf(cfg, cf):
    """``cfg`` (either package's) at capacity factor ``cf``."""
    return replace(cfg, moe=replace(cfg.moe, capacity_factor=cf))


def configs(arch, cf):
    return (with_cf(jax_smoke(arch), cf), with_cf(get_smoke_config(arch), cf))


@pytest.fixture(scope="module", params=ARCHS)
def dep(request):
    arch = request.param
    jm = jax_build(jax_smoke(arch))
    jexperts = [jm.init(jax.random.PRNGKey(k)) for k in range(2)]
    return dict(arch=arch, jexperts=jexperts, texperts=[
        from_tree(jax.tree.map(np.asarray, p)) for p in jexperts])


def layer_moe(params, i=0):
    return layer_slice(params["blocks"]["moe"], i)


def rows(seed, R=3, S=13, D=128):
    return np.random.default_rng(seed).normal(size=(R, S, D)) \
        .astype(np.float32)


# ---------------------------------------------------------------------------
# Routing and capacity
# ---------------------------------------------------------------------------

def _tied_logits():
    """(6, 8) float32 logits whose rows plant ties: among the top choices,
    across the top-k boundary, and a row all equal."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(6, 8)).astype(np.float32)
    x[0, [1, 4, 6]] = 2.5                   # three-way tie at the top
    x[1, [0, 7]] = x[1].max() + 1           # the first and the last index
    x[2, [2, 3, 5]] = -0.25                 # a tie at the top-3 boundary
    x[2, [0, 1, 4, 6, 7]] = -1.0
    x[3] = 0.5                              # all equal
    x[4, [5, 6]] = x[4].max()               # a tie with the row's maximum
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("top_k", [1, 3, 8])
def test_route_topk_matches_reference_with_ties(dtype, top_k):
    logits = _tied_logits()
    jl = jnp.asarray(logits).astype(dtype)
    tl = torch.as_tensor(logits).to(getattr(torch, dtype))
    jw, jidx = jmoe.route_topk(jl, top_k)
    w, idx = moe.route_topk(tl, top_k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert w.dtype == tl.dtype
    np.testing.assert_allclose(w.float().numpy(),
                               np.asarray(jw.astype(jnp.float32)),
                               rtol=1e-6 if dtype == "float32" else 0,
                               atol=1e-7)
    # ties go to the first index, in descending order
    assert idx[0, :min(top_k, 3)].tolist() == [1, 4, 6][:top_k]
    assert idx[3].tolist() == list(range(top_k))
    if top_k == 3:
        assert idx[2].tolist() == [2, 3, 5]


@pytest.mark.parametrize("n,E,top_k,cf", [
    (128, 8, 2, 1.0), (1, 64, 6, 1.25), (256, 64, 6, 1.25),
    (256, 128, 8, 1.25), (4096, 64, 6, 1.25), (13, 4, 2, 1.0),
    (13, 4, 2, 8.0), (4, 4, 2, 1.0), (3, 5, 2, 0.5)])
def test_capacity_matches_reference(n, E, top_k, cf):
    assert moe._capacity(n, E, top_k, cf) == jmoe._capacity(n, E, top_k, cf)


@pytest.mark.parametrize("cf", CFS)
def test_moe_ffn_matches_reference(dep, cf):
    jcfg, tcfg = configs(dep["arch"], cf)
    x = rows(7)
    jp = jax.tree.map(lambda a: a[0], dep["jexperts"][0]["blocks"]["moe"])
    want = np.asarray(jmoe.moe_ffn(jp, jnp.asarray(x), jcfg))
    p = layer_moe(dep["texperts"][0])
    got = moe.moe_ffn(p, torch.as_tensor(x), tcfg).numpy()
    np.testing.assert_allclose(got, want, rtol=FFN_TOL,
                               atol=FFN_TOL * np.abs(want).max())
    _, idx = moe.route_topk(torch.as_tensor(x) @ p["router"],
                            tcfg.moe.top_k)
    C = moe._capacity(x.shape[1], tcfg.moe.n_experts, tcfg.moe.top_k, cf)
    _, keep = moe.capacity_slots(idx, C, tcfg.moe.n_experts)
    assert bool(keep.all()) == (cf == 8.0)       # cf 1.0 drops pairs


def test_load_balance_stats_matches_reference():
    rng = np.random.default_rng(9)
    for logits in (np.tile(np.arange(8, dtype=np.float32), (32, 1)),
                   rng.normal(size=(4096, 8)).astype(np.float32),
                   _tied_logits()):
        want = jmoe.load_balance_stats(jnp.asarray(logits), 2)
        got = moe.load_balance_stats(torch.as_tensor(logits), 2)
        for key in ("load_entropy", "max_load"):
            assert float(got[key]) == pytest.approx(float(want[key]),
                                                    rel=1e-6, abs=1e-7)


# ---------------------------------------------------------------------------
# The rank fault: an expert stack is told by the caller, not by rank
# ---------------------------------------------------------------------------

def test_moe_ffn_over_a_stack_equals_each_experts_call(dep):
    _, tcfg = configs(dep["arch"], 1.0)
    stacked = ensemble.stack_experts_for_decode(dep["texperts"])
    p = layer_moe(stacked)
    assert p["w_gate"].shape[:2] == (2, tcfg.moe.n_experts)
    assert p["router"].dim() == 3 and n_stacked(stacked) == 2
    x = [rows(11), rows(12)]
    got = moe.moe_ffn(p, torch.as_tensor(np.concatenate(x)), tcfg, stack=2)
    for k in range(2):
        one = moe.moe_ffn(layer_moe(dep["texperts"][k]),
                          torch.as_tensor(x[k]), tcfg)
        torch.testing.assert_close(got[3 * k:3 * k + 3], one, rtol=1e-5,
                                   atol=1e-5 * float(one.abs().max()))


def test_stacked_moe_steps_equal_each_experts_steps(dep):
    """Chunked prefill (two 8-row chunks of a 13-token prompt), a paged
    decode step and a 3-position span verify of the stack against each
    expert's own, at cf 1.0."""
    _, tcfg = configs(dep["arch"], 1.0)
    model = build_model(tcfg)
    block, chunk, cache_len = 8, 8, 32
    nb = cache_len // block
    prompt = torch.as_tensor(np.random.default_rng(4).integers(
        0, tcfg.vocab, (1, 16)))
    prompt[:, 13:] = 0
    table = torch.arange(1, nb + 1, dtype=torch.int32)
    tok = torch.tensor([5], dtype=torch.int32)
    pos = torch.tensor([13], dtype=torch.int32)
    span = torch.tensor([[5, 9, 2]], dtype=torch.int32)

    def steps(params, K):
        pool = model.init_paged_cache(1, nb + 1, block, cache_len,
                                      device="cpu", experts=K)
        x = model.embed_prompt(params, {"tokens": prompt})
        carry = model.init_chunk_carry(params, {"tokens": prompt}, cache_len)
        out = []
        for start in (0, 8):
            logits, carry, pool = model.prefill_chunk(
                params, pool, carry, x[:, start:start + chunk], start,
                min(chunk, 13 - start), table)
            out.append(logits)
        out.append(model.decode_step_paged(params, pool, tok, pos,
                                           table[None])[0])
        out.append(model.verify_step_paged(params, pool, span, pos,
                                           table[None])[0])
        return out

    stacked = ensemble.stack_experts_for_decode(dep["texperts"])
    together = steps(stacked, 2)
    for k, params in enumerate(dep["texperts"]):
        for single, both in zip(steps(params, 0), together):
            torch.testing.assert_close(single, both[k], rtol=1e-5,
                                       atol=1e-5)


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cf", CFS)
def test_forward_loss_and_gradients_match_reference(dep, cf):
    jcfg, tcfg = configs(dep["arch"], cf)
    jm, model = jax_build(jcfg), build_model(tcfg)
    jp, tp = dep["jexperts"][0], dep["texperts"][0]
    toks = np.random.default_rng(5).integers(0, tcfg.vocab, (2, 16)) \
        .astype(np.int32)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)}
    tb = {"tokens": torch.as_tensor(toks), "labels": torch.as_tensor(toks)}
    want = np.asarray(jm.forward(jp, jb))
    np.testing.assert_allclose(model.forward(tp, tb).detach().numpy(), want,
                               rtol=1e-5, atol=1e-5 * np.abs(want).max())
    _, grads, _ = check_loss_and_grads(jm, jp, model, tp, jb, tb)
    assert np.abs(grads["blocks/moe/router"]).max() > 0
    assert np.abs(grads["blocks/moe/w_down"]).max() > 0


# ---------------------------------------------------------------------------
# The launchers
# ---------------------------------------------------------------------------

def test_launchers_train_and_serve_moe(tmp_path, capsys, monkeypatch):
    """``--arch deepseek_moe_16b`` through both port launchers; the
    reference's serving launcher gives the port's tokens on that run."""
    run_dir = str(tmp_path)
    arch = "deepseek_moe_16b"
    report = launch_train.main(["--arch", arch, "--steps", "1", "--seq-len",
                                "16", "--batch", "4", "--samples", "64",
                                "--out", run_dir, "--device", "cpu"])
    assert [e["expert"] for e in report["experts"]] == [0, 1]
    base = ["--run", run_dir, "--arch", arch, "--requests", "3",
            "--prompt-len", "10", "--new-tokens", "5", "--slots", "2"]
    got = launch_serve.main(base + ["--device", "cpu"])
    assert got["finish_reasons"] == ["length"] * 3
    capsys.readouterr()
    monkeypatch.setattr("sys.argv", ["serve"] + base + ["--stream"])
    jax_launch_serve.main()
    want = {}
    for rid, toks in re.findall(r"rid=\s*(\d+) \+(\[[^\]]*\])",
                                capsys.readouterr().out):
        want.setdefault(int(rid), []).extend(eval(toks))
    assert got["tokens"] == want and len(want) == 3


def test_drop_tally_counts_each_calls_pairs_by_width(dep):
    """With ``moe.DROP_TALLY`` set, each call adds its kept and routed
    pairs under its group width, as ``capacity_slots`` counts them; unset,
    nothing is kept."""
    _, tcfg = configs(dep["arch"], 1.0)
    p = layer_moe(dep["texperts"][0])
    x = torch.as_tensor(rows(13))
    _, idx = moe.route_topk(x @ p["router"], tcfg.moe.top_k)
    C = moe._capacity(13, tcfg.moe.n_experts, tcfg.moe.top_k, 1.0)
    kept = int(moe.capacity_slots(idx, C, tcfg.moe.n_experts)[1].sum())
    moe.DROP_TALLY = {}
    try:
        for _ in range(2):
            moe.moe_ffn(p, x, tcfg)
        moe.moe_ffn(p, x[:, :1], tcfg)
        tally = {S: (int(k), n) for S, (k, n) in moe.DROP_TALLY.items()}
    finally:
        moe.DROP_TALLY = None
    pairs = x.shape[0] * 13 * tcfg.moe.top_k
    assert tally == {13: (2 * kept, 2 * pairs),
                     1: (3 * tcfg.moe.top_k, 3 * tcfg.moe.top_k)}
    assert kept < pairs
