"""The CUDA kernels against their plain PyTorch versions, on the card.

They have no CPU mode, so every test here is marked ``gpu`` and skips
without a card. This file imports neither JAX nor ``repro``, so it runs on
a machine that has only the port's dependencies:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_cuda.py

(``--noconftest`` skips ``tests/conftest.py``, which configures JAX.)
Tolerances: float32 5e-5 (summation order and the blocked online
softmax), bf16 2e-2 (the plain version rounds the softmax weights to bf16
before the PV product, as ``repro/kernels/ref.py`` does). ``chunk_scan``
computes in float32 from its inputs' values on both sides (on its bf16
tensor-core route the float32 P and decayed K reach the tensor cores as
three bf16 parts that sum to them), so it is held at 5e-5 in both dtypes.
The bf16 tensor-core chunk-prefill,
verify and decode kernels are also held at 8e-3 against the plain version
run in float32 on the same bf16 values (``chip_smoke.py``'s tolerance):
there the kernel's error is its own rounding of P and of the output.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import chunk_scan as cs  # noqa: E402
from repro_torch.kernels import decode_attention as dk  # noqa: E402
from repro_torch.kernels import flash_attention as fk  # noqa: E402
from repro_torch.kernels import flash_attention_bwd as fbk  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import router_scores as rk  # noqa: E402


def f32(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def paged_inputs(seed, B, NB, block, H, KV, dh, pos, unallocated):
    rng = np.random.default_rng(seed)
    P = B * NB + 3
    q, kp, vp = f32(rng, B, H, dh), f32(rng, P, block, KV, dh), \
        f32(rng, P, block, KV, dh)
    bt = rng.permutation(np.arange(1, P))[:B * NB].reshape(B, NB) \
        .astype(np.int32)
    pos = np.asarray(pos, np.int32)
    if unallocated:                       # past-horizon entries → scratch 0
        bt = np.where(np.arange(NB)[None, :] <= pos[:, None] // block, bt,
                      0).astype(np.int32)
    return q, kp, vp, pos, bt


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("window", [0, 64])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 5e-5),
                                       (torch.bfloat16, 2e-2)])
def test_paged_decode_kernel_on_card(cuda, window, dtype, tol):
    q, kp, vp, pos, bt = paged_inputs(5, 3, 4, 16, 8, 2, 64,
                                      pos=(3, 63, 200 if window else 50),
                                      unallocated=not window)
    args = [torch.as_tensor(a, device=cuda) for a in (q, kp, vp)]
    args = [a.to(dtype) for a in args] + [torch.as_tensor(a, device=cuda)
                                          for a in (pos, bt)]
    got = dk.paged_decode_attention(*args, window=window)
    want = dk.paged_decode_attention_ref(*args, window=window)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 5e-5),
                                       (torch.bfloat16, 2e-2)])
def test_chunk_prefill_kernel_on_card(cuda, dtype, tol):
    rng = np.random.default_rng(6)
    q = torch.as_tensor(f32(rng, 20, 8, 64), device=cuda).to(dtype)
    kp = torch.as_tensor(f32(rng, 9, 8, 2, 64), device=cuda).to(dtype)
    vp = torch.as_tensor(f32(rng, 9, 8, 2, 64), device=cuda).to(dtype)
    bt = torch.tensor([4, 2, 7, 1, 8, 0], dtype=torch.int32, device=cuda)
    got = dk.chunk_prefill_attention(q, kp, vp, 19, bt)
    want = dk.chunk_prefill_attention_ref(q, kp, vp, 19, bt)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("B,C,NB,block,H,KV,dh,start", [
    (2, 40, 8, 16, 32, 8, 128, 60),       # Qwen3-8B heads, an expert pair
    (2, 33, 8, 32, 32, 32, 80, 200),      # Zamba2's MHA heads
    (3, 100, 16, 8, 8, 2, 64, 20),        # two row tiles, block 8
])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 5e-5),
                                       (torch.bfloat16, 8e-3)])
def test_batched_chunk_prefill_on_card(cuda, B, C, NB, block, H, KV, dh,
                                       start, dtype, tol):
    """B chunks at one start, each through its own table row (an expert
    stack's chunk step): against the plain version in float32 on the same
    values, and each batch row exactly the unbatched launch of its own."""
    rng = np.random.default_rng(B * C)
    P = B * NB + 1
    q, kp, vp = (torch.as_tensor(a, device=cuda).to(dtype) for a in (
        f32(rng, B, C, H, dh), f32(rng, P, block, KV, dh),
        f32(rng, P, block, KV, dh)))
    bt = torch.as_tensor(rng.permutation(np.arange(1, P))[:B * NB]
                         .reshape(B, NB).astype(np.int32), device=cuda)
    got = dk.chunk_prefill_attention(q, kp, vp, start, bt)
    want = dk.chunk_prefill_attention_ref(q.float(), kp.float(), vp.float(),
                                          start, bt)
    torch.testing.assert_close(got.float(), want, rtol=tol, atol=tol)
    for b in range(B):
        torch.testing.assert_close(
            got[b], dk.chunk_prefill_attention(q[b].contiguous(), kp, vp,
                                               start, bt[b].contiguous()),
            rtol=0, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("H,KV,dh", [(8, 2, 128), (4, 4, 80)])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 5e-5),
                                       (torch.bfloat16, 8e-3)])
def test_paged_decode_under_expert_table_offsets_on_card(cuda, H, KV, dh,
                                                         dtype, tol):
    """Paged decode as a stacked decode step launches it: 2 experts' pools
    viewed as one pool of 2·P pages, each slot's shared table offset by
    k·P for expert k (``Model._expert_tables``; scratch entries land on
    page k·P), 2·B rows in one launch, against the plain version in
    float32 on the same values."""
    from repro_torch.models.model import Model
    K, pos = 2, (0, 31, 63)
    q0, kp0, vp0, pos, bt = paged_inputs(21, 3, 4, 16, H, KV, dh, pos=pos,
                                         unallocated=True)
    q1, kp1, vp1, _, _ = paged_inputs(22, 3, 4, 16, H, KV, dh, pos=pos,
                                      unallocated=True)
    q, kp, vp = (torch.as_tensor(np.stack(a), device=cuda).to(dtype)
                 for a in ((q0, q1), (kp0, kp1), (vp0, vp1)))
    tables = Model._expert_tables(torch.as_tensor(bt, device=cuda), kp[None],
                                  K)
    args = (q.flatten(0, 1), kp.flatten(0, 1), vp.flatten(0, 1),
            torch.as_tensor(pos, device=cuda).repeat(K), tables)
    launched = dk.paged_decode_attention.launches
    got = dk.paged_decode_attention(*args)
    assert dk.paged_decode_attention.launches == launched + 1
    want = dk.paged_decode_attention_ref(*(a.float() if a.is_floating_point()
                                           else a for a in args))
    torch.testing.assert_close(got.float(), want, rtol=tol, atol=tol)


@pytest.mark.gpu
def test_mixture_serves_as_on_the_cpu_with_one_launch_a_layer(cuda):
    """The smoke-size float32 Qwen3 mixture (3 experts, top_k 2, paged +
    chunked) on the card gives the CPU's tokens and finish reasons, and
    each stacked decode step launches paged decode once per attention
    layer, not once per expert."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.router import CentroidRouter, RouterConfig
    from repro_torch.models import build_model
    from repro_torch.serve.api import EngineConfig, SamplingParams
    from repro_torch.serve.scheduler import make_engine

    cfg = get_smoke_config("qwen3_8b")
    model = build_model(cfg)
    experts = [model.init(torch.Generator().manual_seed(k)) for k in range(3)]
    rng = np.random.default_rng(1)
    router = CentroidRouter(torch.as_tensor(f32(rng, 3, 16)),
                            RouterConfig(top_k=2))
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
               for n in (5, 19, 30, 8)]
    feats = f32(rng, 4, 16)
    ecfg = EngineConfig(n_slots=2, cache_len=48, paged=True, page_block=8,
                        chunked_prefill=True, chunk=8, strategy="mixture")
    res, steps = [], []
    for dev in ("cpu", "cuda"):
        eng = make_engine(model, experts=experts, router=router, config=ecfg,
                          device=dev)
        core, n = eng.core, [0]
        for name in ("_fstep", "_fstep_chunk"):
            def counted(*a, _fn=getattr(core, name)):
                n[0] += 1
                return _fn(*a)
            setattr(core, name, counted)
        ops.reset_launch_counts()
        for i, p in enumerate(prompts):
            eng.add_request(p, SamplingParams(max_new=10), features=feats[i],
                            rid=i)
        out = {}
        while eng.has_unfinished():
            for o in eng.step():
                if o.finished:
                    out[o.rid] = (o.token_ids, o.finish_reason)
        res.append(out)
        steps.append(n[0])
    assert res[0] == res[1] and len(res[1]) == 4
    assert dk.paged_decode_attention.launches == steps[1] * cfg.n_layers


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 5e-5),
                                       (torch.bfloat16, 8e-3)])
def test_paged_verify_under_expert_table_offsets_on_card(cuda, dtype, tol):
    """Paged verify as the mixture's stacked verify launches it: 2 experts'
    pools viewed as one pool of 2·P pages, each slot's shared table offset
    by k·P (``Model._expert_tables``), 2·B span rows of L = 4 in one
    launch, against the plain version in float32 on the same values."""
    from repro_torch.models.model import Model
    K, B, NB, block, L, H, KV, dh = 2, 3, 4, 16, 4, 8, 2, 128
    rng = np.random.default_rng(23)
    P = B * NB + 1
    q = f32(rng, K * B, L, H, dh)
    kp, vp = f32(rng, K, P, block, KV, dh), f32(rng, K, P, block, KV, dh)
    bt = rng.permutation(np.arange(1, P))[:B * NB].reshape(B, NB) \
        .astype(np.int32)
    pos = np.array([0, 27, NB * block - L], np.int32)
    q, kp, vp = (torch.as_tensor(a, device=cuda).to(dtype)
                 for a in (q, kp, vp))
    tables = Model._expert_tables(torch.as_tensor(bt, device=cuda), kp[None],
                                  K)
    args = (q, kp.flatten(0, 1), vp.flatten(0, 1),
            torch.as_tensor(pos, device=cuda).repeat(K), tables)
    launched = dk.paged_verify_attention.launches
    got = dk.paged_verify_attention(*args)
    assert dk.paged_verify_attention.launches == launched + 1
    want = dk.paged_verify_attention_ref(*(a.float() if a.is_floating_point()
                                           else a for a in args))
    torch.testing.assert_close(got.float(), want, rtol=tol, atol=tol)


@pytest.mark.gpu
def test_sampling_bits_on_card_equal_the_cpu(cuda):
    """Seeded sampling's threefry keys, 32-bit words and float32 uniforms
    at Qwen3-8B's vocabulary are the CPU's bit for bit; the Gumbel noise
    within 1e-6 (two float32 logs)."""
    from repro_torch.core import prng
    V = 151936
    seeds = torch.tensor([0, 7, 2**31, 2**32 - 1])
    counts = torch.tensor([0, 31, 5, 2**31 - 1], dtype=torch.int32)
    out = []
    for dev in ("cpu", cuda):
        key = prng.fold_in(prng.threefry_seed(seeds.to(dev)), counts.to(dev))
        bits = prng.random_bits(key, V)
        out.append([t.cpu() for t in (*key, bits, prng.uniform(bits),
                                      prng.gumbel(bits))])
    host, card = out
    for a, b in zip(host[:3], card[:3]):
        assert torch.equal(a, b)
    assert torch.equal(host[3].view(torch.int32), card[3].view(torch.int32))
    torch.testing.assert_close(card[4], host[4], rtol=0, atol=1e-6)


@pytest.mark.gpu
def test_mixture_speculation_serves_as_on_the_cpu(cuda):
    """The smoke-size float32 Qwen3 mixture (3 experts, top_k 2, paged +
    chunked) with expert drafting, greedy and sampled requests side by
    side, gives the CPU's tokens, finish reasons and spec counters; each
    stacked verify step launches paged verify once per attention layer."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.router import CentroidRouter, RouterConfig
    from repro_torch.models import build_model
    from repro_torch.serve.api import EngineConfig, SamplingParams
    from repro_torch.serve.scheduler import make_engine

    cfg = get_smoke_config("qwen3_8b")
    model = build_model(cfg)
    experts = [model.init(torch.Generator().manual_seed(k)) for k in range(3)]
    rng = np.random.default_rng(2)
    router = CentroidRouter(torch.as_tensor(f32(rng, 3, 16)),
                            RouterConfig(top_k=2))
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
               for n in (5, 19, 30, 8)]
    feats = f32(rng, 4, 16)
    ecfg = EngineConfig(n_slots=2, cache_len=48, paged=True, page_block=8,
                        chunked_prefill=True, chunk=8, strategy="mixture",
                        speculative="expert", spec_len=4)
    res, verifies = [], []
    for dev in ("cpu", "cuda"):
        eng = make_engine(model, experts=experts, router=router, config=ecfg,
                          device=dev)
        core, n = eng.core, [0]

        def counted(*a, _fn=core._vstep):
            n[0] += 1
            return _fn(*a)
        core._vstep = counted
        ops.reset_launch_counts()
        for i, p in enumerate(prompts):
            eng.add_request(p, SamplingParams(
                max_new=10, temperature=0.7 * (i % 2), top_k=20 * (i % 2),
                seed=40 + i), features=feats[i], rid=i)
        out = {}
        while eng.has_unfinished():
            for o in eng.step():
                if o.finished:
                    out[o.rid] = (o.token_ids, o.finish_reason)
        st = core.stats()
        res.append((out, st["spec_steps"], st["spec_tokens"]))
        verifies.append(n[0])
    assert res[0] == res[1] and len(res[1][0]) == 4
    assert verifies[1] > 0
    assert dk.paged_verify_attention.launches == verifies[1] * cfg.n_layers


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,KV,dh,causal,window", [
    (2, 77, 8, 2, 64, True, 0),        # ragged S, GQA 4:1
    (2, 96, 8, 2, 64, False, 0),       # not causal
    (2, 70, 8, 2, 64, True, 20),       # window across key tiles
    (1, 200, 4, 1, 128, True, 0),      # MQA
    (2, 64, 4, 4, 32, True, 16),       # window inside one key tile
    (1, 100, 6, 2, 40, True, 0),       # dh 40, a group of 3
])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 5e-5),
                                       (torch.bfloat16, 2e-2)])
def test_flash_attention_kernel_on_card(cuda, B, S, H, KV, dh, causal,
                                        window, dtype, tol):
    """Ragged S (no whole key tile at the end), GQA and MQA, windows, dh
    down to 40; out and lse."""
    rng = np.random.default_rng(7)
    q, k, v = (torch.as_tensor(f32(rng, B, S, h, dh), device=cuda).to(dtype)
               for h in (H, KV, KV))
    got, got_lse = fk.flash_attention_with_lse(q, k, v, causal=causal,
                                               window=window)
    want, want_lse = fk.flash_attention_with_lse_ref(q, k, v, causal=causal,
                                                     window=window)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(got_lse, want_lse, rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("window,pos", [(0, (0, 63, 99)), (100, (5, 100, 400))])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 5e-5),
                                       (torch.bfloat16, 2e-2)])
def test_contiguous_decode_kernel_on_card(cuda, window, pos, dtype, tol):
    """S = 100 (a ragged last key tile), MQA; with a window the rows are
    rings, wrapped and not."""
    rng = np.random.default_rng(8)
    q = torch.as_tensor(f32(rng, 3, 4, 64), device=cuda).to(dtype)
    k, v = (torch.as_tensor(f32(rng, 3, 100, 1, 64), device=cuda).to(dtype)
            for _ in range(2))
    p = torch.tensor(pos, dtype=torch.int32, device=cuda)
    got = dk.decode_attention(q, k, v, p, window=window)
    want = dk.decode_attention_ref(q, k, v, p, window=window)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("L,H,KV,pos", [
    (4, 8, 2, (3, 47, 16)),          # GQA 4:1, one row tile, block boundary
    (8, 8, 2, (0, 40, 20)),          # 32 rows: two row tiles
    (4, 4, 4, (62, 63, 61)),         # MHA, spans past the table horizon
])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 5e-5),
                                       (torch.bfloat16, 2e-2)])
def test_paged_verify_kernel_on_card(cuda, L, H, KV, pos, dtype, tol):
    """Every row against the plain version; each slot's table is full, so
    no row reads the scratch block."""
    rng = np.random.default_rng(9)
    B, NB, block, dh = 3, 4, 16, 64
    P = B * NB + 1
    q = torch.as_tensor(f32(rng, B, L, H, dh), device=cuda).to(dtype)
    kp, vp = (torch.as_tensor(f32(rng, P, block, KV, dh), device=cuda)
              .to(dtype) for _ in range(2))
    bt = torch.as_tensor(rng.permutation(np.arange(1, P)).reshape(B, NB)
                         .astype(np.int32), device=cuda)
    p = torch.tensor(pos, dtype=torch.int32, device=cuda)
    got = dk.paged_verify_attention(q, kp, vp, p, bt)
    want = dk.paged_verify_attention_ref(q, kp, vp, p, bt)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


BF16_TOL = 8e-3


def verify_inputs(seed, B, NB, block, L, H, KV, dh, pos, idle=(),
                  tail=True):
    """Span queries, pools, pos and tables as the scheduler leaves them:
    ``idle`` slots at pos 0 with zeroed tables; with ``tail`` the entries
    past a slot's span horizon (pos + L - 1) // block point at scratch 0."""
    rng = np.random.default_rng(seed)
    P = B * NB + 1
    q = f32(rng, B, L, H, dh)
    kp, vp = f32(rng, P, block, KV, dh), f32(rng, P, block, KV, dh)
    bt = rng.permutation(np.arange(1, P)).reshape(B, NB).astype(np.int32)
    pos = np.asarray(pos, np.int32)
    for b in idle:
        pos[b], bt[b] = 0, 0
    if tail:
        bt = np.where(np.arange(NB)[None, :] <= (pos[:, None] + L - 1)
                      // block, bt, 0).astype(np.int32)
    return q, kp, vp, pos, bt


def bf16_on(cuda, *arrays):
    """The float arrays as bf16 on the card, the int arrays as they are."""
    return [torch.as_tensor(a, device=cuda).to(torch.bfloat16)
            if a.dtype == np.float32 else torch.as_tensor(a, device=cuda)
            for a in arrays]


def up(*ts):
    return [t.float() if t.is_floating_point() else t for t in ts]


@pytest.mark.gpu
@pytest.mark.parametrize("C,NB,block,H,KV,dh,start", [
    (8, 4, 16, 4, 4, 64, 0),          # MHA, first chunk
    (6, 8, 8, 8, 2, 64, 34),          # block 8, straddles a block
    (16, 4, 32, 4, 1, 128, 112),      # block 32, ends at capacity
    (40, 8, 16, 64, 1, 64, 50),       # MQA, a group of 64 rows
    (100, 16, 8, 8, 2, 64, 20),       # ragged C over two row tiles
    (77, 4, 64, 8, 2, 128, 150),      # block 64
    (50, 2, 128, 8, 2, 64, 100),      # block 128: 64 rows of one page
    (33, 8, 32, 32, 32, 80, 200),     # Zamba2's heads (dh 80, group 1)
    (30, 8, 16, 6, 2, 40, 70),        # dh 40, a group of 3 (pad rows)
])
def test_chunk_prefill_tensor_core_on_card(cuda, C, NB, block, H, KV, dh,
                                           start):
    """bf16 chunk prefill on the tensor cores against the plain version in
    float32 on the same values."""
    rng = np.random.default_rng(10)
    P = NB + 3
    q, kp, vp = bf16_on(cuda, f32(rng, C, H, dh), f32(rng, P, block, KV, dh),
                        f32(rng, P, block, KV, dh))
    bt = torch.as_tensor(rng.permutation(np.arange(1, P))[:NB]
                         .astype(np.int32), device=cuda)
    got = dk.chunk_prefill_attention(q, kp, vp, start, bt)
    want = dk.chunk_prefill_attention_ref(*up(q, kp, vp), start, bt)
    torch.testing.assert_close(got.float(), want, rtol=BF16_TOL,
                               atol=BF16_TOL)


VERIFY_CASES = [
    # B, NB, block, L, H, KV, dh, pos, idle, tail
    (2, 4, 16, 4, 4, 4, 64, (5, 40), (), True),           # MHA
    (2, 4, 32, 4, 4, 1, 128, (100, 7), (), True),         # MQA, block 32
    (3, 8, 16, 2, 8, 2, 64, (0, 63, 100), (), True),      # L = 2
    (2, 8, 16, 8, 32, 2, 64, (10, 120), (), True),        # 128 rows: 2 tiles
    (3, 4, 16, 4, 8, 2, 64, (62, 63, 61), (), False),     # past the horizon
    (4, 4, 16, 4, 8, 2, 64, (30, 0, 45, 0), (1, 3), True),  # idle slots
    (3, 64, 16, 4, 8, 2, 64, (510, 511, 900), (), True),  # masked splits
    (2, 100, 16, 4, 8, 2, 64, (1500, 700), (), True),     # 4 splits
    (2, 16, 8, 4, 8, 2, 64, (60, 100), (), True),         # block 8
    (2, 4, 64, 4, 8, 2, 64, (130, 250), (), True),        # block 64
    (2, 4, 128, 4, 8, 2, 64, (300, 505), (), True),       # block 128
    (2, 8, 16, 4, 64, 1, 64, (50, 100), (), True),        # MQA, group 64
    (2, 8, 16, 4, 32, 32, 80, (20, 100), (), True),       # Zamba2's heads
    (2, 8, 16, 4, 6, 2, 40, (33, 90), (), True),          # dh 40, group 3
]


@pytest.mark.gpu
@pytest.mark.parametrize("B,NB,block,L,H,KV,dh,pos,idle,tail", VERIFY_CASES)
def test_paged_verify_tensor_core_on_card(cuda, B, NB, block, L, H, KV, dh,
                                          pos, idle, tail):
    """bf16 verify on the tensor cores (split over key ranges where the
    table is long enough) against the plain version in float32 on the same
    values, and row j against paged decode's plain version at pos + j."""
    q, kp, vp, p, bt = bf16_on(cuda, *verify_inputs(11, B, NB, block, L, H,
                                                    KV, dh, pos, idle, tail))
    got = dk.paged_verify_attention(q, kp, vp, p, bt).float()
    qf, kf, vf = up(q, kp, vp)
    torch.testing.assert_close(
        got, dk.paged_verify_attention_ref(qf, kf, vf, p, bt),
        rtol=BF16_TOL, atol=BF16_TOL)
    for j in range(L):
        torch.testing.assert_close(
            got[:, j], dk.paged_decode_attention_ref(
                qf[:, j].contiguous(), kf, vf, p + j, bt),
            rtol=BF16_TOL, atol=BF16_TOL)


DECODE_CASES = [
    # B, NB, block, H, KV, dh, pos, window, idle
    (3, 8, 16, 8, 2, 64, (0, 64, 127), 0, ()),          # pos 0, capacity - 1
    (2, 4, 32, 4, 4, 64, (5, 127), 0, ()),              # MHA, block 32
    (1, 4, 64, 4, 1, 128, (200,), 0, ()),               # MQA, block 64
    (2, 16, 8, 16, 2, 64, (60, 127), 0, ()),            # block 8, group 8
    (2, 2, 128, 8, 2, 64, (100, 255), 0, ()),           # block 128
    (2, 8, 16, 64, 1, 64, (50, 127), 0, ()),            # a group of 64
    (3, 8, 16, 32, 32, 80, (0, 70, 127), 0, ()),        # Zamba2's heads
    (4, 68, 16, 32, 8, 128, (0, 1087, 500, 0), 0, (0, 3)),  # idle slots
    (2, 4, 16, 4, 2, 64, (3, 60), 64, ()),              # ring, not wrapped
    (2, 100, 16, 8, 2, 64, (1599, 5000), 1600, ()),     # ring, far past
]


@pytest.mark.gpu
@pytest.mark.parametrize("B,NB,block,H,KV,dh,pos,window,idle", DECODE_CASES)
def test_paged_decode_split_key_on_card(cuda, B, NB, block, H, KV, dh, pos,
                                        window, idle):
    """bf16 paged decode on the split-key tensor-core kernel against the
    plain version in float32 on the same values."""
    q, kp, vp, p, bt = paged_inputs(13, B, NB, block, H, KV, dh, pos,
                                    unallocated=not window)
    for b in idle:
        p[b], bt[b] = 0, 0
    q, kp, vp, p, bt = bf16_on(cuda, q, kp, vp, p, bt)
    got = dk.paged_decode_attention(q, kp, vp, p, bt, window=window)
    torch.testing.assert_close(
        got.float(), dk.paged_decode_attention_ref(*up(q, kp, vp), p, bt,
                                                   window=window),
        rtol=BF16_TOL, atol=BF16_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,KV,dh,pos,window", [
    (3, 100, 8, 2, 64, (0, 63, 99), 0),        # ragged S, pos 0 and S - 1
    (2, 40, 8, 2, 64, (0, 39), 0),             # S < 64
    (2, 8, 4, 2, 64, (3, 20), 8),              # a ring shorter than a tile
    (2, 1000, 8, 2, 64, (999, 5000), 1000),    # ring, wrapped far past
    (2, 200, 64, 1, 64, (150, 199), 0),        # a group of 64
    (3, 1088, 32, 32, 80, (1087, 0, 600), 0),  # Zamba2's heads
    (2, 300, 4, 1, 128, (299, 17), 0),         # MQA, dh 128
])
def test_contiguous_decode_split_key_on_card(cuda, B, S, H, KV, dh, pos,
                                             window):
    """bf16 contiguous decode on the split-key tensor-core kernel against
    the plain version in float32 on the same values."""
    rng = np.random.default_rng(14)
    q, k, v = bf16_on(cuda, f32(rng, B, H, dh), f32(rng, B, S, KV, dh),
                      f32(rng, B, S, KV, dh))
    p = torch.tensor(pos, dtype=torch.int32, device=cuda)
    got = dk.decode_attention(q, k, v, p, window=window)
    torch.testing.assert_close(
        got.float(), dk.decode_attention_ref(*up(q, k, v), p, window=window),
        rtol=BF16_TOL, atol=BF16_TOL)


@pytest.mark.gpu
def test_paged_tensor_core_refuses_shapes_on_card(cuda):
    """A page block or head size the bf16 kernels do not take raises with
    the shape named, on the card as on the CPU: no other kernel runs it."""
    q, kp, vp, p, bt = bf16_on(cuda, *verify_inputs(12, 2, 8, 12, 4, 8, 2,
                                                    64, (5, 40)))
    launched = (dk.paged_verify_attention.launches,
                dk.chunk_prefill_attention.launches,
                dk.paged_decode_attention.launches,
                dk.decode_attention.launches)
    with pytest.raises(ValueError, match=r"k \(17, 12, 2, 64\)"):
        dk.paged_verify_attention(q, kp, vp, p, bt)
    with pytest.raises(ValueError, match=r"k \(17, 12, 2, 64\)"):
        dk.chunk_prefill_attention(q[0], kp, vp, 0, bt[0])
    with pytest.raises(ValueError, match=r"k \(17, 12, 2, 64\)"):
        dk.paged_decode_attention(q[:, 0].contiguous(), kp, vp, p, bt)
    rng = np.random.default_rng(15)
    q, k, v = bf16_on(cuda, f32(rng, 2, 8, 36), f32(rng, 2, 50, 2, 36),
                      f32(rng, 2, 50, 2, 36))
    with pytest.raises(ValueError, match=r"k \(2, 50, 2, 36\)"):
        dk.decode_attention(q, k, v, p)
    assert (dk.paged_verify_attention.launches,
            dk.chunk_prefill_attention.launches,
            dk.paged_decode_attention.launches,
            dk.decode_attention.launches) == launched


@pytest.mark.gpu
def test_router_kernel_on_card(cuda):
    x = torch.randn(37, 48, device=cuda)
    c = torch.randn(5, 48, device=cuda)
    torch.testing.assert_close(rk.router_scores(x, c, 10.0),
                               rk.router_scores_ref(x, c, 10.0),
                               rtol=5e-5, atol=5e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("B,D,K,dtype,offset", [
    (1, 32, 2, torch.float32, 0),          # one warp, 16-byte loads
    (16, 32, 2, torch.float32, 0),         # 4 rows a warp
    (5, 32, 2, torch.float32, 0),          # rows past B in a warp
    (6, 32, 12, torch.float32, 0),         # more centroids than a row's lanes
    (40, 4, 3, torch.float32, 0),          # a lane a row, 32 rows a warp
    (65536, 32, 2, torch.float32, 0),
    (100, 64, 6, torch.float32, 0),
    (9, 64, 6, torch.bfloat16, 0),         # 8 bf16 a load
    (5, 33, 3, torch.float32, 0),          # D not a multiple: scalar loads
    (5, 32, 2, torch.float32, 1),          # unaligned rows: scalar loads
    (12, 8192, 8, torch.float32, 0),       # K·D past 48 KB: 6 slabs of D
    (3, 5000, 4, torch.bfloat16, 0),       # slabs, bf16
    (7, 64, 9, torch.float32, 0),          # a second chunk of centroids
    (5, 96, 40, torch.float32, 0),         # more centroids than lanes
])
def test_router_kernel_launch_plans_on_card(cuda, B, D, K, dtype, offset):
    """Each launch plan of ``router_plan`` (warps a block, lanes a row,
    slabs, vector width) against the plain version, float32 at 5e-5, bf16
    at one bf16 ulp of a probability (8e-3)."""
    gen = torch.Generator(device=cuda).manual_seed(B + D)
    flat = torch.randn(B * D + offset, generator=gen, device=cuda)
    x = flat[offset:].view(B, D).to(dtype)
    c = torch.randn((K, D), generator=gen, device=cuda).to(dtype)
    tol = 5e-5 if dtype == torch.float32 else 8e-3
    torch.testing.assert_close(rk.router_scores(x, c, 10.0).float(),
                               rk.router_scores_ref(x.float(), c.float(),
                                                    10.0),
                               rtol=tol, atol=tol)


# Zamba2's shared attention block: MHA (H = KV = 32) at dh = 80


def _on(cuda, dtype, *arrays):
    return [torch.as_tensor(a, device=cuda).to(dtype) for a in arrays]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 5e-5),
                                       (torch.bfloat16, 2e-2)])
def test_attention_kernels_at_zamba2_heads_on_card(cuda, dtype, tol):
    """Paged decode, chunk prefill, flash and contiguous decode at H = KV =
    32, dh = 80 (ragged and block-edge positions)."""
    H = KV = 32
    dh = 80
    q, kp, vp, pos, bt = paged_inputs(10, 3, 4, 16, H, KV, dh,
                                      pos=(0, 31, 63), unallocated=True)
    args = _on(cuda, dtype, q, kp, vp) + [torch.as_tensor(a, device=cuda)
                                          for a in (pos, bt)]
    torch.testing.assert_close(dk.paged_decode_attention(*args).float(),
                               dk.paged_decode_attention_ref(*args).float(),
                               rtol=tol, atol=tol)
    rng = np.random.default_rng(11)
    q, kp, vp = _on(cuda, dtype, f32(rng, 20, H, dh),
                    f32(rng, 9, 16, KV, dh), f32(rng, 9, 16, KV, dh))
    bt = torch.tensor([4, 2, 7, 1], dtype=torch.int32, device=cuda)
    torch.testing.assert_close(
        dk.chunk_prefill_attention(q, kp, vp, 37, bt).float(),
        dk.chunk_prefill_attention_ref(q, kp, vp, 37, bt).float(),
        rtol=tol, atol=tol)
    q, k, v = _on(cuda, dtype, *(f32(rng, 1, 77, H, dh) for _ in range(3)))
    got, got_lse = fk.flash_attention_with_lse(q, k, v)
    want, want_lse = fk.flash_attention_with_lse_ref(q, k, v)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(got_lse, want_lse, rtol=tol, atol=tol)
    q = _on(cuda, dtype, f32(rng, 2, H, dh))[0]
    k, v = _on(cuda, dtype, f32(rng, 2, 100, KV, dh), f32(rng, 2, 100, KV, dh))
    p = torch.tensor([40, 99], dtype=torch.int32, device=cuda)
    torch.testing.assert_close(dk.decode_attention(q, k, v, p).float(),
                               dk.decode_attention_ref(q, k, v, p).float(),
                               rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("B,NC,L,H,dk,dv", [
    (1, 1, 256, 32, 64, 160),     # Zamba2's chunked-prefill shape
    (2, 2, 128, 2, 64, 65),       # odd dv, B > 1, NC > 1
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chunk_scan_kernel_on_card(cuda, B, NC, L, H, dk, dv, dtype):
    """Inputs scaled so q·k is of unit size; decays as
    ``tests/test_kernels.py``'s (cumulative sums of −|N|·0.1)."""
    rng = np.random.default_rng(12)
    s = dk ** -0.25
    qc, kc, vc = _on(cuda, dtype, f32(rng, B, NC, L, H, dk) * s,
                     f32(rng, B, NC, L, H, dk) * s, f32(rng, B, NC, L, H, dv))
    cum = torch.as_tensor(np.cumsum(-np.abs(f32(rng, B, NC, L, H)) * 0.1,
                                    axis=2), device=cuda)
    got = cs.chunk_scan(qc, kc, vc, cum)
    want = cs.chunk_scan_ref(qc, kc, vc, cum)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        torch.testing.assert_close(g, w, rtol=5e-5, atol=5e-5)


def _scan_inputs(cuda, dtype, seed, B, NC, L, H, dk, dv, decay=0.1):
    rng = np.random.default_rng(seed)
    s = dk ** -0.25
    qc, kc, vc = _on(cuda, dtype, f32(rng, B, NC, L, H, dk) * s,
                     f32(rng, B, NC, L, H, dk) * s, f32(rng, B, NC, L, H, dv))
    cum = torch.as_tensor(np.cumsum(-np.abs(f32(rng, B, NC, L, H)) * decay,
                                    axis=2), device=cuda)
    return qc, kc, vc, cum


@pytest.mark.gpu
@pytest.mark.parametrize("B,NC,L,H,dk,dv,decay", [
    (1, 2, 16, 4, 16, 16, 0.1),       # the smoke config's L = 16
    (2, 3, 32, 4, 16, 48, 0.1),       # dk != dv
    (1, 2, 100, 2, 16, 24, 0.1),      # ragged row and key tiles
    (2, 3, 64, 4, 32, 32, 0.1),       # B > 1, NC > 1
    (1, 1, 192, 2, 128, 200, 0.1),    # dk of two slabs, dv in two slices
    (1, 1, 64, 2, 24, 72, 0.1),       # multiples of 8, not of 16
    (1, 1, 256, 32, 64, 160, 5.0),    # steep decay: cum reaches -1000s
    (1, 4, 256, 32, 64, 160, 0.001),  # slow decay: 256 unit-size terms
])
def test_chunk_scan_tensor_cores_on_card(cuda, B, NC, L, H, dk, dv, decay):
    """bf16 on the tensor-core route against the plain version at the
    float32 tolerance (P and the decayed K reach the tensor cores as
    ``SCAN_PARTS`` bf16 parts that sum to their float32 values); each call
    moves both counters by one. Masked pairs never reach the exp: with the
    steep decay an unmasked exp(cum_t − cum_s) overflows."""
    args = _scan_inputs(cuda, torch.bfloat16, 13, B, NC, L, H, dk, dv,
                        decay)
    calls = cs.chunk_scan.launches, cs.chunk_scan.tensor_core_launches
    got = cs.chunk_scan(*args)
    assert (cs.chunk_scan.launches, cs.chunk_scan.tensor_core_launches) \
        == (calls[0] + 1, calls[1] + 1)
    for g, w in zip(got, cs.chunk_scan_ref(*args)):
        assert g.dtype == torch.float32 and bool(torch.isfinite(g).all())
        torch.testing.assert_close(g, w, rtol=5e-5, atol=5e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,dk,dv", [(torch.float32, 64, 160),
                                         (torch.bfloat16, 64, 65),
                                         (torch.bfloat16, 384, 385)])
def test_chunk_scan_scalar_route_on_card(cuda, dtype, dk, dv):
    """float32, and bf16 widths TMA cannot describe (odd dv, mLSTM's
    full-width dk = 384, dv = 385), take the scalar kernels: the call is
    counted, the tensor-core counter does not move."""
    args = _scan_inputs(cuda, dtype, 14, 1, 1, 128, 2, dk, dv)
    calls = cs.chunk_scan.launches, cs.chunk_scan.tensor_core_launches
    got = cs.chunk_scan(*args)
    assert (cs.chunk_scan.launches, cs.chunk_scan.tensor_core_launches) \
        == (calls[0] + 1, calls[1])
    for g, w in zip(got, cs.chunk_scan_ref(*args)):
        torch.testing.assert_close(g, w, rtol=5e-5, atol=5e-5)


@pytest.mark.gpu
def test_chunk_scan_unaligned_bf16_raises_on_card(cuda):
    """A bf16 operand of the tensor-core route that does not start on a
    16-byte boundary (TMA) raises before anything launches; it is not sent
    to the scalar kernels."""
    qc, kc, vc, cum = _scan_inputs(cuda, torch.bfloat16, 15, 1, 1, 64, 2,
                                   16, 16)
    shifted = torch.empty(qc.numel() + 1, dtype=qc.dtype,
                          device=cuda)[1:].view(qc.shape)
    shifted.copy_(qc)
    calls = cs.chunk_scan.launches, cs.chunk_scan.tensor_core_launches
    with pytest.raises(ValueError, match="16-byte boundary"):
        cs.chunk_scan(shifted, kc, vc, cum)
    assert (cs.chunk_scan.launches,
            cs.chunk_scan.tensor_core_launches) == calls


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,KV,dh,causal,window", [
    (2, 77, 8, 2, 64, True, 0),        # ragged S, GQA 4:1, B > 1
    (1, 1, 4, 2, 64, True, 0),         # one position
    (1, 150, 8, 8, 64, False, 0),      # MHA, not causal
    (1, 200, 4, 1, 128, True, 50),     # MQA, window across key tiles
    (1, 96, 32, 32, 80, True, 0),      # Zamba2's shared block, dh 80
    (2, 64, 4, 4, 32, True, 16),       # window inside one key tile
    (1, 100, 6, 2, 40, True, 0),       # dh 40, a group of 3
])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 5e-5),
                                       (torch.bfloat16, 2e-2)])
def test_flash_attention_bwd_kernel_on_card(cuda, B, S, H, KV, dh, causal,
                                            window, dtype, tol):
    """dq, dk, dv of the backward kernels against the plain version on the
    forward kernel's out and lse."""
    rng = np.random.default_rng(11)
    q, do = (torch.as_tensor(f32(rng, B, S, H, dh), device=cuda).to(dtype)
             for _ in range(2))
    k, v = (torch.as_tensor(f32(rng, B, S, KV, dh), device=cuda).to(dtype)
            for _ in range(2))
    out, lse = fk.flash_attention_with_lse(q, k, v, causal=causal,
                                           window=window)
    got = fbk.flash_attention_bwd(q, k, v, out, lse, do, causal=causal,
                                  window=window)
    want = fbk.flash_attention_bwd_ref(q, k, v, out, lse, do, causal=causal,
                                       window=window)
    for g, w, ref in zip(got, want, (q, k, v)):
        assert g.dtype == ref.dtype and g.shape == ref.shape
        torch.testing.assert_close(g.float(), w.float(), rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("remat", [False, True])
def test_flash_attention_gradient_on_card(cuda, remat):
    """``ops.flash_attention`` under autograd on the card runs the forward
    and backward kernels (one launch each, a second forward under
    checkpointing) and gives autograd's gradient of the plain version."""
    from torch.utils.checkpoint import checkpoint
    rng = np.random.default_rng(12)
    arrays = [f32(rng, 2, 70, h, 32) for h in (4, 2, 2, 4)]

    def grads(fn):
        q, k, v = (torch.as_tensor(a, device=cuda).requires_grad_()
                   for a in arrays[:3])

        def f(a, b, c):
            return fn(a * 1.0, b, c, causal=True, window=30)
        out = checkpoint(f, q, k, v, use_reentrant=False) if remat \
            else f(q, k, v)
        do = torch.as_tensor(arrays[3], device=cuda)
        return torch.autograd.grad((out * do).sum(), (q, k, v))

    ops.reset_launch_counts()
    got = grads(ops.flash_attention)
    assert ops.KERNELS["flash_attention_bwd"].launches == 1
    assert ops.KERNELS["flash_attention"].launches == 1 + remat
    for g, w in zip(got, grads(fk.flash_attention_ref)):
        torch.testing.assert_close(g, w, rtol=5e-5, atol=5e-5)
    with pytest.raises(RuntimeError, match="has no backward kernel"):
        q = torch.zeros((2, 4, 8), device=cuda, requires_grad=True)
        ops.decode_attention(q, q[:, None], q[:, None],
                             torch.zeros(2, dtype=torch.int32, device=cuda))


# The heads of the configs the vlm and dense-config slice brought in:
# InternVL2-2B (H 16, KV 8), Phi-3-medium (H 40, KV 10), Llama-3-405B
# (H 128, KV 8), all at dh 128, and the Phi and Llama smoke configs'
# dh 40 and 64

NEW_HEADS = [(16, 8, 128), (40, 10, 128), (128, 8, 128), (4, 2, 40),
             (4, 2, 64)]


@pytest.mark.gpu
@pytest.mark.parametrize("H,KV,dh", NEW_HEADS)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 5e-5),
                                       (torch.bfloat16, BF16_TOL)])
def test_attention_kernels_at_new_config_heads_on_card(cuda, H, KV, dh,
                                                       dtype, tol):
    """Paged decode, chunk prefill (a 256-row chunk at position 0, as the
    vlm image prefix's first chunk is, and a ragged one after it), flash
    (ragged S), paged verify and contiguous decode at the new configs'
    heads, each against its plain version in float32 on the same values
    (bf16 at 8e-3: the tensor-core kernels' own rounding)."""
    def on(*arrays):
        return [torch.as_tensor(a, device=cuda).to(dtype)
                if a.dtype == np.float32 else torch.as_tensor(a, device=cuda)
                for a in arrays]

    def close(got, want):
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)

    q, kp, vp, p, bt = on(*paged_inputs(16, 3, 8, 16, H, KV, dh,
                                        pos=(0, 100, 127), unallocated=True))
    close(dk.paged_decode_attention(q, kp, vp, p, bt),
          dk.paged_decode_attention_ref(*up(q, kp, vp), p, bt))
    rng = np.random.default_rng(H + dh)
    kp, vp = on(f32(rng, 25, 16, KV, dh), f32(rng, 25, 16, KV, dh))
    bt = torch.as_tensor(rng.permutation(np.arange(1, 25))[:24]
                         .astype(np.int32), device=cuda)
    for C, start in ((256, 0), (77, 256)):
        q = on(f32(rng, C, H, dh))[0]
        close(dk.chunk_prefill_attention(q, kp, vp, start, bt),
              dk.chunk_prefill_attention_ref(*up(q, kp, vp), start, bt))
    q, k, v = on(f32(rng, 1, 333, H, dh), f32(rng, 1, 333, KV, dh),
                 f32(rng, 1, 333, KV, dh))
    out, lse = fk.flash_attention_with_lse(q, k, v)
    want, want_lse = fk.flash_attention_with_lse_ref(*up(q, k, v))
    close(out, want)
    close(lse, want_lse)
    q, kp, vp, p, bt = on(*verify_inputs(17, 2, 8, 16, 4, H, KV, dh,
                                         (30, 120)))
    close(dk.paged_verify_attention(q, kp, vp, p, bt),
          dk.paged_verify_attention_ref(*up(q, kp, vp), p, bt))
    q, k, v = on(f32(rng, 2, H, dh), f32(rng, 2, 300, KV, dh),
                 f32(rng, 2, 300, KV, dh))
    p = torch.tensor([0, 299], dtype=torch.int32, device=cuda)
    close(dk.decode_attention(q, k, v, p),
          dk.decode_attention_ref(*up(q, k, v), p))


@pytest.mark.gpu
@pytest.mark.parametrize("strategy,speculative", [("top1", None),
                                                  ("mixture", "expert")])
def test_vlm_serves_as_on_the_cpu(cuda, strategy, speculative):
    """The smoke-size float32 vlm (``internvl2_2b``: a 16-row image prefix
    ahead of each prompt), 2 experts, paged + chunked, top-1 and the
    mixture with expert drafting: the card gives the CPU's tokens and
    finish reasons."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.router import CentroidRouter, RouterConfig
    from repro_torch.models import build_model
    from repro_torch.serve.api import EngineConfig, SamplingParams
    from repro_torch.serve.scheduler import make_engine

    cfg = get_smoke_config("internvl2_2b")
    model = build_model(cfg)
    experts = [model.init(torch.Generator().manual_seed(k)) for k in range(2)]
    rng = np.random.default_rng(3)
    router = CentroidRouter(torch.as_tensor(f32(rng, 2, 16)),
                            RouterConfig(top_k=2))
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
               for n in (5, 19, 30, 8)]
    patches = [f32(rng, cfg.n_patches, cfg.vision_dim) for _ in prompts]
    feats = f32(rng, 4, 16)
    ecfg = EngineConfig(n_slots=2, cache_len=64, paged=True, page_block=8,
                        chunked_prefill=True, chunk=8, strategy=strategy,
                        speculative=speculative, spec_len=4)
    res = []
    for dev in ("cpu", "cuda"):
        eng = make_engine(model, experts=experts, router=router, config=ecfg,
                          device=dev)
        for i, p in enumerate(prompts):
            eng.add_request(p, SamplingParams(max_new=10),
                            {"patches": patches[i]}, features=feats[i],
                            rid=i)
        out = {}
        while eng.has_unfinished():
            for o in eng.step():
                if o.finished:
                    out[o.rid] = (o.token_ids, o.finish_reason)
        res.append(out)
    assert res[0] == res[1] and len(res[1]) == 4
