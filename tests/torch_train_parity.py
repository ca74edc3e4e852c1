"""Helpers of the recurrent families' training tests
(``test_torch_train_hybrid.py``, ``test_torch_train_ssm.py``): one float32
smoke model of ``arch`` in both packages, its reference params carried
across by ``repro_torch.weights``, a token batch that pads its last scan
chunk, and the loss and every gradient leaf on each side.

Not collected by pytest (no ``test_`` prefix): the modules import it.
"""
import numpy as np
import torch

import jax
import jax.numpy as jnp

from repro.configs.base import get_smoke_config as jax_smoke
from repro.models import build_model as jax_build
from repro.models import ssm as jssm
from repro.optim import adamw as jadamw
from repro.train import trainer as jtrainer
from repro_torch.configs import get_smoke_config
from repro_torch.models import build_model
from repro_torch.models import ssm
from repro_torch.optim import adamw
from repro_torch.train import trainer
from repro_torch.tree import tree_leaves
from repro_torch.weights import from_tree

from test_torch_train import jax_leaves, port_loss_and_grads

#: tokens a row: pads the last of 3 scan chunks of the smoke configs' 16
SEQ = 40
#: (remat, loss mask) of the loss and gradient comparisons: every remat
#: policy and both mask states (the port's three policies are also held
#: bit-identical to each other)
CASES = (("full", False), ("full", True), ("none", True), ("dots", False))
#: the float32 gap each leaf may have from the reference's x64 gradient:
#: twice the reference's own float32 gap, plus the dense rule's 2e-5 of
#: its largest element
X64_FACTOR, X64_SLACK = 2.0, 2e-5
#: a train step's params on both sides, in units of the peak lr: Adam
#: moves an element by ~lr·g/(|g| + 1e-8), so a gradient near 1e-8
#: turns float32 noise into a fraction of lr (measured up to 0.20·lr
#: after one step from the same state)
PARAMS_OF_LR = 0.3


class Setup:
    """The reference model and params at ``remat``, the port's config and
    converted params, and the batches (int32 tokens, a float32 mask)."""

    def __init__(self, arch: str, n_layers: int, seed: int = 1):
        self.arch, self.n_layers = arch, n_layers
        self.jcfg = jax_smoke(arch).reduced(n_layers=n_layers)
        self.cfg = get_smoke_config(arch).reduced(n_layers=n_layers)
        self.jp = jax_build(self.jcfg).init(jax.random.PRNGKey(seed))
        self.params = from_tree(jax.tree.map(np.asarray, self.jp))
        rng = np.random.default_rng(seed + 1)
        self.toks = rng.integers(0, self.cfg.vocab, (2, SEQ)) \
            .astype(np.int32)
        self.mask = (np.arange(SEQ) % 3 != 0).astype(np.float32)[None] \
            .repeat(2, 0)
        self._jax = {}

    def batch(self, masked: bool, lib=torch):
        b = {"tokens": self.toks, "labels": self.toks}
        if masked:
            b["loss_mask"] = self.mask
        conv = torch.as_tensor if lib is torch else jnp.asarray
        return {k: conv(v) for k, v in b.items()}

    def model(self, remat: str, dtype: str = "float32"):
        return build_model(self.cfg.reduced(remat=remat, param_dtype=dtype,
                                            compute_dtype=dtype))

    def jax_loss_and_grads(self, remat: str, masked: bool, x64=False):
        """The reference's ``jax.value_and_grad`` of ``Model.loss`` (each
        computed once a module): (loss, {path: numpy leaf})."""
        key = (remat, masked, x64)
        if key not in self._jax:
            cfg, jp = self.jcfg.reduced(remat=remat), self.jp
            if x64:
                cfg = cfg.reduced(param_dtype="float64",
                                  compute_dtype="float64")
                jp = jax.tree.map(lambda a: a.astype(jnp.float64), jp)
            (loss, _), g = jax.value_and_grad(
                jax_build(cfg).loss, has_aux=True)(
                    jp, self.batch(masked, jnp))
            self._jax[key] = (float(loss), jax_leaves(g))
        return self._jax[key]


def worst_leaf(got, want):
    """(largest |got − want| over the leaf's largest |want|, its path)."""
    assert sorted(got) == sorted(want)
    return max((float(np.abs(got[p] - w).max() / np.abs(w).max()), p)
               for p, w in want.items())


def check_x64_gap(setup: Setup, remat: str = "full", masked: bool = True):
    """Every float32 leaf of the port no farther from the reference's x64
    gradient than ``X64_FACTOR`` times the reference's own float32 leaf
    is, plus ``X64_SLACK``: the two packages' float32 gap is rounding."""
    _, want = setup.jax_loss_and_grads(remat, masked, x64=True)
    _, ref32 = setup.jax_loss_and_grads(remat, masked)
    _, got = port_loss_and_grads(setup.model(remat), setup.params,
                                 setup.batch(masked))
    for path, w in want.items():
        scale = np.abs(w).max()
        port_gap = np.abs(got[path] - w).max() / scale
        ref_gap = np.abs(ref32[path] - w).max() / scale
        assert port_gap <= X64_FACTOR * ref_gap + X64_SLACK, \
            (path, port_gap, ref_gap)


def check_remat_bit_identical(setup: Setup):
    """"full", "none" and "dots" give the same loss and gradients bit for
    bit on the CPU (with a loss mask)."""
    batch = setup.batch(True)
    loss, grads = port_loss_and_grads(setup.model("none"), setup.params,
                                      batch)
    for remat in ("full", "dots"):
        l2, g2 = port_loss_and_grads(setup.model(remat), setup.params, batch)
        assert float(l2) == float(loss), remat
        for path in grads:
            np.testing.assert_array_equal(g2[path], grads[path],
                                          err_msg=f"{remat} {path}")


def check_train_steps(setup: Setup, grad_atol: float, steps: int = 2):
    """``steps`` ``make_train_step`` steps (AdamW at peak lr 1e-2, remat
    "full") against the reference's jitted steps on the same batches, each
    step taken from the same state on both sides (the reference's state
    after step s, carried into the port, starts step s + 1: without that,
    Adam's normalised update turns float32 noise in near-zero gradients
    into up to ±lr of movement, and the two runs drift apart chaotically
    from step 2). Each step: loss and lr to 1e-5 relative, grad_norm to
    ``grad_atol`` relative (the gradient's leaves are within that of
    their largest elements); m within ``grad_atol`` of each leaf's largest
    element and v within twice that (it is quadratic in the gradient);
    params within ``PARAMS_OF_LR`` of the peak lr."""
    peak = 1e-2
    opt = dict(lr=peak, warmup_steps=1, total_steps=steps)
    jm = jax_build(setup.jcfg)
    jstate = {"params": setup.jp, "opt": jadamw.init_state(setup.jp)}
    jstep = jax.jit(jtrainer.make_train_step(
        jm, jtrainer.TrainConfig(opt=jadamw.AdamWConfig(**opt))))
    step = trainer.make_train_step(
        setup.model("full"), trainer.TrainConfig(opt=adamw.AdamWConfig(
            **opt)))
    rng = np.random.default_rng(7)

    def port(tree):
        return {p: t.double().numpy() for p, t in tree_leaves(tree)}
    for _ in range(steps):
        state = from_tree(jax.tree.map(np.asarray, jstate))
        toks = rng.integers(0, setup.cfg.vocab, (2, SEQ)).astype(np.int32)
        jstate, jmet = jstep(jstate, {"tokens": jnp.asarray(toks),
                                      "labels": jnp.asarray(toks)})
        _, met = step(state, {"tokens": torch.as_tensor(toks),
                              "labels": torch.as_tensor(toks)})
        for name, rtol in (("loss", 1e-5), ("grad_norm", grad_atol),
                           ("lr", 1e-5)):
            np.testing.assert_allclose(float(met[name]), float(jmet[name]),
                                       rtol=rtol, err_msg=name)
        assert int(state["opt"]["count"]) == int(jstate["opt"]["count"])
        for key, atol in (("m", grad_atol), ("v", 2 * grad_atol)):
            worst = worst_leaf(port(state["opt"][key]),
                               jax_leaves(jstate["opt"][key]))
            assert worst[0] <= atol, (key, worst)
        got, want = port(state["params"]), jax_leaves(jstate["params"])
        for path, w in want.items():
            assert np.abs(got[path] - w).max() <= PARAMS_OF_LR * peak, path


#: the scan's training form in bf16 against the reference's jnp branch in
#: bf16, of each output's largest magnitude. Measured at both smoke
#: shapes: y ≤ 2.1e-4, state ≤ 1.8e-7, dq 0, dk ≤ 2.1e-5, dv ≤ 5.6e-3
#: (one bf16 step at the largest magnitude is 3.9e-3: the cotangent's
#: product rounds to bf16), dlog_g ≤ 2.9e-7. The kernel's plain version
#: (``chunk_scan_ref``: q and k upcast before their product) misses by
#: 4.5e-3–6.7e-3 (y), 2.7e-3–6.4e-3 (dq), 5.4e-3–8.4e-3 (dk) and
#: 1.4e-3–1.6e-3 (dlog_g): these bounds tell the two orders apart.
SCAN_BF16_ATOL = {"y": 2e-3, "state": 1e-5, "dq": 2e-3, "dk": 2e-3,
                  "dv": 8e-3, "dlog_g": 1e-4}


def check_scan_bf16(cfg, H: int, dk: int, dv: int, seed: int = 3):
    """``chunked_linear_attention(..., differentiable=True)`` in bf16
    against the reference's jnp branch (``use_kernel=False``) in bf16 on
    the same inputs (S pads the last chunk): y, the final state, and the
    gradients of q, k, v and log_g under one random cotangent of y, each
    within ``SCAN_BF16_ATOL`` of its largest magnitude."""
    rng = np.random.default_rng(seed)
    B, S, chunk = 2, SEQ, cfg.ssm.chunk
    q = (rng.normal(size=(B, S, H, dk)) / np.sqrt(dk)).astype(np.float32)
    k = rng.normal(size=(B, S, H, dk)).astype(np.float32)
    v = rng.normal(size=(B, S, H, dv)).astype(np.float32)
    log_g = -rng.uniform(0.01, 0.5, size=(B, S, H)).astype(np.float32)
    dy = rng.normal(size=(B, S, H, dv)).astype(np.float32)

    @jax.jit
    def ref(q, k, v, log_g):
        return jssm.chunked_linear_attention(q, k, v, log_g, chunk,
                                             use_kernel=False)
    bf = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    (jy, jst), vjp = jax.vjp(ref, *bf, jnp.asarray(log_g))
    jgrads = vjp((jnp.asarray(dy, jnp.bfloat16), jnp.zeros_like(jst)))
    tq, tk, tv = (torch.as_tensor(a).bfloat16().requires_grad_()
                  for a in (q, k, v))
    tg = torch.as_tensor(log_g).requires_grad_()
    y, st = ssm.chunked_linear_attention(tq, tk, tv, tg, chunk,
                                         differentiable=True)
    assert y.dtype == torch.bfloat16 and st.dtype == torch.float32
    grads = torch.autograd.grad(y, (tq, tk, tv, tg),
                                torch.as_tensor(dy).bfloat16())
    for name, got, want in (("y", y, jy), ("state", st, jst),
                            *zip(("dq", "dk", "dv", "dlog_g"), grads,
                                 jgrads)):
        got = got.detach().double().numpy()
        want = np.asarray(want).astype(np.float64)
        assert got.shape == want.shape, name
        worst = float(np.abs(got - want).max() / np.abs(want).max())
        assert worst <= SCAN_BF16_ATOL[name], (name, worst)


class ScanCalls:
    """Counts ``kernels.ops.chunk_scan`` calls (the kernel seam: the CUDA
    kernel on the card, its plain version here), split by whether autograd
    recorded at the call."""

    def __init__(self, monkeypatch):
        from repro_torch.kernels import ops
        self.no_grad = self.recording = 0
        inner = ops.chunk_scan

        def counted(*args):
            if torch.is_grad_enabled():
                self.recording += 1
            else:
                self.no_grad += 1
            return inner(*args)
        monkeypatch.setattr(ops, "chunk_scan", counted)


def check_scan_routes(setup: Setup, monkeypatch):
    """The training loss never calls the kernel seam's chunk scan, which
    has no backward; the forward and a serving prefill under
    ``torch.no_grad()`` still do, once per recurrent layer a call."""
    calls = ScanCalls(monkeypatch)
    model = setup.model("full")
    port_loss_and_grads(model, setup.params, setup.batch(False))
    assert (calls.no_grad, calls.recording) == (0, 0)
    recurrent = model.n_groups * model.group_m
    with torch.no_grad():
        model.forward(setup.params, {"tokens": torch.as_tensor(setup.toks)})
        model.prefill(setup.params, {"tokens": torch.as_tensor(setup.toks)},
                      cache_len=SEQ + 8)
    assert (calls.no_grad, calls.recording) == (2 * recurrent, 0)


def check_train_path(arch: str):
    """``train_path.build("cpu", smoke=True, arch=...)``: both experts
    train their steps with finite losses and every gradient leaf present
    (each m has a nonzero element)."""
    from repro_torch.launch import train_path
    tp = train_path.build("cpu", smoke=True, arch=arch)
    assert tp.cfg.arch_id == get_smoke_config(arch).arch_id
    for k in range(train_path.N_EXPERTS):
        state, hist = trainer.train_host_loop(tp.model, tp.init_state(k),
                                              tp.loaders[k], tp.steps,
                                              tp.config, log_every=1)
        assert len(hist) == tp.steps
        assert all(np.isfinite(h["loss"]) for h in hist)
        assert all(bool(m.abs().amax() > 0)
                   for _, m in tree_leaves(state["opt"]["m"]))
