"""The plain reference against the program's plain CPU path at smoke size,
in float32: the training loss and every leaf's gradient, the served
logits, and the reference's AdamW against the program's."""
import pytest
import torch

from bench.lib import program, weights
from bench.lib.manifest import Manifest
from bench.reference import common, decoder
from bench.reference.adamw import AdamW

CELLS = ["qwen3_8b.train_4k"]


def _setup(root, workload, seed=3):
    m = Manifest(root)
    cfg = m.config(m.workload(workload)["config"])
    cfg["torch_dtype"] = "float32"
    layout = decoder.model_module(cfg).layout(cfg)
    model = program.build_model(cfg, "none")
    program.check_layout(model, layout)
    params = weights.make_weights(layout, cfg["num_hidden_layers"], seed, 0,
                                  torch.device("cpu"), torch.float32)
    toks = torch.randint(0, cfg["vocab_size"], (2, 48),
                         generator=torch.Generator().manual_seed(seed))
    return cfg, layout, model, params, toks


def _like(tree, flat, prefix=""):
    """``flat``'s tensors in ``tree``'s nesting and key order."""
    return {k: _like(v, flat, f"{prefix}{k}.") if isinstance(v, dict)
            else flat[prefix + k] for k, v in tree.items()}


@pytest.mark.parametrize("workload", CELLS)
def test_loss_and_gradients_match_the_program(smoke_root, workload):
    cfg, layout, model, params, toks = _setup(smoke_root, workload)
    leaves = common.leaves(params)
    live = [t.clone().requires_grad_() for _, t in leaves]
    tree = weights.nest({p: t for (p, _), t in zip(leaves, live)})
    loss, _ = model.loss(tree, {"tokens": toks, "labels": toks})
    grads = torch.autograd.grad(loss, live)
    rlive = [t.clone().requires_grad_() for _, t in leaves]
    rtree = weights.nest({p: t for (p, _), t in zip(leaves, rlive)})
    with common.exact_float32():
        rloss = decoder.train_loss(cfg, common.Prec("fp32"), rtree, toks)
        rgrads = torch.autograd.grad(rloss, rlive)
    assert float(loss.detach()) == pytest.approx(float(rloss.detach()),
                                               rel=1e-5)
    for (path, _), g, r in zip(leaves, grads, rgrads):
        scale = float(r.abs().max()) + 1e-12
        assert float((g - r).abs().max()) <= 1e-4 * scale, path


@pytest.mark.parametrize("workload", CELLS)
def test_served_logits_match_the_program(smoke_root, workload):
    cfg, layout, model, params, toks = _setup(smoke_root, workload)
    with torch.no_grad():
        logits = model.forward(params, {"tokens": toks[:1]})[0]
    outer = {"embed": params["embed"], "final_norm": params["final_norm"]}
    with common.exact_float32():
        ref = decoder.served_logits(
            cfg, common.Prec("fp32"),
            lambda i: decoder.layer_slice(params["blocks"], i), outer,
            [toks[0]], [slice(0, toks.shape[1])])[0]
    assert float((logits - ref).abs().max()) <= 1e-4 * float(
        ref.abs().max())


def test_adamw_matches_the_program(smoke_root):
    cfg, layout, model, params, toks = _setup(smoke_root, CELLS[0])
    m = Manifest(smoke_root)
    opt = m.traffic("train_4k")["optimizer"]
    opt = dict(opt, warmup_steps=1)
    ref = {p: t.clone() for p, t in common.leaves(params)}
    state = program.train_state(params)
    from repro_torch.optim.adamw import apply_updates
    radam = AdamW(opt, list(ref.items()))
    for step in range(3):
        g = torch.Generator().manual_seed(step)
        grads = {p: torch.randn(t.shape, generator=g) for p, t in ref.items()}
        apply_updates(params, _like(params, grads), state["opt"],
                      program.optimizer(opt))
        radam.step(list(ref.items()), [grads[p] for p in ref])
    for p, t in common.leaves(params):
        assert torch.allclose(t, ref[p], rtol=1e-5, atol=1e-7), p
