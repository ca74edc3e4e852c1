"""A training cell: one decentralized expert's training steps on its card.

Set-up builds the program's model, the benchmark's seeded weights and the
program's AdamW state around them, and drives that one train state through
its first ``check_steps`` steps with the window's own step function and
feed (these are the warm-up, and the steps the reference follows). The
window then runs whole steps, each ending in the trainer's loss readback,
until ``--seconds`` have passed: ``train_tokens_per_s`` is the tokens of
every step in the window over the window's length, from its start to the
end of its last step; ``train_peak_gib`` the allocator's peak over the
window. Once the window has closed and the program's state is freed, the
plain reference follows the same steps from the same weights and batches.
"""
from __future__ import annotations

import gc
import time
from typing import Dict

import torch

from bench.lib import checks, program, traffic, weights
from bench.lib import probe as probe_lib
from bench.reference import common, decoder
from bench.reference.adamw import AdamW


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _norms(tree) -> Dict[str, float]:
    return {p: float(t.double().norm()) for p, t in common.leaves(tree)}


def _change(state, layout, cfg, seed, device) -> Dict[str, float]:
    """Each leaf's ‖master − initial‖, the initial weights drawn again
    group by group."""
    master = dict(common.leaves(state["opt"].get("master",
                                                 state["params"])))
    sq = {p: 0.0 for p in master}
    L = cfg["num_hidden_layers"]
    dtype = getattr(torch, cfg["torch_dtype"])
    for g in range(L + 1):
        for path, t0 in weights.draw_group(layout, seed, 0, g, device,
                                           dtype).items():
            now = master[path][g - 1] if g else master[path]
            sq[path] += float((now.float() - t0.float()).double()
                              .square().sum())
    return {p: v ** 0.5 for p, v in sq.items()}


def _steps(step, first: int, t0: float, seconds: float):
    """Whole steps from step ``first`` on until ``seconds`` have passed
    since ``t0``: the seconds from ``t0`` at which each ended."""
    ends = []
    while True:
        step(first + len(ends))
        ends.append(time.perf_counter() - t0)
        if ends[-1] >= seconds:
            return ends


def run(cell: dict, cfg: dict, mix: dict, seed: int, seconds: float,
        trace: bool, device: torch.device, t_start: float,
        probe_ops=()) -> dict:
    layout = decoder.model_module(cfg).layout(cfg)
    L, V = cfg["num_hidden_layers"], cfg["vocab_size"]
    dtype = getattr(torch, cfg["torch_dtype"])
    phases = {"imports": time.perf_counter() - t_start}
    model = program.build_model(cfg, mix["remat"])
    program.check_layout(model, layout)
    params = weights.make_weights(layout, L, seed, 0, device, dtype)
    opt_cfg = program.optimizer(mix["optimizer"])
    state = program.train_state(params)
    step_fn = program.train_step(model, opt_cfg)
    b1 = mix["optimizer"]["b1"]

    def batch(s):
        toks = torch.as_tensor(traffic.train_batch(mix, seed, s, V),
                               device=device)
        return {"tokens": toks, "labels": toks}

    def step(s) -> float:
        nonlocal state
        with torch.profiler.record_function("bench.host.loader"):
            b = batch(s)
        with torch.profiler.record_function("bench.host.train_step"):
            state, m = step_fn(state, b)
        with torch.profiler.record_function("bench.host.readback"):
            return float(m["loss"])

    phases["weights_state"] = time.perf_counter() - t_start - sum(
        phases.values())
    prog = {"loss": []}
    for s in range(mix["check_steps"]):
        prog["loss"].append(step(s))
        if s == 0:
            prog["grad"] = {p: n / (1 - b1) for p, n in
                            _norms(state["opt"]["m"]).items()}
    phases["check_steps"] = time.perf_counter() - t_start - sum(
        phases.values())
    prog["change"] = _change(state, layout, cfg, seed, device)
    phases["redraw"] = time.perf_counter() - t_start - sum(phases.values())

    if trace:
        probe_lib.warm_profiler(device, lambda: _sync(device))
    _sync(device)
    setup_peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    first = mix["check_steps"]
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    ends = _steps(step, first, t0, seconds)
    n, window_s = len(ends), ends[-1]
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    tokens = n * mix["batch"] * mix["seq_len"]
    out = {
        "attempted": n, "failed": 0, "window_s": window_s,
        "memory_peak_bytes": max(setup_peak, peak),
        "end_to_end": {"train_tokens_per_s": tokens / window_s,
                       "train_peak_gib": peak / 2 ** 30, "setup_s": setup_s},
        "context": {"steps": n, "tokens": tokens, "window_s": window_s},
    }
    if trace:
        # the traced window follows the measured one
        probe = probe_lib.install(probe_ops)
        prof = probe_lib.profiler(device)
        prof.start()
        probe.active = True
        tp = time.perf_counter()
        traced = _steps(step, first + n, tp, mix["trace_seconds"])
        prof.stop()
        probe.active = False
        probe.remove()
        out["prof"], out["probe"], out["trace_window_s"] = prof, probe, \
            traced[-1]
        out["context"]["trace_steps"] = len(traced)

    del state, params, step_fn, model
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = follow(cfg, mix, layout, seed, device, "fp32")
    out["numbers"] = checks.train_numbers(prog, ref)
    out["readings"] = {"program": prog, "reference": ref,
                       "reference_s": time.perf_counter() - t_ref,
                       "setup_phases": phases, "window_step_ends_s": ends}
    return out


def follow(cfg: dict, mix: dict, layout, seed: int, device,
           precision: str, mask_half: bool = False) -> dict:
    """The reference's first ``check_steps`` steps from the seed's weights
    on the seed's batches: each step's loss, the first step's clipped
    gradient norm of each leaf and each leaf's change over the steps."""
    L, V = cfg["num_hidden_layers"], cfg["vocab_size"]
    dtype = getattr(torch, cfg["torch_dtype"])
    prec = common.Prec(precision)
    with common.exact_float32():
        start = weights.make_weights(layout, L, seed, 0, device, dtype)
        params = weights.nest({p: t.float().requires_grad_()
                               for p, t in common.leaves(start)})
        leaves = common.leaves(params)
        opt = AdamW(mix["optimizer"], leaves)
        out = {"loss": []}
        for s in range(mix["check_steps"]):
            toks = torch.as_tensor(traffic.train_batch(mix, seed, s, V),
                                   device=device)
            mask = None
            if mask_half:
                mask = torch.ones_like(toks)
                mask[:, toks.shape[1] // 2:] = 0
            loss = decoder.train_loss(cfg, prec, params, toks, mask)
            grads = torch.autograd.grad(loss, [t for _, t in leaves])
            out["loss"].append(float(loss.detach()))
            norms = opt.step(leaves, grads)
            del grads, loss
            if s == 0:
                out["grad"] = norms
        out["change"] = {p: float((t.detach() - s0.float()).double().norm())
                         for (p, t), (_, s0) in zip(
                             leaves, common.leaves(start))}
    del params, leaves, opt, start
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out
