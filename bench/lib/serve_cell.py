"""A serving cell: the Eq. 28 deployment (K expert pods behind the centroid
router) answering the mix's requests.

Set-up builds the program's model, the benchmark's seeded weights for each
expert, the router over the seed's centroids and the program's engine, and
then runs the mix's closed loop of clients for ``fill_steps`` engine steps:
every shape the window uses is warmed and the pods are filled to their
steady state.
The window then steps the engine until ``--seconds`` have passed.
``serve_tokens_per_s`` counts every token streamed by a step that returned
inside the window, partly served requests too, over the window's length
(its start to the return of its last step); ``ttft_p90_ms`` is the 90th
percentile, nearest rank, of the time to first token of every request sent
in the window, from its send to the return of the ``step()`` that
streamed its first token, served past the window's close where need be.
Once every such request has its first token, the program's state is freed
and the plain reference scores a sample of the requests that finished
inside the window."""
from __future__ import annotations

import gc
import math
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from bench.lib import probe as probe_lib
from bench.lib import program, traffic, weights
from bench.reference import common, decoder

DRAIN_S = 120.0      # longest wait past the window for first tokens


@dataclass
class Sent:
    index: int
    prompt: int
    t_send: float
    in_window: bool
    client: int = 0
    t_first: float = 0.0
    t_done: float = 0.0
    tokens: List[int] = field(default_factory=list)
    streamed: List[tuple] = field(default_factory=list)  # (index, t)
    reason: Optional[str] = None


class Loop:
    """The mix's closed loop of clients against the engine."""

    def __init__(self, engine, mix: dict, reqs: traffic.Requests):
        self.engine, self.reqs = engine, reqs
        self.clients = mix["clients"]
        self.sent: Dict[int, Sent] = {}
        self.rounds: Dict[int, int] = {}  # requests each client has sent
        self.sending = True
        self.window = (math.inf, math.inf)
        self.params = program.sampling(mix["new_tokens"])

    def send(self, j: int, t_send: float, client: int) -> None:
        r = self.reqs.get(j)
        in_window = self.window[0] <= t_send < self.window[1]
        self.sent[j] = Sent(j, len(r.tokens), t_send, in_window, client)
        with torch.profiler.record_function("bench.host.add_request"):
            self.engine.add_request(r.tokens, self.params,
                                    features=r.features, rid=j)

    def send_next(self, client: int) -> None:
        """Client ``client``'s next request: c, c + n, c + 2n, ... of n
        clients."""
        k = self.rounds.get(client, 0)
        self.rounds[client] = k + 1
        self.send(client + k * self.clients, time.perf_counter(), client)

    def start(self) -> None:
        for c in range(self.clients):
            self.send_next(c)

    def step(self) -> float:
        if not self.engine.has_unfinished():
            time.sleep(1e-3)
            return time.perf_counter()
        with torch.profiler.record_function("bench.host.engine_step"):
            outs = self.engine.step()
        t = time.perf_counter()
        for o in outs:
            s = self.sent[o.rid]
            for d in o.deltas:
                s.streamed.append((d.index, t))
                if d.index == 0:
                    s.t_first = t
            if o.finished:
                s.tokens, s.reason = list(o.token_ids), o.finish_reason
                s.t_done = t
                if self.sending:
                    self.send_next(s.client)
        return t


def p90(values: List[float]) -> float:
    v = sorted(values)
    return v[max(math.ceil(0.9 * len(v)) - 1, 0)]


def run(cell: dict, cfg: dict, mix: dict, seed: int, seconds: float,
        trace: bool, device: torch.device, t_start: float,
        probe_ops=()) -> dict:
    mod = decoder.model_module(cfg)
    layout = mod.layout(cfg)
    L, V = cfg["num_hidden_layers"], cfg["vocab_size"]
    dtype = getattr(torch, cfg["torch_dtype"])
    dep = mix["deployment"]
    phases = {"imports": time.perf_counter() - t_start}
    model = program.build_model(cfg)
    program.check_layout(model, layout)
    experts = [weights.make_weights(layout, L, seed, k, device, dtype)
               for k in range(dep["experts"])]
    reqs = traffic.Requests(mix, seed, V)
    engine = program.serving_engine(model, experts, reqs.centroids, dep,
                                    device)
    phases["weights_engine"] = time.perf_counter() - t_start - sum(
        phases.values())
    loop = Loop(engine, mix, reqs)
    loop.start()
    for _ in range(mix["fill_steps"]):
        loop.step()
    if trace:
        probe_lib.warm_profiler(device, loop.step)
    phases["fill"] = time.perf_counter() - t_start - sum(phases.values())

    regs = program.registries(engine)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    before = _registry(regs)
    loop.window = (t0, math.inf)
    t1, steps = t0, 0
    while t1 - t0 < seconds:
        t1 = loop.step()
        steps += 1
    loop.window = (t0, t1)
    after = _registry(regs)
    window_s = t1 - t0
    traced = {}
    if trace:
        # the traced window follows the measured one, the clients still
        # sending
        probe = probe_lib.install(probe_ops)
        prof = probe_lib.profiler(device)
        prof.start()
        probe.active = True
        tp = tp1 = time.perf_counter()
        while tp1 - tp < mix["trace_seconds"]:
            tp1 = loop.step()
        prof.stop()
        probe.active = False
        probe.remove()
        traced = {"prof": prof, "probe": probe, "trace_window_s": tp1 - tp}
    loop.sending = False

    window = [s for s in loop.sent.values() if s.in_window]
    limit = time.perf_counter() + DRAIN_S
    while any(not s.t_first and s.reason is None for s in window) \
            and time.perf_counter() < limit:
        loop.step()
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    streamed = sum(1 for s in loop.sent.values() for _, t in s.streamed
                   if t0 < t <= t1)
    ok = [s for s in window if s.t_first
          and s.reason in (None, "length", "stop")]
    ttft = [s.t_first - s.t_send for s in ok]
    out = {
        "attempted": len(window), "failed": len(window) - len(ok),
        "window_s": window_s, "memory_peak_bytes": peak,
        "end_to_end": {"serve_tokens_per_s": streamed / window_s,
                       "ttft_p90_ms": p90(ttft) * 1e3 if ttft else None,
                       "setup_s": setup_s},
        "context": {"window_s": window_s, "t0": t0, "t1": t1,
                    "sent": list(loop.sent.values()),
                    "registry": {n: (after[n][0] - before.get(n, (0, 0))[0],
                                     after[n][1] - before.get(n, (0, 0))[1])
                                 for n in after}},
    }
    out.update(traced)

    # the check's sample: requests served whole inside the measured window
    finished = [s for s in loop.sent.values()
                if s.reason in ("length", "stop") and t0 < s.t_done <= t1
                and len(s.tokens) == mix["new_tokens"]]
    del loop, engine, experts, model
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    chosen = _sample(finished, seed, mix["check"]["requests"])
    gaps = served_gaps(cfg, layout, seed, reqs, chosen, device,
                       ("served",))["served"]
    out["numbers"] = {"gap": max(gaps) if gaps else math.inf}
    out["readings"] = {"checked_requests": [s.index for s in chosen],
                       "checked_tokens": len(gaps),
                       "reference_s": time.perf_counter() - t_ref,
                       "setup_phases": phases,
                       "engine_steps": steps, "window_requests_done": sum(
                           1 for s in window if s.reason is not None)}
    return out


def _registry(regs) -> Dict[str, tuple]:
    """(sum, count) of every histogram series, summed over the pods."""
    out: Dict[str, list] = {}
    for r in regs:
        for s in r.series():
            if s.kind == "histogram":
                acc = out.setdefault(s.name, [0.0, 0])
                acc[0] += s.sum
                acc[1] += s.count
    return {n: tuple(v) for n, v in out.items()}


def _sample(finished: List[Sent], seed: int, n: int) -> List[Sent]:
    if not finished:
        return []
    longest = max(finished, key=lambda s: (s.prompt, -s.index)).index
    keep = traffic.sample(seed, [s.index for s in finished], n, [longest])
    by = {s.index: s for s in finished}
    return [by[i] for i in keep]


def route(centroids: np.ndarray, features: np.ndarray) -> int:
    """The Eq. 28 top-1 expert: the centroid of largest cosine."""
    c = centroids / np.linalg.norm(centroids, axis=1, keepdims=True)
    f = features / np.linalg.norm(features)
    return int(np.argmax(c @ f))


def served_gaps(cfg, layout, seed, reqs: traffic.Requests,
                chosen: List[Sent], device, precisions) -> Dict[str, list]:
    """The gap of every served token of ``chosen``: the reference's best
    logit at its position minus the reference's logit of the token the
    program served there ("served"), or of the token that the reference in
    a lower precision ("fp8") puts first there."""
    L = cfg["num_hidden_layers"]
    dtype = getattr(torch, cfg["torch_dtype"])
    gaps: Dict[str, list] = {p: [] for p in precisions}
    by_expert: Dict[int, List[Sent]] = {}
    for s in chosen:
        r = reqs.get(s.index)
        by_expert.setdefault(route(reqs.centroids, r.features), []).append(s)
    with common.exact_float32():
        for k, group in sorted(by_expert.items()):
            rows, scored, served = [], [], []
            for s in group:
                prompt = reqs.get(s.index).tokens
                toks = np.concatenate([prompt, np.asarray(s.tokens[:-1],
                                                          np.int32)])
                rows.append(torch.as_tensor(toks.astype(np.int64),
                                            device=device))
                scored.append(slice(len(prompt) - 1,
                                    len(prompt) - 1 + len(s.tokens)))
                served.append(torch.as_tensor(s.tokens, device=device))
            outer = weights.nest({p: t.float() for p, t in
                                  weights.draw_group(layout, seed, k, 0,
                                                     device, dtype).items()})

            def layer_params(i, k=k):
                return weights.nest({
                    p.split(".", 1)[1]: t.float() for p, t in
                    weights.draw_group(layout, seed, k, i + 1, device,
                                       dtype).items()})

            ref = decoder.served_logits(cfg, common.Prec("fp32"),
                                        layer_params, outer, rows, scored)
            for prec in precisions:
                if prec == "served":
                    picks = served
                else:
                    low = decoder.served_logits(cfg, common.Prec(prec),
                                                layer_params, outer, rows,
                                                scored)
                    picks = [lg.argmax(-1) for lg in low]
                    del low
                for lg, tok in zip(ref, picks):
                    best = lg.max(-1).values
                    gaps[prec] += (best - lg.gather(-1, tok[:, None].long())
                                   .squeeze(-1)).tolist()
            del outer, ref
    return gaps
