"""The placed train and decode steps on real collectives: 4 CPU processes
on gloo.

Two meshes over ("pod", "data", "model"): (2, 2, 1), pods and FSDP, and
(2, 1, 2), pods and tensor parallelism. The float32 ``qwen3_8b`` smoke
config, K = 2 experts whose weights cross from the reference's pytree
(``repro.models`` init, ``repro_torch.weights``). After 2 steps the placed
decentralized step (``trainer.make_placed_decentralized_train_step``) must
give the unplaced port step's (``make_decentralized_train_step``) loss,
grad norm and params within rtol 1e-5 / atol 1e-6 — ``test_torch_train.py``
ties the unplaced step to K independent steps, and each of those to the
reference's. No collective the recorder sees in the placed step may have a
group that spans pods; the dense mode's placed step (one model, batch and
FSDP over ("pod", "data")) must cross pods — the control that shows the
recorder sees what it must.

The placed decode step (``model.decode_step`` through
``trainer.run_placed``, as the dry run drives it) on caches the rules split
along their sequence: the seam's split-key decode and the merge of partial
softmaxes (``kernels/ops.py``), and each device's share of the cache write
(``models/attention._write_rows``). Three steps from a seeded cache must
give the unplaced port step's logits and every cache leaf — in float64
within the same rtol / atol, in float32 within ``F32_OF_F64`` times the
unplaced float32 step's own distance to float64 (see there) — with the
positions in different shards of the sequence (some devices' key ranges
wholly past pos: the empty fence) and, with a window, a ring that is full
on a step.

Every ``torch.distributed`` setup runs in subprocesses (this file run as a
script, one process a rank), so no process group leaks into a pytest
worker. Gloo has no all-to-all; DTensor does not need one here.
"""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD, K, B, S, STEPS = 4, 2, 4, 16, 2
RTOL, ATOL = 1e-5, 1e-6
LR = 1e-4


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """K experts' reference params (``repro`` init, keys 0..K-1) and a
    seeded (K, B, S) token batch, in one npz."""
    import jax

    from repro.configs.base import get_smoke_config
    from repro.models import build_model
    from repro_torch.tree import tree_leaves

    model = build_model(get_smoke_config("qwen3_8b"))
    arrays = {}
    for k in range(K):
        params = jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(k)))
        for path, a in tree_leaves(params):
            arrays[f"{k}/{path}"] = a.astype(np.float32)
    rng = np.random.default_rng(0)
    arrays["tokens"] = rng.integers(0, 512, (K, B, S)).astype(np.int64)
    path = str(tmp_path_factory.mktemp("placed") / "weights.npz")
    np.savez(path, **arrays)
    return path


def _run(weights, tmp_path, mesh, mode):
    port, out = _free_port(), str(tmp_path)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), str(port),
         ",".join(map(str, mesh)), mode, weights, out],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(WORLD)]
    logs = [p.communicate(timeout=240)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    return [json.load(open(os.path.join(out, f"rank{r}.json")))
            for r in range(WORLD)]


@pytest.mark.parametrize("mesh", [(2, 2, 1), (2, 1, 2)])
def test_placed_decentralized_step_equals_unplaced(weights, tmp_path, mesh):
    for r, rec in enumerate(_run(weights, tmp_path, mesh, "decentralized")):
        for got, want in zip(rec["metrics"], rec["want"]):
            for name in ("loss", "grad_norm", "lr"):
                np.testing.assert_allclose(got[name], want[name], rtol=RTOL,
                                           atol=ATOL, err_msg=name)
        assert rec["param_excess"] <= 0, rec["param_excess"]
        assert rec["shards_ok"], rec["shards_bad"]
        # each step communicates inside its pod, never across
        for s in rec["collectives"]:
            assert s["n_collectives"] > 0
            assert s["cross_pod_bytes"] == 0 and s["cross_pod_ops"] == 0
        assert rec["experts"] == [r // 2], "rank runs its pod's expert"


def test_placed_dense_step_equals_unplaced_and_crosses_pods(weights,
                                                            tmp_path):
    for rec in _run(weights, tmp_path, (2, 2, 1), "dense"):
        for got, want in zip(rec["metrics"], rec["want"]):
            for name in ("loss", "grad_norm", "lr"):
                np.testing.assert_allclose(got[name], want[name], rtol=RTOL,
                                           atol=ATOL, err_msg=name)
        assert rec["param_excess"] <= 0, rec["param_excess"]
        assert rec["shards_ok"], rec["shards_bad"]
        for s in rec["collectives"]:
            assert s["cross_pod_ops"] > 0 and s["cross_pod_bytes"] > 0


# The decode cases: (mesh, B, S_cache, window, first positions). Each runs
# DECODE_STEPS steps, every position one further a step. (1, 1, 4), B = 4:
# KV 2 does not divide model 4, so the sequence goes over ``model``, where
# q's 4 heads are split too (the all-gather of q); slot 0 stays in the
# first shard (the other three see an empty fence), slot 2 crosses from
# shard 2 to 3. (1, 2, 2), B = 1: the batch loop puts the sequence over
# ``data`` and the query heads are sliced over ``model`` with the KV heads
# whole; pos crosses the shard boundary. The window case: a ring of 8 over
# ``model`` (2 positions a shard), slot 1 fills it on the last step, slots
# 2 and 3 are past it.
DECODE_STEPS = 3
DECODE_CASES = {
    "seq_over_model": ((1, 1, 4), 4, 16, 0, (1, 5, 10, 13)),
    "seq_over_data_heads_sliced": ((1, 2, 2), 1, 16, 0, (6,)),
    "ring_full": ((1, 1, 4), 4, 8, 8, (2, 6, 9, 20)),
}
# float32 against float32: the placed step's tensor parallelism sums in
# another order than the unplaced one (the row-parallel wo and w_down
# all-reduce partial sums), and this random smoke model magnifies any such
# rounding: its float32 cache leaves move by up to ~2e-5, as far as the
# unplaced float32 step itself lies from its float64 twin (1.7e-5 on the
# v cache), and as far on a placed step with no sequence split at all. So
# float32 is held at F32_OF_F64 times the unplaced float32 step's distance
# to float64, leaf by leaf; the same steps in float64 (the decode's plain
# version, its softmax and the merge too) are held at rtol / atol above.
F32_OF_F64 = 4.0


@pytest.fixture(scope="module")
def decode_runs(weights, tmp_path_factory):
    """Every decode case in both dtypes, from one launch of the 4 ranks."""
    out = tmp_path_factory.mktemp("decode")
    return _run(weights, out, (1, 1, 4), "decode")


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_placed_decode_on_a_sequence_split_cache_equals_unplaced(
        decode_runs, case):
    for rank in decode_runs:
        rec = rank[case]
        assert rec["seq_axes"], "the rules did not split the sequence"
        for step in rec["float64"]:
            assert step["logits_excess"] <= 0, step
            assert step["cache_excess"] <= 0, step
        for step in rec["float32"]:
            for name, (placed, own) in step["max_abs"].items():
                assert placed <= F32_OF_F64 * own, (name, step)
        for step in rec["float32"] + rec["float64"]:
            # the merge's SUM all-reduce, one a layer on each axis that
            # splits the sequence (each after its MAX), all in the pod
            assert step["merge_sums"] == 2 * len(rec["seq_axes"]), step
            assert step["cross_pod_ops"] == 0


# ---------------------------------------------------------------------------
# One rank (this file run as a script)
# ---------------------------------------------------------------------------

def _worker(rank, port, mesh_shape, mode, weights, out):
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.roofline import (CollectiveRecorder,
                                             collective_summary)
    from repro_torch.models import build_model
    from repro_torch.optim.adamw import AdamWConfig, init_state
    from repro_torch.sharding import rules as R
    from repro_torch.train import trainer as T
    from repro_torch.tree import tree_from_leaves, tree_leaves
    from repro_torch.weights import to_tensor

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=WORLD)
    cfg = get_smoke_config("qwen3_8b")
    model = build_model(cfg)
    tc = T.TrainConfig(opt=AdamWConfig(lr=LR, warmup_steps=1))
    npz = np.load(weights)
    decentralized = mode == "decentralized"
    n = K if decentralized else 1

    def fresh():
        states = []
        for k in range(n):
            keys = sorted(x for x in npz.files if x.startswith(f"{k}/"))
            params = tree_from_leaves([x[2:] for x in keys],
                                      [to_tensor(npz[x]) for x in keys])
            states.append({"params": params, "opt": init_state(params)})
        tokens = torch.as_tensor(npz["tokens"][:n])
        if decentralized:
            return (T.stack_expert_states(states),
                    {"tokens": tokens, "labels": tokens.clone()})
        return states[0], {"tokens": tokens[0], "labels": tokens[0].clone()}

    unplaced = (T.make_decentralized_train_step(model, tc) if decentralized
                else T.make_train_step(model, tc))
    want_state, batch = fresh()
    want = []
    for _ in range(STEPS):
        _, m = unplaced(want_state, {k: v.clone() for k, v in batch.items()})
        want.append({k: v.tolist() for k, v in m.items()})

    mesh = make_mesh(mesh_shape, ("pod", "data", "model"), "cpu")
    rules = R.logical_rules(multi_pod=True, decentralized=decentralized)
    state, batch = fresh()
    specs = T.state_shardings(model, rules, mesh, K if decentralized else 0,
                              count_over_experts=True)
    T.distribute_state(state, specs, mesh)
    bspecs = R.data_shardings(rules, mesh, cfg, "train",
                              K if decentralized else 0)
    batch = {k: distribute_tensor(v, mesh, R.placements(bspecs[k], mesh))
             for k, v in batch.items()}
    step = (T.make_placed_decentralized_train_step(model, tc, mesh)
            if decentralized else T.make_placed_train_step(model, tc))
    metrics, collectives = [], []
    for _ in range(STEPS):
        with CollectiveRecorder(pod_size=mesh_shape[1] * mesh_shape[2]) \
                as rec:
            _, m = step(state, batch)
        collectives.append(collective_summary(rec.ops))
        metrics.append({k: (v.full_tensor() if hasattr(v, "full_tensor")
                            else v).tolist() for k, v in m.items()})

    excess, bad = -1.0, []
    for (path, a), (_, b) in zip(tree_leaves(state["params"]),
                                 tree_leaves(want_state["params"])):
        d = (a.full_tensor() - b).abs() - (ATOL + RTOL * b.abs())
        excess = max(excess, float(d.max()))
    for path, a in tree_leaves(state):
        spec = specs
        for key in path.split("/"):
            spec = spec[key]
        if tuple(a.to_local().shape) != R.local_shape(a.shape, spec, mesh):
            bad.append(path)
    experts = list(T.pod_experts(state, mesh)) if decentralized else []
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump({"metrics": metrics, "want": want, "param_excess": excess,
                   "collectives": collectives, "shards_ok": not bad,
                   "shards_bad": bad, "experts": experts}, f)
    dist.destroy_process_group()


def _decode_worker(rank, port, weights, out):
    """Every decode case in float64 and float32: DECODE_STEPS steps from one
    seeded cache, unplaced then placed by the serving rules (the dry run's
    decode: decentralized, no FSDP) on the case's mesh."""
    from dataclasses import replace

    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.roofline import (CollectiveRecorder,
                                             collective_summary)
    from repro_torch.models import build_model
    from repro_torch.models.params import tree_shardings
    from repro_torch.sharding import rules as R
    from repro_torch.train import trainer as T
    from repro_torch.tree import tree_from_leaves
    from repro_torch.weights import to_tensor

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=WORLD)
    npz = np.load(weights)
    keys = sorted(x for x in npz.files if x.startswith("0/"))
    rules = R.logical_rules(multi_pod=True, decentralized=True, fsdp=False)

    def steps(model, params, cache, tokens, pos, mesh=None, b_place=None):
        """(logits, cache leaves, collectives) of each step, whole."""
        got = []
        for t in range(DECODE_STEPS):
            with torch.no_grad(), CollectiveRecorder(pod_size=WORLD) as rec:
                if mesh is None:
                    logits, cache = model.decode_step(params, cache,
                                                      tokens[t], pos[t])
                else:
                    logits, cache = T.run_placed(
                        model.decode_step, params, cache,
                        distribute_tensor(tokens[t], mesh, b_place),
                        distribute_tensor(pos[t], mesh, b_place))
            whole = {n: (c.full_tensor() if mesh else c).double().clone()
                     for n, c in cache.items()}
            got.append(((logits.full_tensor() if mesh else logits).double(),
                        whole, rec.ops))
        return got

    record = {}
    for case, (mesh_shape, B, S, window, base) in DECODE_CASES.items():
        mesh = make_mesh(mesh_shape, ("pod", "data", "model"), "cpu")
        rng = np.random.default_rng(2)
        tokens = [torch.as_tensor(rng.integers(0, 512, B), dtype=torch.int32)
                  for _ in range(DECODE_STEPS)]
        pos = [torch.tensor([p + t for p in base], dtype=torch.int32)
               for t in range(DECODE_STEPS)]
        b_ax = rules["act_batch"] if B % mesh_shape[1] == 0 else None
        b_place = R.placements((b_ax,), mesh)
        runs, rec = {}, {}
        for dt in ("float64", "float32"):
            cfg = replace(get_smoke_config("qwen3_8b"), sliding_window=window,
                          param_dtype=dt, compute_dtype=dt)
            model = build_model(cfg)

            def fresh():
                params = tree_from_leaves(
                    [x[2:] for x in keys],
                    [to_tensor(npz[x]).to(cfg.pdtype) for x in keys])
                cache = model.init_cache(B, S, device="cpu")
                seed = np.random.default_rng(1)
                for leaf in cache.values():
                    leaf.copy_(torch.as_tensor(
                        seed.standard_normal(leaf.shape), dtype=leaf.dtype))
                return params, cache

            runs[dt] = steps(model, *fresh(), tokens, pos)
            params, cache = fresh()
            T.distribute_state(params, tree_shardings(model.param_specs(),
                                                      rules, mesh), mesh)
            T.distribute_state(cache, R.cache_pspec_tree(
                model.cache_shapes(B, S), rules, mesh), mesh)
            placed = steps(model, params, cache, tokens, pos, mesh, b_place)
            rec["seq_axes"] = [i for i, p in enumerate(cache["k"].placements)
                               if p.is_shard(2)]

            def excess(a, b):
                return float(((a - b).abs() - (ATOL + RTOL * b.abs())).max())

            rec[dt] = []
            for t, (logits, leaves, ops) in enumerate(placed):
                want_logits, want = runs[dt][t][:2]
                f64_logits, f64 = runs["float64"][t][:2]
                rec[dt].append({
                    "logits_excess": excess(logits, want_logits),
                    "cache_excess": max(excess(leaves[n], want[n])
                                        for n in want),
                    "max_abs": {n: (float((a - b).abs().max()),
                                    float((b - c).abs().max()))
                                for n, a, b, c in (
                                    ("logits", logits, want_logits,
                                     f64_logits),
                                    *((n, leaves[n], want[n], f64[n])
                                      for n in want))},
                    "merge_sums": sum(
                        1 for c in ops if c.op == "all-reduce"
                        and c.bytes % (cfg.head_dim + 1) == 0),
                    "cross_pod_ops": collective_summary(ops)[
                        "cross_pod_ops"]})
        record[case] = rec
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(record, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    r, p, shape, mode_, w, o = sys.argv[1:7]
    if mode_ == "decode":
        _decode_worker(int(r), int(p), w, o)
    else:
        _worker(int(r), int(p), tuple(int(x) for x in shape.split(",")),
                mode_, w, o)
