"""The port's dry run of decode on caches the sharding rules split along
their sequence (``repro_torch.launch.dryrun``; ``test_torch_dryrun.py``
holds a training case): Qwen3-8B at ``decode_32k`` (KV 8 does not divide
``model`` 16, so each device holds 2048 of the 32768 positions, and q's
heads, split over ``model`` too, are gathered there) and at ``long_500k``
(batch 1: the 8192-position ring goes over ``data``, 512 a device, with
the query heads sliced over ``model``), on the multi-pod mesh in the
decentralized mode with the depth probe, each in a subprocess (the fake
512-rank process group must not leak into the test process). Both must
run (``status: ok``) on 512 devices with no collective across pods, and
the schedule of the depth-1 run must hold the seam's merge of partial
softmaxes: a MAX all-reduce of the (B, H) float32 lse and a SUM of the
(B, H, dh + 1) numerator and weight on the group of the axis that splits
the sequence.
"""
import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH, DH = "qwen3_8b", 128
# shape: (a device's K cache shard (B, S, KV, dh), the ranks of rank 0's
# group on the axis that splits the sequence)
CASES = {"decode_32k": ((8, 2048, 8, DH), list(range(16))),
         "long_500k": ((1, 512, 8, DH), list(range(0, 256, 16)))}


@pytest.mark.parametrize("shape", sorted(CASES))
def test_dryrun_decode_on_a_sequence_split_cache(tmp_path, shape):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", ARCH,
         "--shape", shape, "--mesh", "multi", "--mode", "decentralized",
         "--probe", "--save-schedule", "--out", str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    cid = f"{ARCH}.{shape}.multi.decentralized.probe"
    with open(tmp_path / f"{cid}.json") as f:
        rec = json.load(f)
    assert rec["status"] == "ok" and rec["n_devices"] == 512
    coll = rec["collectives"]
    assert coll["cross_pod_bytes"] == 0 and coll["cross_pod_ops"] == 0
    kv_local, group = CASES[shape]
    assert rec["kv_local"] == list(kv_local)
    with open(tmp_path / f"{cid}.schedule.json") as f:
        ops = [o for o in json.load(f)
               if o["op"] == "all-reduce" and o["ranks"] == group]
    assert not any(o["crosses_pod"] for o in ops)
    sums = [o["bytes"] for o in ops if o["bytes"] % (4 * (DH + 1)) == 0]
    assert len(sums) == 1, ops            # one attention layer at depth 1
    lse_bytes = sums[0] // (DH + 1)
    assert any(o["bytes"] == lse_bytes for o in ops), ops
    assert lse_bytes % (4 * kv_local[0]) == 0
