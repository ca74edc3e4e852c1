"""A device's memory in the port's dry run (``roofline.LocalMemory``, the
counterpart of the reference's ``compiled.memory_analysis()`` keys in
``repro/launch/dryrun.py``): on plain CPU tensors and on DTensor's local
shards, against bytes counted by hand, and the four keys in a
``dryrun`` record.
"""
import json
import os
import subprocess
import sys
import textwrap

import torch

from repro_torch.launch.roofline import LocalMemory, local_storages

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = ("argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes", "generated_code_size_in_bytes")


def _step(x):
    """x: 256 float32 (1024 B). Allocates a (1024 B), views and updates it
    in place (0 B), concatenates it twice (2048 B: the peak, 3072 B live),
    drops a (2048 B live), clones half of the concatenation (512 B) and
    drops it, returning the clone and the argument itself."""
    a = x * 2
    b = a.view(16, 16)
    b.add_(1)
    c = torch.cat([a, a])
    del a, b
    d = c[:128].clone()
    del c
    return d, x


def test_local_memory_on_plain_tensors_matches_the_hand_count():
    x = torch.ones(256)
    with LocalMemory() as mem:
        out = _step(x)
    assert (mem.peak, mem.live) == (3072, 512)
    assert mem.memory((x,), out) == {
        "argument_size_in_bytes": 1024,
        "output_size_in_bytes": 512,      # x is an argument, not an output
        "temp_size_in_bytes": 3072 - 512,
        "generated_code_size_in_bytes": None}
    torch.testing.assert_close(out[0], torch.full((128,), 3.0))


def test_local_memory_counts_a_plain_version_as_its_kernel():
    """On CPU tensors the seam runs flash attention's plain version, which
    materialises the (B, H, S, S) scores; the card's kernel keeps them on
    chip. The counter counts what the kernel allocates: the output."""
    from repro_torch.kernels import ops
    q, k, v = (torch.ones(1, 64, 2, 16) for _ in range(3))
    with LocalMemory() as mem:
        out = ops.flash_attention(q, k, v)
    assert ops.PLAIN_CALL is None
    assert (mem.peak, mem.live) == (64 * 2 * 16 * 4,) * 2
    assert mem.memory((q, k, v), out)["output_size_in_bytes"] == 8192


def test_local_memory_on_fake_tensors_equals_real_tensors():
    """The dry run counts on fake tensors: a smoke-size train step (the
    forward, autograd's saved tensors, the backward and AdamW) gives the
    same peak and keys on fake tensors as on real ones."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.models import build_model
    from repro_torch.train import trainer as T

    model = build_model(get_smoke_config("qwen3_8b"))
    tc = T.TrainConfig()
    step = T.make_train_step(model, tc)

    def count():
        state = T.init_train_state(model, torch.Generator().manual_seed(0),
                                   tc.opt)
        batch = {"tokens": torch.zeros(2, 32, dtype=torch.int32),
                 "labels": torch.zeros(2, 32, dtype=torch.int32)}
        with LocalMemory() as mem:
            out = step(state, batch)
        return mem.peak, mem.memory((state, batch), out)

    real = count()
    with FakeTensorMode():
        fake = count()
    assert real == fake
    assert real[0] > 0 and real[1]["output_size_in_bytes"] == 12   # metrics


def test_local_storages_counts_a_storage_once():
    x = torch.ones(64)
    assert sum(local_storages((x, x.view(8, 8), x[:8])).values()) == 256


_DTENSOR_CASE = textwrap.dedent("""
    import json, torch
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.launch.roofline import CollectiveRecorder, LocalMemory

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    mesh = init_device_mesh("cpu", (4,))
    with FakeTensorMode():
        # global (8, 16) split over 4 ranks: a (2, 16) float32 shard,
        # 128 B; w (16, 8) whole on every rank, 512 B
        x = DTensor.from_local(torch.zeros(2, 16), mesh, [Shard(0)],
                               run_check=False)
        w = DTensor.from_local(torch.zeros(16, 8), mesh, [Replicate()],
                               run_check=False)
        with CollectiveRecorder() as rec, LocalMemory() as mem:
            h = x @ w                 # (2, 8) shard: 64 B
            full = h.full_tensor()    # all-gather: (8, 8), 256 B
            s = (h * 2).sum()         # (2, 8) 64 B, then a 4 B partial sum
            out = (full, s)
        print(json.dumps({"memory": mem.memory((x, w), out),
                          "peak": mem.peak,
                          "gathers": [c.bytes for c in rec.ops]}))
""")


def test_local_memory_counts_dtensor_local_shards_by_hand():
    """On a fake world of 4 ranks, under FakeTensorMode as in the dry run:
    the shard bytes, never the global shapes (the global (8, 8) result of
    h would be 256 B, its shard is 64 B)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", _DTENSOR_CASE], env=env,
                          capture_output=True, text=True, timeout=120,
                          cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-2000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["gathers"] == [256]
    assert got["peak"] == 64 + 256 + 64 + 4
    assert got["memory"] == {
        "argument_size_in_bytes": 128 + 512,
        "output_size_in_bytes": 256 + 4,
        "temp_size_in_bytes": 64 + 64,     # h and h * 2
        "generated_code_size_in_bytes": None}


def test_dryrun_record_holds_the_four_memory_keys(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "xlstm_125m", "--shape", "decode_32k", "--mesh", "single", "--mode",
         "dense", "--out", str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    with open(tmp_path / "xlstm_125m.decode_32k.single.dense.json") as f:
        rec = json.load(f)
    mem = rec["memory"]
    assert tuple(mem) == KEYS
    assert mem["generated_code_size_in_bytes"] is None
    assert all(mem[k] > 0 for k in KEYS[:3])
    peak = sum(mem[k] for k in KEYS[:3])
    assert f"peak_GiB={peak / 2**30:.3f}" in proc.stdout
