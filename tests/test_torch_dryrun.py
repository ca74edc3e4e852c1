"""The port's dry run end to end (``repro_torch.launch.dryrun``, twin of
``tests/test_dryrun_subprocess.py``): one case, in a subprocess (the fake
512-rank process group must not leak into the test process), in both
modes on the multi-pod mesh, with the depth probe. It checks the record's
contract, the paper's zero-cross-pod invariant of decentralized training
from the recorded collectives, the dense control that crosses pods, and
the model FLOPs against the reference's formula at the reference's
counts.
"""
import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH, SHAPE = "internvl2_2b", "train_4k"


@pytest.mark.parametrize("mode", ["decentralized", "dense"])
def test_dryrun_multi_pod_case(tmp_path, mode):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", ARCH,
         "--shape", SHAPE, "--mesh", "multi", "--mode", mode, "--probe",
         "--out", str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    with open(tmp_path / f"{ARCH}.{SHAPE}.multi.{mode}.probe.json") as f:
        rec = json.load(f)
    assert rec["status"] == "ok"
    assert rec["n_devices"] == 512
    roof = rec["roofline"]
    assert roof["bottleneck"] in ("compute", "memory", "collective")
    assert rec["cost"]["flops"] > 0
    coll = rec["collectives"]
    if mode == "decentralized":
        assert coll["cross_pod_bytes"] == 0 and coll["cross_pod_ops"] == 0
        assert coll["total_bytes"] > 0          # it communicates in-pod
    else:
        assert coll["cross_pod_ops"] > 0 and coll["cross_pod_bytes"] > 0

    import jax
    _ = jax.devices()
    from repro.configs.base import INPUT_SHAPES, get_config
    from repro.launch.roofline import active_params, model_flops
    from repro.models import build_model
    from repro.models.params import count_params
    cfg = get_config(ARCH)
    model = build_model(cfg)
    total = count_params(model.param_specs())
    act = active_params(cfg, total, model)
    shape = INPUT_SHAPES[SHAPE]
    assert (rec["params_total"], rec["params_active"]) == (total, act)
    want = model_flops(cfg, act, shape.global_batch * shape.seq_len,
                       shape.kind) / 512
    assert roof["model_flops_per_device"] == pytest.approx(want, rel=1e-12)
