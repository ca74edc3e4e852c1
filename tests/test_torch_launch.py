"""Twins of ``tests/test_launch.py`` and of the roofline and rules tests in
``tests/test_substrate.py`` for the port's ``launch/dryrun.py``,
``launch/roofline.py`` and ``sharding/rules.py``, against the reference's
values: ``_if_divisible``, ``shape_cfg``, the skip matrix, ``probe_cfg``'s
depths, ``model_flops``, ``RooflineReport`` (at the H100's data-sheet
figures), ``active_params`` for every arch, ``logical_rules`` for every
mode, and ``collective_summary`` over recorded collectives.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

_ = jax.devices()   # before the reference's dry run sets its device flag

from repro.configs.base import INPUT_SHAPES  # noqa: E402
from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.launch import dryrun as jdryrun  # noqa: E402
from repro.launch import roofline as jroofline  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.models.params import count_params as jcount  # noqa: E402
from repro.sharding import rules as JR  # noqa: E402
from repro_torch.configs.base import PORTED_ARCH_IDS, get_config  # noqa: E402
from repro_torch.launch import dryrun, roofline  # noqa: E402
from repro_torch.launch.mesh import pod_of_device  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.params import ParamSpec, count_params, spec_pspec  # noqa: E402,E501
from repro_torch.sharding import rules as R  # noqa: E402


class FakeMesh:
    shape = {"data": 16, "model": 16}


def test_if_divisible():
    m = FakeMesh()
    for axes, dim in [(("data",), 256), (("data",), 1), ("model", 92_553),
                      ("model", 92_672), (("data", "model"), 512),
                      (None, 64)]:
        assert dryrun._if_divisible(m, axes, dim) == \
            jdryrun._if_divisible(m, axes, dim)
    assert dryrun._if_divisible(m, ("data", "model"), 512) == \
        ("data", "model")
    assert dryrun._if_divisible(m, "model", 92_553) is None


def test_shape_cfg_long_decode_window():
    cfg = get_config("qwen3_8b")
    assert cfg.sliding_window == 0
    long = dryrun.shape_cfg(cfg, INPUT_SHAPES["long_500k"])
    assert long.sliding_window == dryrun.LONG_DECODE_WINDOW == \
        jdryrun.LONG_DECODE_WINDOW
    x = dryrun.shape_cfg(get_config("xlstm_125m"), INPUT_SHAPES["long_500k"])
    assert x.sliding_window == 0
    for arch in PORTED_ARCH_IDS:
        for shape in INPUT_SHAPES.values():
            assert dryrun.shape_cfg(get_config(arch), shape).sliding_window \
                == jdryrun.shape_cfg(jget_config(arch), shape).sliding_window


def test_skip_matrix():
    for arch in PORTED_ARCH_IDS:
        for shape in INPUT_SHAPES.values():
            assert dryrun.is_skipped(arch, shape) == \
                jdryrun.is_skipped(arch, shape)
    assert dryrun.is_skipped("whisper_small", INPUT_SHAPES["long_500k"])


@pytest.mark.parametrize("arch,G,expect_layers", [
    ("qwen3_8b", 2, 2),
    ("xlstm_125m", 2, 8),        # slstm_every=4 → 4 layers per group
    ("zamba2_2_7b", 2, 12),      # shared_attn_every=6
    ("whisper_small", 1, 1),
])
def test_probe_cfg_depth_mapping(arch, G, expect_layers):
    cfg = dryrun.probe_cfg(get_config(arch), G)
    ref = jdryrun.probe_cfg(jget_config(arch), G)
    assert cfg.unroll and cfg.n_layers == expect_layers == ref.n_layers
    assert cfg.n_enc_layers == ref.n_enc_layers
    assert build_model(cfg).n_groups == G


def test_model_flops_and_h100_report():
    cfg = get_config("qwen3_8b")
    f = roofline.model_flops(cfg, 8_000_000_000, 1_000_000, "train")
    assert f == pytest.approx(6 * 8e9 * 1e6) == jroofline.model_flops(
        jget_config("qwen3_8b"), 8_000_000_000, 1_000_000, "train")
    assert roofline.model_flops(cfg, 10, 3, "prefill") == 60.0
    # the H100 SXM data sheet's dense bf16 peak, HBM3 rate and links
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW) == (989e12, 3.35e12)
    assert (roofline.NVLINK_BW, roofline.IB_BW) == (450e9, 50e9)
    r = roofline.RooflineReport(
        arch="a", shape="s", mesh="m", mode="d",
        flops_per_device=989e12, bytes_per_device=3.35e12,
        collective_bytes=25e9, model_flops_per_device=494.5e12).finalize()
    assert r.compute_s == pytest.approx(1.0)
    assert r.memory_s == pytest.approx(1.0)
    assert r.collective_s == pytest.approx(0.5)      # over InfiniBand
    assert r.useful_flops_ratio == pytest.approx(0.5)
    assert r.bottleneck in ("compute", "memory")
    nv = dataclasses.replace(r, link_bw=roofline.NVLINK_BW).finalize()
    assert nv.collective_s == pytest.approx(25e9 / 450e9)


@pytest.mark.parametrize("arch", PORTED_ARCH_IDS)
def test_active_params_equal_the_reference(arch):
    pm, jm = build_model(get_config(arch)), jbuild(jget_config(arch))
    total = count_params(pm.param_specs())
    assert total == jcount(jm.param_specs())
    assert roofline.active_params(pm.cfg, total, pm) == \
        jroofline.active_params(jm.cfg, total, jm)


def test_moe_active_params():
    cfg = get_config("qwen3_moe_235b_a22b")
    model = build_model(cfg)
    total = count_params(model.param_specs())
    active = roofline.active_params(cfg, total, model)
    assert 0.02 * total < active < 0.25 * total


@pytest.mark.parametrize("multi", [True, False])
@pytest.mark.parametrize("decentralized", [True, False])
@pytest.mark.parametrize("fsdp", [True, False])
def test_logical_rules_equal_the_reference(multi, decentralized, fsdp):
    kw = dict(multi_pod=multi, decentralized=decentralized, fsdp=fsdp)
    assert R.logical_rules(**kw) == JR.logical_rules(**kw)


def test_logical_rules_modes():
    dense_mp = R.logical_rules(multi_pod=True, decentralized=False)
    dec_mp = R.logical_rules(multi_pod=True, decentralized=True)
    assert dense_mp["embed"] == ("pod", "data")       # FSDP crosses pods
    assert dense_mp["dexpert"] is None
    assert dec_mp["embed"] == ("data",)               # FSDP inside a pod
    assert dec_mp["dexpert"] == "pod"                 # expert axis = pod


def test_param_spec_sharding_divisibility():
    rules = {"embed": ("data",), "mlp": "model"}
    # 100 % 16 != 0 → embed rule dropped; 160 % 16 == 0 → kept
    assert spec_pspec(ParamSpec((100, 160), ("embed", "mlp")), rules,
                      FakeMesh()) == (None, "model")
    assert spec_pspec(ParamSpec((128, 160), ("embed", "mlp")), rules,
                      FakeMesh()) == ("data", "model")


def test_collective_summary_of_recorded_entries():
    """The recorder's entries for the collectives of the reference's HLO
    fixture (``test_substrate.py``) give the reference's summary: one
    all-gather over a group spanning pods of 2, one all-reduce inside pod
    0, one permute with no group read."""
    hlo = """
  %ag = bf16[16,1024]{1,0} all-gather(%p0), channel_id=1, replica_groups=[16,16]<=[16,16]T(1,0), dimensions={0}
  %ar = f32[128]{0} all-reduce(%x), replica_groups={{0,1},{2,3}}, to_apply=%sum
  %cp = f32[2,4]{1,0} collective-permute(%y), source_target_pairs={{0,1}}
"""
    C = roofline.CollectiveOp
    ops = [C("all-gather", 16 * 1024 * 2, list(range(0, 256, 16)), True),
           C("all-reduce", 128 * 4, [0, 1], False),
           C("collective-permute", 2 * 4 * 4, None, None)]
    assert roofline.collective_summary(ops) == \
        jroofline.collective_summary(hlo, pod_size=2)
    assert roofline.collective_summary([]) == {
        "n_collectives": 0, "bytes_per_op": {}, "total_bytes": 0,
        "cross_pod_bytes": 0, "cross_pod_ops": 0}


def test_link_rate_of_the_groups():
    C = roofline.CollectiveOp
    inside = [C("all-reduce", 4, [8, 9, 10, 15], False)]
    assert roofline.link_bw(inside) == roofline.NVLINK_BW
    across = inside + [C("all-gather", 4, [0, 16], False)]
    assert roofline.link_bw(across) == roofline.IB_BW


def test_pod_of_device():
    for d in (0, 255, 256, 511):
        assert pod_of_device(d, multi_pod=True) == d // 256
        assert pod_of_device(d, multi_pod=False) == 0
