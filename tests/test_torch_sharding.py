"""The port's sharding rules against the reference's, leaf by leaf.

Every arch of ``PORTED_ARCH_IDS`` × mesh (single (16, 16), multi (2, 16,
16)) × mode (dense, decentralized) × FSDP on and off, at the full configs,
shapes only: the reference's ``PartitionSpec``s are built on a
``jax.sharding.AbstractMesh``, the port's specs on the mesh's
``{axis: size}``. A reference spec is normalised (a 1-tuple of axes is its
name) and both are padded with None to the leaf's rank; each leaf's local
shard shape (``sharding.rules.local_shape``) must equal
``NamedSharding.shard_shape``. Covered: ``tree_shardings`` with and
without the ``dexpert`` lead, both ``state_shardings`` (the trainer's,
``count`` whole, and the dry run's, ``count`` over ``dexpert``),
``data_shardings``, the dry run's ``batch_shardings``, ``cache_pspec_tree``
and ``paged_pool_pspec_tree`` at ``decode_32k``'s shapes,
``stacked_cache_pspec_tree`` over both layouts, ``chunk_carry_pspec_tree``,
``block_table_pspec`` and ``slot_state_pspec_tree``; also the port's cache
and batch shapes against the reference's, ``count_params``, and
``placements``.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh, NamedSharding  # noqa: E402

_ = jax.devices()   # before the reference's dry run sets its device flag

from repro.configs.base import INPUT_SHAPES  # noqa: E402
from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.launch import dryrun as jdryrun  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.models.params import count_params as jcount  # noqa: E402
from repro.models.params import tree_shardings as jtree_shardings  # noqa: E402,E501
from repro.sharding import rules as JR  # noqa: E402
from repro.train import trainer as jtrainer  # noqa: E402
from repro_torch.configs.base import PORTED_ARCH_IDS, get_config  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.params import count_params, tree_shardings  # noqa: E402,E501
from repro_torch.sharding import rules as R  # noqa: E402
from repro_torch.train import trainer  # noqa: E402

MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}
K = 2
DECODE = INPUT_SHAPES["decode_32k"]
BLOCK = 16


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _norm(entry):
    if isinstance(entry, (tuple, list)):
        entry = tuple(entry)
        return None if not entry else entry[0] if len(entry) == 1 else entry
    return entry


def _padded(spec, ndim):
    spec = tuple(_norm(e) for e in spec)
    return spec + (None,) * (ndim - len(spec))


def _check(ref, port, shapes, sizes, where=""):
    """Walk the reference's tree of NamedShardings beside the port's tree
    of specs and the leaves' shapes (tuples or anything with .shape)."""
    if isinstance(ref, dict):
        assert set(ref) == set(port), (where, set(ref), set(port))
        for k in ref:
            _check(ref[k], port[k], shapes[k], sizes, f"{where}/{k}")
        return
    if isinstance(ref, (tuple, list)) and not isinstance(ref,
                                                        NamedSharding):
        assert len(ref) == len(port), where
        for i, (r, p) in enumerate(zip(ref, port)):
            _check(r, p, shapes[i], sizes, f"{where}/{i}")
        return
    shape = tuple(shapes) if isinstance(shapes, tuple) else \
        tuple(shapes.shape)
    want = _padded(ref.spec, len(shape))
    got = _padded(port, len(shape))
    assert got == want, (where, shape, got, want)
    assert R.local_shape(shape, port, sizes) == \
        tuple(ref.shard_shape(shape)), (where, shape, port)


def _same_shapes(ref, port, where=""):
    if isinstance(ref, dict):
        assert set(ref) == set(port), where
        for k in ref:
            _same_shapes(ref[k], port[k], f"{where}/{k}")
    elif isinstance(ref, (tuple, list)):
        for i, (r, p) in enumerate(zip(ref, port)):
            _same_shapes(r, p, f"{where}/{i}")
    else:
        assert tuple(ref.shape) == tuple(port.shape), where
        assert str(jnp.dtype(ref.dtype)) == \
            str(port.dtype).replace("torch.", ""), where


def _spec_shapes(specs, lead=()):
    if isinstance(specs, dict):
        return {k: _spec_shapes(v, lead) for k, v in specs.items()}
    return lead + tuple(specs.shape)


def _stacked(shapes):
    """Insert the K dim at axis 1 of every reference leaf."""
    return jax.tree.map(lambda s: jax.ShapeDtypeStruct(
        s.shape[:1] + (K,) + s.shape[1:], s.dtype), shapes)


CASES = [(a, m, mode, fsdp) for a in PORTED_ARCH_IDS for m in MESHES
         for mode in ("dense", "decentralized") for fsdp in (True, False)]


@pytest.mark.parametrize("arch,mesh_name,mode,fsdp", CASES)
def test_port_specs_equal_the_reference(arch, mesh_name, mode, fsdp):
    shape, names = MESHES[mesh_name]
    jmesh = AbstractMesh(shape, names)
    sizes = dict(zip(names, shape))
    multi, dec = mesh_name == "multi", mode == "decentralized"
    jr = JR.logical_rules(multi_pod=multi, decentralized=dec, fsdp=fsdp)
    pr = R.logical_rules(multi_pod=multi, decentralized=dec, fsdp=fsdp)
    jm, pm = jbuild(jget_config(arch)), build_model(get_config(arch))
    specs = pm.param_specs()
    k = K if dec else 0

    # params, without and with the expert lead
    _check(jtree_shardings(jm.param_specs(), jr, jmesh),
           tree_shardings(specs, pr, sizes), _spec_shapes(specs), sizes)
    _check(jtree_shardings(jm.param_specs(), jr, jmesh, ("dexpert",)),
           tree_shardings(specs, pr, sizes, ("dexpert",)),
           _spec_shapes(specs, (K,)), sizes)

    # both train-state variants (the port's state has master leaves only
    # for low-precision params; the specs cover them all)
    lead = (K,) if k else ()
    st_shapes = {"params": _spec_shapes(specs, lead),
                 "opt": {"m": _spec_shapes(specs, lead),
                         "v": _spec_shapes(specs, lead),
                         "master": _spec_shapes(specs, lead),
                         "count": lead}}
    _check(jtrainer.state_shardings(jm, jr, jmesh, k),
           trainer.state_shardings(pm, pr, sizes, k), st_shapes, sizes)
    jst, jscalar = jdryrun.state_shardings(jm, jr, jmesh, k)
    pst, pscalar = dryrun.state_shardings(pm, pr, sizes, k)
    _check(jst, pst, st_shapes, sizes)
    _check(jscalar, pscalar, lead, sizes)

    # the batch: the rules' data specs and the dry run's batch specs
    train = INPUT_SHAPES["train_4k"]
    jb, pb = (jdryrun.batch_shapes(jm.cfg, train, k),
              dryrun.batch_shapes(pm.cfg, train, k))
    _same_shapes(jb, pb)
    _check(JR.data_shardings(jr, jmesh, jm.cfg, "train", k),
           R.data_shardings(pr, sizes, pm.cfg, "train", k), jb, sizes)
    _check(jdryrun.batch_shardings(jr, jmesh, jm.cfg, jb, k),
           dryrun.batch_shardings(pr, sizes, pm.cfg, pb, k), jb, sizes)

    # the decode caches at decode_32k's shapes
    B, S = DECODE.global_batch, DECODE.seq_len
    n_blocks = B * S // BLOCK
    jc, pc = jm.cache_shapes(B, S), pm.cache_shapes(B, S)
    _same_shapes(jc, pc)
    _check(JR.cache_pspec_tree(jc, jr, jmesh),
           R.cache_pspec_tree(pc, pr, sizes), jc, sizes)
    jp = jm.paged_cache_shapes(B, n_blocks, BLOCK, S)
    pp = pm.paged_cache_shapes(B, n_blocks, BLOCK, S)
    _same_shapes(jp, pp)
    jseq = jm.cache_spec(BLOCK).paged.seq_axes
    pseq = pm.cache_spec(BLOCK).paged.seq_axes
    assert jax.tree.leaves(jseq) == jax.tree.leaves(pseq)
    _check(JR.paged_pool_pspec_tree(jp, jr, jmesh, jseq),
           R.paged_pool_pspec_tree(pp, pr, sizes, pseq), jp, sizes)
    # stacked over both layouts
    js, ps = _stacked(jc), pm.cache_shapes(B, S, experts=K)
    _same_shapes(js, ps)
    _check(JR.stacked_cache_pspec_tree(js, jr, jmesh),
           R.stacked_cache_pspec_tree(ps, pr, sizes), js, sizes)
    jsp = _stacked(jp)
    psp = pm.paged_cache_shapes(B, n_blocks, BLOCK, S, experts=K)
    _same_shapes(jsp, psp)
    _check(JR.stacked_cache_pspec_tree(jsp, jr, jmesh, jseq),
           R.stacked_cache_pspec_tree(psp, pr, sizes, pseq), jsp, sizes)
    # one request's carry, the tables and the slot state
    jcarry, pcarry = jm.cache_shapes(1, S), pm.cache_shapes(1, S)
    _check(JR.chunk_carry_pspec_tree(jcarry, jr, jmesh),
           R.chunk_carry_pspec_tree(pcarry, pr, sizes), jcarry, sizes)
    tables = (B, S // BLOCK)
    _check(JR.block_table_pspec(jr, jmesh), R.block_table_pspec(pr, sizes),
           tables, sizes)
    rows = {"tok": (B,), "pos": (B,), "tables": tables, "temps": (B,),
            "stop_ids": (B, 4)}
    jstate = {n: jax.ShapeDtypeStruct(s, jnp.int32) for n, s in rows.items()}
    pstate = {n: torch.empty(s, dtype=torch.int32, device="meta")
              for n, s in rows.items()}
    _check(JR.slot_state_pspec_tree(jstate, jr, jmesh),
           R.slot_state_pspec_tree(pstate, pr, sizes), jstate, sizes)


@pytest.mark.parametrize("arch", PORTED_ARCH_IDS)
def test_count_params_equals_the_reference(arch):
    assert count_params(build_model(get_config(arch)).param_specs()) == \
        jcount(jbuild(jget_config(arch)).param_specs())


@pytest.mark.parametrize("arch", ["qwen3_8b", "zamba2_2_7b"])
def test_paged_pool_layout_with_names_normalised(arch):
    """The invariants of the reference's ``test_paged_pool_pspec_layout``
    on the port: pool leaves split their physical-block axis over the
    kv-cache batch axes (the port writes ``("data",)`` as ``"data"`` —
    the reference's test compares the two forms and fails) and never a
    block's interior; direct leaves keep their contiguous placement; the
    stacked variant puts ``dexpert`` at axis 1."""
    from repro_torch.configs import get_smoke_config
    sizes = {"pod": 1, "data": 1, "model": 1}
    rules = R.logical_rules(multi_pod=True, decentralized=True)
    model = build_model(get_smoke_config(arch))
    seq = model.cache_spec(8).paged.seq_axes
    shapes = model.paged_cache_shapes(4, 16, 8, 32)
    specs = R.paged_pool_pspec_tree(shapes, rules, sizes, seq)
    plain = R.cache_pspec_tree(model.cache_shapes(4, 32), rules, sizes)
    batch = R.norm_axes(rules["kv_cache_batch"])
    assert batch == "data"
    for name, s_ax in seq.items():
        spec = specs[name]
        if s_ax < 0:
            assert spec == plain[name]
        else:
            assert spec[s_ax - 1] == batch and spec[s_ax] is None
    stacked = R.stacked_cache_pspec_tree(
        model.paged_cache_shapes(4, 16, 8, 32, experts=2), rules, sizes, seq)
    for name in seq:
        assert stacked[name][1] == "pod"


def test_placements_follow_the_mesh_order():
    from torch.distributed.tensor import Replicate, Shard
    names = ("pod", "data", "model")
    assert R.placements(("pod", None, "data", "model", None), names) == \
        [Shard(0), Shard(2), Shard(3)]
    # a dim over (pod, data): split over both, pod outermost
    assert R.placements((("pod", "data"), None), names) == \
        [Shard(0), Shard(0), Replicate()]
    assert R.placements((), names) == [Replicate()] * 3
    with pytest.raises(ValueError, match="mesh's axis order"):
        R.placements((("data", "pod"),), names)
    with pytest.raises(ValueError, match="shards two dims"):
        R.placements(("data", "data"), names)
    sizes = dict(zip(names, (2, 16, 16)))
    assert R.local_shape((512, 3), (("pod", "data"), None), sizes) == (16, 3)
    with pytest.raises(ValueError, match="does not divide"):
        R.local_shape((10,), ("data",), sizes)


def test_cache_shapes_are_meta_and_match_the_allocation():
    from repro_torch.configs import get_smoke_config
    for arch in ("qwen3_8b", "zamba2_2_7b", "xlstm_125m", "whisper_small"):
        model = build_model(get_smoke_config(arch))
        meta = model.cache_shapes(3, 32, experts=2)
        real = model.init_cache(3, 32, device="cpu", experts=2)
        for a, b in zip(jax.tree.leaves(meta), jax.tree.leaves(real)):
            assert a.device.type == "meta"
            assert a.shape == b.shape and a.dtype == b.dtype
        meta = model.paged_cache_shapes(3, 12, 8, 32)
        real = model.init_paged_cache(3, 12, 8, 32, device="cpu")
        for a, b in zip(jax.tree.leaves(meta), jax.tree.leaves(real)):
            assert a.shape == b.shape and a.dtype == b.dtype
