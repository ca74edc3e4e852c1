"""The port's configs equal the reference's field by field."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro.configs import base as jbase  # noqa: E402
from repro_torch.configs import base  # noqa: E402


@pytest.mark.parametrize("getter,arch", [
    pytest.param(getter, arch,
                 id=getter if arch == "qwen3_8b" else f"{getter}-{arch}")
    for arch in base.PORTED_ARCH_IDS
    for getter in ("get_config", "get_smoke_config")])
def test_qwen3_configs_match_reference(getter, arch):
    """Every ported config (named after the first, qwen3_8b)."""
    got = getattr(base, getter)(arch)
    want = getattr(jbase, getter)(arch)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.head_dim == want.head_dim
    assert got.padded_vocab == want.padded_vocab
    assert got.cdtype == getattr(torch, str(want.cdtype))
    assert got.pdtype == getattr(torch, str(want.pdtype))


def test_input_shapes_match_reference():
    assert {k: dataclasses.asdict(v) for k, v in base.INPUT_SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in jbase.INPUT_SHAPES.items()}


def test_unported_arch_is_refused():
    """Every reference arch is ported; an unknown id is refused with the
    port's message."""
    assert sorted(base.PORTED_ARCH_IDS) == sorted(jbase.ARCH_IDS)
    with pytest.raises(ValueError, match="not ported to repro_torch yet"):
        base.get_config("no_such_arch")
