"""The dense family's other three configs (Granite-3-8B tied,
Llama-3-405B, Phi-3-medium-14B, float32 smoke configs, 2 experts) under
the Eq. 27 mixture (``RouterConfig(top_k=2)``, paged + chunked) against
the JAX reference: the ``MixtureSlotServer`` emits exactly the
reference's tokens and finish reasons, one request sampled, seeded (the
helpers and the top-1 twin are ``test_torch_dense_configs.py``'s). The
launchers take each config: ``repro_torch.launch.train --arch`` trains a
2-expert run, which ``repro_torch.launch.serve --arch`` serves; for
Granite, whose checkpoints hold the tied table alone, the reference's
serving launcher gives the same tokens on that run.
"""
import re

import pytest

torch = pytest.importorskip("torch")

from test_torch_dense_configs import (ARCHS, build_dep,  # noqa: E402
                                      check_serving)

from repro.launch import serve as jax_launch_serve  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", ARCHS)
def test_config_serves_as_the_reference_under_the_mixture(arch):
    check_serving(build_dep(arch), "mixture")


@pytest.mark.parametrize("arch", ARCHS)
def test_launchers_train_and_serve_config(arch, tmp_path, capsys,
                                          monkeypatch):
    run = str(tmp_path)
    report = launch_train.main(["--arch", arch, "--steps", "1", "--seq-len",
                                "16", "--batch", "4", "--samples", "64",
                                "--out", run, "--device", "cpu"])
    assert [e["expert"] for e in report["experts"]] == [0, 1]
    base = ["--run", run, "--arch", arch, "--requests", "3",
            "--prompt-len", "10", "--new-tokens", "5", "--slots", "2"]
    got = launch_serve.main(base + ["--device", "cpu"])
    assert got["finish_reasons"] == ["length"] * 3
    if arch != "granite_3_8b":
        return
    capsys.readouterr()
    monkeypatch.setattr("sys.argv", ["serve"] + base + ["--stream"])
    jax_launch_serve.main()
    want = {}
    for rid, toks in re.findall(r"rid=\s*(\d+) \+(\[[^\]]*\])",
                                capsys.readouterr().out):
        want.setdefault(int(rid), []).extend(eval(toks))
    assert got["tokens"] == want and len(want) == 3
