"""The port's ssm-family training (xLSTM: groups of mLSTM layers, each
closed by an sLSTM layer) against the JAX reference, on the float32
``xlstm_125m`` smoke config at 4 layers (2 groups of one mLSTM and one
sLSTM layer). Weights cross from the reference's init
(``repro_torch.weights``); rows of 40 tokens pad the last of 3 scan
chunks of 16. The sLSTM runs its per-position loop under autograd, as
the reference's ``lax.scan`` does.

Tolerances, float32:
* loss 1e-5 relative (measured 2.1e-7);
* every gradient leaf within ``GRAD_ATOL`` = 5e-4 of its largest
  element, where the dense rule says 2e-5: measured 1.9e-4
  (``blocks/slstm/b_gates``) unmasked and 1.2e-4 (``blocks/mlstm/w_qkv``)
  masked, under each remat, and 2.0e-4 (``blocks/mlstm/w_out``, m after
  the first train step). The gap is float32 rounding, which this random
  model magnifies (the exponential gating of 40 sLSTM steps): the
  reference's own float32 gradient is 7.6e-4–9.4e-4 of a leaf's largest
  element from its x64 gradient, and the port's is no farther (1.01x at
  most); ``check_x64_gap`` bounds the port's distance by twice the
  reference's plus 2e-5;
* the train steps as ``torch_train_parity.check_train_steps`` states,
  with ``GRAD_ATOL``;
* the scan's training form in bf16 at mLSTM's smoke shapes:
  ``torch_train_parity.SCAN_BF16_ATOL``.

The end-to-end twins run here on the CPU: ``train_decentralized`` (the
reference's xLSTM-125M default, ``EXAMPLE_STEPS`` steps) into a run dir,
then ``serve_ensemble`` on it, each a subprocess of the port's launchers
as the reference's scripts are.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_train_parity import (CASES, Setup, check_remat_bit_identical,  # noqa: E402,E501
                                check_scan_bf16, check_scan_routes,
                                check_train_path, check_train_steps,
                                check_x64_gap, port_loss_and_grads,
                                worst_leaf)

ARCH = "xlstm_125m"
GRAD_ATOL = 5e-4
EXAMPLE_STEPS = 3


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    return Setup(ARCH, n_layers=4)


@pytest.mark.parametrize("remat,masked", CASES)
def test_loss_and_gradients_match_reference(setup, remat, masked):
    """The loss and every gradient leaf, the sLSTM's among them, against
    ``jax.value_and_grad`` of the reference's ``Model.loss`` at the same
    remat."""
    assert setup.model(remat).n_groups == 2
    jl, want = setup.jax_loss_and_grads(remat, masked)
    loss, got = port_loss_and_grads(setup.model(remat), setup.params,
                                    setup.batch(masked))
    assert float(loss) == pytest.approx(jl, rel=1e-5)
    worst = worst_leaf(got, want)
    assert worst[0] <= GRAD_ATOL, worst
    assert bool(np.abs(got["blocks/slstm/r_gates"]).max() > 0)


def test_float32_gap_is_rounding(setup):
    check_x64_gap(setup, masked=False)


def test_remat_policies_are_bit_identical(setup):
    check_remat_bit_identical(setup)


def test_train_steps_match_reference(setup):
    check_train_steps(setup, grad_atol=GRAD_ATOL)


def test_training_scan_matches_reference_bf16(setup):
    """The scan's training form at mLSTM's smoke shapes (4 heads of 64,
    v with the normalizer's column: 65)."""
    dh = setup.cfg.ssm.expand * setup.cfg.d_model // setup.cfg.n_heads
    check_scan_bf16(setup.cfg, H=setup.cfg.n_heads, dk=dh, dv=dh + 1)


def test_kernel_seam_scan_only_without_grad(setup, monkeypatch):
    check_scan_routes(setup, monkeypatch)


def test_train_path_rehearses_on_cpu():
    check_train_path(ARCH)


def _report(out: str) -> dict:
    """The launcher's indented JSON report in its standard output."""
    return json.loads(out[out.index("\n{\n") + 1:out.index("\n}\n") + 2])


def test_example_twins_train_then_serve_on_cpu(tmp_path, capfd,
                                               monkeypatch):
    """``repro_torch.examples.train_decentralized --device cpu`` trains
    the reference script's xLSTM-125M default (2 experts, batch 16,
    ``EXAMPLE_STEPS`` steps) into a run dir that
    ``repro_torch.examples.serve_ensemble --device cpu`` serves: 16
    requests, 24 new tokens each."""
    from repro_torch.examples import serve_ensemble, train_decentralized
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    run = str(tmp_path)
    assert train_decentralized.main(["--steps", str(EXAMPLE_STEPS),
                                     "--out", run, "--device", "cpu"]) == 0
    with open(f"{run}/train_summary.json") as f:
        summary = json.load(f)
    assert summary["args"]["arch"] == ARCH
    assert [e["expert"] for e in summary["experts"]] == [0, 1]
    assert all(np.isfinite(e["final_loss"]) for e in summary["experts"])
    capfd.readouterr()
    assert serve_ensemble.main(["--run", run, "--device", "cpu"]) == 0
    report = _report(capfd.readouterr().out)
    assert report["device"] == "cpu" and report["requests"] == 16
    assert report["finish_reasons"] == ["length"] * 16
    assert sum(report["requests_per_expert"]) == 16
