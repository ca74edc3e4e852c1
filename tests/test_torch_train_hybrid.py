"""The port's hybrid-family training (Zamba2: Mamba2 groups and one shared
attention block) against the JAX reference, on the float32 ``zamba2_2_7b``
smoke config at 4 layers, so 2 groups share the attention block and its
gradient is the sum of both groups' (the reference's scan sums it; the
port's per-group checkpoint closes over the block). Weights cross from the
reference's init (``repro_torch.weights``); rows of 40 tokens pad the last
of 3 scan chunks of 16.

Tolerances, float32:
* loss 1e-5 relative (measured 1.4e-7);
* every gradient leaf within ``GRAD_ATOL`` = 1e-4 of its largest element,
  where the dense rule says 2e-5: measured 1.6e-5 (embed) unmasked and
  2.7e-5 (``blocks/mamba/A_log``, summed over every position and head of
  4 layers) masked, under each remat, and 4.9e-5
  (``shared_attn/ffn/w_down``) on the train step's first batch. The gap
  is float32 rounding: the port is 1.5e-5 from the reference's x64
  gradient where the reference's own float32 leaves are 6.7e-6 from it,
  and the two packages' float64 runs differ by 1.9e-5 too, since both
  keep the scan's products and states, the norms and the logits in
  float32 (``check_x64_gap`` bounds the port's distance by twice the
  reference's plus 2e-5);
* the train steps as ``torch_train_parity.check_train_steps`` states,
  with ``GRAD_ATOL``;
* the scan's training form in bf16 against the reference's jnp branch in
  bf16: ``torch_train_parity.SCAN_BF16_ATOL`` (there with what was
  measured, and how far the kernel's plain version would miss).

The quickstart twin runs here (its dense model trains ``QUICKSTART_STEPS``
steps a model); the end-to-end xLSTM twins run in
``test_torch_train_ssm.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_train_parity import (CASES, Setup, check_remat_bit_identical,  # noqa: E402,E501
                                check_scan_bf16, check_scan_routes,
                                check_train_path, check_train_steps,
                                check_x64_gap, port_loss_and_grads,
                                worst_leaf)

ARCH = "zamba2_2_7b"
GRAD_ATOL = 1e-4
QUICKSTART_STEPS = 12


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
    """The loss and every gradient leaf, the shared block's among them,
    against ``jax.value_and_grad`` of the reference's ``Model.loss`` at
    the same remat."""
    assert setup.model(remat).n_groups == 2
    jl, want = setup.jax_loss_and_grads(remat, masked)
    loss, got = port_loss_and_grads(setup.model(remat), setup.params,
                                    setup.batch(masked))
    assert float(loss) == pytest.approx(jl, rel=1e-5)
    worst = worst_leaf(got, want)
    assert worst[0] <= GRAD_ATOL, worst
    assert any(p.startswith("shared_attn/") for p in got)


def test_float32_gap_is_rounding(setup):
    check_x64_gap(setup)


def test_remat_policies_are_bit_identical(setup):
    check_remat_bit_identical(setup)


def test_train_steps_match_reference(setup):
    check_train_steps(setup, grad_atol=GRAD_ATOL)


def test_training_scan_matches_reference_bf16(setup):
    """The scan's training form at Mamba2's smoke shapes (q = C, k = B·dt
    broadcast over 4 heads of dk = N = 16, v the heads of 64)."""
    cfg = setup.cfg
    check_scan_bf16(cfg, H=cfg.n_heads, dk=cfg.ssm.state,
                    dv=cfg.ssm.expand * cfg.d_model // cfg.n_heads)


def test_kernel_seam_scan_only_without_grad(setup, monkeypatch):
    check_scan_routes(setup, monkeypatch)


def test_train_path_rehearses_on_cpu():
    check_train_path(ARCH)


def test_quickstart_twin_runs_on_cpu():
    """``repro_torch.examples.quickstart --device cpu`` at
    ``QUICKSTART_STEPS`` steps a model: the theorem's residuals within
    1e-12, balanced shards, finite losses and NLLs, 8 generated tokens a
    request."""
    from repro_torch.examples import quickstart
    out = quickstart.run("cpu", QUICKSTART_STEPS, log=lambda *_: None)
    assert out["residual"] < 1e-12
    assert out["shards"] == [256, 256]
    assert np.isfinite([out["dense_loss"], *out["expert_losses"],
                        out["dense_nll"], out["ensemble_nll"]]).all()
    assert out["tokens"].shape == (32, 8)
