"""Port parity, training slice: ``loss_fn`` and every gradient leaf against
the reference's for the MoE, SSM and hybrid architectures at smoke widths
in float32, as ``test_torch_train_grads.py`` sets out (tolerances, the MoE
gate-gap check on this seed)."""
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from test_torch_train_grads import check_loss_and_gradients  # noqa: E402


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "moonshot-v1-16b-a3b", "mamba2-1.3b",
                                  "zamba2-1.2b"])
def test_loss_and_gradients_match_reference(arch, monkeypatch):
    check_loss_and_gradients(arch, monkeypatch)
