"""The training loss and grads of the Mamba2 families (ssm mamba2-780m,
hybrid zamba2-2.7b) and the encoder-decoder (seamless-m4t-medium) against
the JAX package, with the tolerances and their reasons of
``tests/test_torch_train_model.py`` (which holds the other families; the
two files run on separate workers)."""
import pytest

from test_torch_train_model import check_loss_and_grads
from test_torch_contract import one_thread  # noqa: F401 (the fixture)

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.mark.parametrize("arch", ["mamba2-780m", "zamba2-2.7b",
                                  "seamless-m4t-medium"])
def test_loss_and_grads_match_reference(arch):
    check_loss_and_grads(arch)
