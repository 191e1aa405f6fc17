"""The training forward and gradients against the JAX package, f32 on the
CPU: ``Model.forward``'s logits and MoE auxiliary loss against the JAX
``forward``, and every leaf's gradient of the port's ``loss_fn`` against
``jax.value_and_grad`` of the JAX one, carried across by ``convert``:
xlstm-350m (mLSTM, sLSTM; its sLSTM scan is the JAX package's slowest
compile, so it has a file of its own)."""
import pytest

from _torch_train_parity import check_forward, check_gradients, one_torch_thread  # noqa: F401

GRAD_ARCHS = ("xlstm-350m",)
FORWARD_ARCHS = ()


@pytest.mark.parametrize("arch", GRAD_ARCHS + FORWARD_ARCHS)
def test_forward_matches_jax(arch):
    check_forward(arch, grads=arch in GRAD_ARCHS)


@pytest.mark.parametrize("arch", GRAD_ARCHS)
def test_gradients_match_jax(arch):
    check_gradients(arch)
