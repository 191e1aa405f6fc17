"""The training forward and gradients against the JAX package, f32 on the
CPU: ``Model.forward``'s logits and MoE auxiliary loss against the JAX
``forward``, and every leaf's gradient of the port's ``loss_fn`` against
``jax.value_and_grad`` of the JAX one, carried across by ``convert``:
gemma3-1b (local and global attention, softcap) and recurrentgemma-2b
(the RG-LRU recurrence), and the forward of granite and gemma3-12b."""
import pytest

from _torch_train_parity import check_forward, check_gradients, one_torch_thread  # noqa: F401

GRAD_ARCHS = ("gemma3-1b", "recurrentgemma-2b")
FORWARD_ARCHS = ("granite-3-8b", "gemma3-12b")


@pytest.mark.parametrize("arch", GRAD_ARCHS + FORWARD_ARCHS)
def test_forward_matches_jax(arch):
    check_forward(arch, grads=arch in GRAD_ARCHS)


@pytest.mark.parametrize("arch", GRAD_ARCHS)
def test_gradients_match_jax(arch):
    check_gradients(arch)
