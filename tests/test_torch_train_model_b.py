"""The training forward and gradients against the JAX package, f32 on the
CPU: ``Model.forward``'s logits and MoE auxiliary loss against the JAX
``forward``, and every leaf's gradient of the port's ``loss_fn`` against
``jax.value_and_grad`` of the JAX one, carried across by ``convert``:
llama4-scout (the MoE auxiliary loss), whisper-medium (encoder,
cross-attention) and paligemma-3b (the prefix), and the forward of qwen1.5
and arctic."""
import pytest

from _torch_train_parity import check_forward, check_gradients, one_torch_thread  # noqa: F401

GRAD_ARCHS = ("llama4-scout-17b-a16e", "whisper-medium", "paligemma-3b")
FORWARD_ARCHS = ("qwen1.5-32b", "arctic-480b")


@pytest.mark.parametrize("arch", GRAD_ARCHS + FORWARD_ARCHS)
def test_forward_matches_jax(arch):
    check_forward(arch, grads=arch in GRAD_ARCHS)


@pytest.mark.parametrize("arch", GRAD_ARCHS)
def test_gradients_match_jax(arch):
    check_gradients(arch)
