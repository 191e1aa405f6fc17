"""The flash attention's gradient: ``FlashAttention`` (the kernel's forward,
the plain version's backward, recomputed) against ``jax.grad`` of the JAX
``flash_attention``, for every mask the kernel has (causal, window, full,
cross ``Sq != Sk``, GQA, softcap, prefix); f32 on the CPU.  And the
serving path's promise: without a gradient the call builds no graph."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_train_parity import rel, one_torch_thread  # noqa: F401

from repro.models.layers import flash_attention as jax_flash
from repro_torch.kernels.flash_attn.ops import FlashAttention, flash_attention_kernel
from repro_torch.models.layers import flash_attention

# f32: the JAX blockwise online softmax and its gradient against the plain
# version's whole score matrix
GRAD_TOL = 1e-5

# (B, Sq, Sk, Hq, Hkv, hd, kind, window, prefix_len, softcap)
ATTN_CASES = {
    "causal GQA": (2, 24, 24, 4, 2, 16, "causal", 0, 0, 0.0),
    "window": (2, 24, 24, 4, 1, 16, "window", 8, 0, 0.0),
    "window softcap": (1, 24, 24, 4, 2, 16, "window", 8, 0, 30.0),
    "full MHA": (1, 20, 20, 4, 4, 16, "full", 0, 0, 0.0),
    "cross Sq != Sk": (2, 9, 24, 4, 4, 16, "full", 0, 0, 0.0),
    "softcap": (1, 24, 24, 4, 2, 16, "causal", 0, 0, 30.0),
    # the prefix inside the JAX key block (ROADMAP C-ref 12)
    "prefix": (2, 24, 24, 4, 1, 16, "prefix", 0, 6, 0.0),
}


@pytest.mark.parametrize("case", ATTN_CASES)
def test_flash_function_gradients_match_jax(case):
    B, Sq, Sk, Hq, Hkv, hd, kind, window, plen, cap = ATTN_CASES[case]
    rng = np.random.default_rng(7)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, Sq, Hq, hd), (B, Sk, Hkv, hd), (B, Sk, Hkv, hd)))
    w = rng.standard_normal((B, Sq, Hq, hd)).astype(np.float32)
    opts = dict(kind=kind, window=window, prefix_len=plen, softcap_val=cap)

    def jax_loss(q, k, v):
        o = jax_flash(q, k, v, **opts)
        return jnp.sum(o * w), o

    (_, jo), jg = jax.jit(jax.value_and_grad(jax_loss, argnums=(0, 1, 2), has_aux=True))(
        *map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    o = flash_attention(tq, tk, tv, **opts)
    assert type(o.grad_fn).__name__ == "FlashAttentionBackward"
    (o * torch.from_numpy(w)).sum().backward()
    assert rel(o, torch.tensor(np.asarray(jo))) <= GRAD_TOL
    for name, got, want in zip("qkv", (tq.grad, tk.grad, tv.grad), jg):
        assert rel(got, torch.tensor(np.asarray(want))) <= GRAD_TOL, name


def test_flash_without_a_gradient_builds_no_graph():
    q = torch.randn(1, 8, 2, 16, requires_grad=True)
    k = torch.randn(1, 8, 2, 16, requires_grad=True)
    with torch.no_grad():
        assert flash_attention_kernel(q, k, k).grad_fn is None
    assert flash_attention_kernel(q.detach(), k.detach(), k.detach()).grad_fn is None
    assert FlashAttention.apply(q, k, k, True, 0, 0.0, 0).grad_fn is not None


def test_flash_function_checks_the_prefix_before_it_runs():
    q = torch.randn(1, 8, 2, 16, requires_grad=True)
    with pytest.raises(ValueError, match="prefix_len"):
        flash_attention_kernel(q, q, q, causal=True, window=4, prefix_len=2)
