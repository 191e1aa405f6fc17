"""The port's flash attention against the JAX package's: the plain torch
version (what the CPU runs, and what the CUDA kernel is held against on the
card) against the Pallas ``flash_fwd`` under ``interpret=True`` and the
jnp ``attention_ref`` on ``(BH, S, hd)``, and the GQA wrapper against the
JAX ``flash_attention_kernel``.  Inputs are made with numpy from a seed.

Tolerances: f32 1e-5 (both sum in f32, in another order; measured ≤ 6e-7);
bf16 2e-2, as the JAX package's tests/test_flash_kernel.py (outputs round
to bf16, and the Pallas kernel also rounds p to bf16 before P V)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attn import attention_ref as jax_attention_ref
from repro.kernels.flash_attn import flash_attention_kernel as jax_flash_attention_kernel
from repro.kernels.flash_attn.kernel import flash_fwd
from repro_torch.kernels.flash_attn import cuda as flash_cuda
from repro_torch.kernels.flash_attn.ops import flash_attention_kernel
from repro_torch.kernels.flash_attn.ref import attention_ref, gqa_attention_ref

TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _inputs(seed, shapes, dtype):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    return ([jnp.asarray(a, dtype) for a in arrs],
            [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs])


def _close(got: torch.Tensor, want, dtype):
    want = (want.float().numpy() if torch.is_tensor(want)
            else np.asarray(jnp.asarray(want, jnp.float32)))
    np.testing.assert_allclose(got.float().numpy(), want,
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 64])
@pytest.mark.parametrize("short", [False, True], ids=["full-len", "valid_len<S"])
@pytest.mark.parametrize("S,hd", [(128, 64), (128, 128), (256, 64), (256, 128)])
def test_plain_matches_pallas_kernel_and_ref(S, hd, short, window, dtype):
    (jq, jk, jv), (q, k, v) = _inputs(S + hd, [(3, S, hd)] * 3, dtype)
    vl = S - 37 if short else S
    got = attention_ref(q, k, v, vl if short else None, causal=True, window=window)
    assert got.dtype == q.dtype and got.shape == q.shape
    want_kernel = flash_fwd(jq, jk, jv, jnp.asarray([vl], jnp.int32),
                            causal=True, window=window, interpret=True)
    want_ref = jax_attention_ref(jq, jk, jv, vl if short else None,
                                 causal=True, window=window)
    _close(got, want_kernel, dtype)
    _close(got, want_ref, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_ref_without_causal_mask(dtype):
    (jq, jk, jv), (q, k, v) = _inputs(5, [(2, 128, 32)] * 3, dtype)
    _close(attention_ref(q, k, v, 100, causal=False),
           jax_attention_ref(jq, jk, jv, 100, causal=False), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,Hq,Hkv,hd,window", [
    (2, 128, 2, 2, 64, 0),
    (1, 256, 4, 1, 128, 0),
    (2, 200, 4, 2, 64, 0),       # S not a multiple of the 128-row block
    (1, 200, 2, 2, 64, 128),     # ragged and sliding window
], ids=["mha", "gqa4", "ragged", "ragged-window"])
def test_gqa_wrapper_matches_jax_wrapper(B, S, Hq, Hkv, hd, window, dtype):
    (jq, jk, jv), (q, k, v) = _inputs(
        S + Hq, [(B, S, Hq, hd), (B, S, Hkv, hd), (B, S, Hkv, hd)], dtype)
    got = flash_attention_kernel(q, k, v, causal=True, window=window)
    assert got.dtype == q.dtype and got.shape == q.shape
    _close(got, jax_flash_attention_kernel(jq, jk, jv, causal=True,
                                           window=window, interpret=True), dtype)
    _close(gqa_attention_ref(q, k, v, causal=True, window=window), got, dtype)


def test_wrappers_refuse_other_devices():
    q = torch.zeros((1, 8, 2, 16))
    with pytest.raises(ValueError, match="CUDA kernel"):
        flash_cuda.flash_attn(q, q, q)
    meta = q.to("meta")
    with pytest.raises(ValueError, match="no flash-attention kernel"):
        flash_attention_kernel(meta, meta, meta)
