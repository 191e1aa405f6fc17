"""Shared set-up of the training parity tests (``tests/test_torch_train_*.py``):
batches for both packages, trees carried from the JAX layout into the
port's, and leaf-by-leaf comparisons.

The models are :mod:`_torch_lm_parity`'s (the smoke configuration with one
pattern repetition and two tail layers, seeded noise in the leaves the JAX
init leaves at zero); the port runs on the CPU, every kernel's plain
version.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm_parity import pair
from repro.train.steps import loss_fn as jax_loss_fn
from repro_torch.models.convert import from_jax
from repro_torch.tree import leaves_with_path

# frames of whisper's encoder stub in the test batches
ENC_FRAMES = 12


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Each test's torch ops on one thread, the worker's count restored
    after: the smoke models' tensors are too small to split, and the test
    run shares the machine's cores among its workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def batch(cfg, B: int = 2, S: int = 16, seed: int = 0) -> dict:
    """Tokens, next-token labels (the last masked, -1) and the family's
    stub, drawn from ``seed`` with numpy."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    out = {"tokens": toks,
           "labels": np.concatenate([toks[:, 1:], np.full((B, 1), -1, np.int32)], 1)}
    if cfg.family == "audio":
        out["enc_embed"] = rng.standard_normal((B, ENC_FRAMES, cfg.d_model),
                                               dtype=np.float32)
    if cfg.family == "vlm":
        out["patches"] = rng.standard_normal((B, cfg.prefix_len, cfg.d_model),
                                             dtype=np.float32)
    return out


def to_port(tree, cfg) -> dict:
    """A JAX parameter-shaped tree (parameters, gradients, updates) in the
    port's layout, every leaf f32 on the CPU."""
    return from_jax(jax.tree.map(np.asarray, tree), cfg, device="cpu", masters=True)


def rel(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| / max |want| (0 where both are 0)."""
    got, want = got.detach().double(), want.detach().double()
    err = float((got - want).abs().max()) if got.numel() else 0.0
    scale = float(want.abs().max()) if want.numel() else 0.0
    return err / scale if scale else err


def worst(got: dict, want: dict) -> tuple[float, str]:
    """The largest :func:`rel` over the leaves of two trees of the same
    structure, and its leaf's path."""
    a, b = leaves_with_path(got), leaves_with_path(want)
    assert [k for k, _ in a] == [k for k, _ in b]
    for (k, x), (_, y) in zip(a, b):
        assert tuple(x.shape) == tuple(y.shape), (k, x.shape, y.shape)
    return max((rel(x, y), k) for (k, x), (_, y) in zip(a, b))


@functools.lru_cache(maxsize=None)
def jax_run(arch: str, grads: bool):
    """The JAX package on :func:`_torch_lm_parity.pair`'s f32 model of
    ``arch`` and :func:`batch` ``(seed=1)``, jitted once: ``(logits, aux)``
    of ``forward``, and with ``grads`` also ``(loss, gradient tree)`` of
    ``jax.value_and_grad`` of its ``loss_fn``."""
    p = pair(arch, "float32")
    b = {k: jnp.asarray(v) for k, v in batch(p.cfg, seed=1).items()}

    def run(params, bt):
        fwd = p.jm.forward(params, {k: v for k, v in bt.items() if k != "labels"})
        if not grads:
            return fwd
        (loss, _), g = jax.value_and_grad(
            lambda q: jax_loss_fn(p.jm, q, bt), has_aux=True)(params)
        return fwd + (loss, g)

    return jax.tree.map(np.asarray, jax.jit(run)(p.jp, b))


# f32 logits: the JAX blockwise online softmax against the port's, and XLA's
# products against torch's (measured <= 4e-7 of the largest logit)
LOGIT_TOL = 1e-5
# f32 gradients of every leaf, max-norm relative (measured <= 3.5e-5, the
# MoE router's; <= 5.1e-6 elsewhere)
GRAD_TOL = 1e-4


def check_forward(arch: str, grads: bool) -> None:
    """``Model.forward``'s logits and aux against the JAX ``forward``."""
    p = pair(arch, "float32")
    b = batch(p.cfg, seed=1)
    want, jaux = jax_run(arch, grads)[:2]
    with torch.no_grad():
        got, aux = p.pm.forward(p.pp, b)
    S = b["tokens"].shape[1]
    assert tuple(got.shape) == (2, S, p.cfg.vocab_pad) == want.shape
    assert rel(got, torch.tensor(want)) <= LOGIT_TOL
    assert aux.dtype == torch.float32 and aux.dim() == 0
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5, atol=1e-7)
    assert (float(aux) > 0) == bool(p.cfg.n_experts)


def check_gradients(arch: str) -> None:
    """The port's ``loss_and_grads`` against ``jax.value_and_grad`` of the
    JAX ``loss_fn``, every leaf carried across by ``convert``."""
    from repro_torch.train.steps import loss_and_grads

    p = pair(arch, "float32")
    _, _, loss, g = jax_run(arch, True)
    got, metrics = loss_and_grads(p.pm, p.pp, batch(p.cfg, seed=1))
    np.testing.assert_allclose(float(metrics["loss"]), float(loss), rtol=1e-5)
    err, leaf = worst(got, to_port(g, p.cfg))
    assert err <= GRAD_TOL, (leaf, err)
