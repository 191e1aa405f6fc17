"""The port's linear recurrence (:mod:`repro_torch.core.recurrence`) against
the JAX package's: ``scan``, ``doubling`` and the literal ``sptrsv``
pipeline, f64 and f32, along ``axis=0`` and ``axis=1``, with an initial
state, the bidiagonal matrix and its level collapse under rewriting, and
the gradient of ``doubling``.

``h0`` along ``axis=1`` with a batch of more than one is held against a
numpy loop: the JAX function raises there (ROADMAP C-ref 7)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compat import enable_x64
from repro.core.levels import build_level_sets as j_build_level_sets
from repro.core.recurrence import linear_recurrence as j_linear_recurrence
from repro.core.recurrence import recurrence_as_sptrsv as j_recurrence_as_sptrsv
from repro.core.rewrite import RewriteConfig as JaxRewriteConfig
from repro.core.rewrite import rewrite_matrix as j_rewrite_matrix

from repro_torch.core.levels import build_level_sets
from repro_torch.core.recurrence import linear_recurrence, recurrence_as_sptrsv
from repro_torch.core.rewrite import RewriteConfig, rewrite_matrix

from _hypothesis_compat import given, settings, st
from _torch_parity import assert_same, carry

METHODS = ["scan", "doubling", "sptrsv"]
# f64 to 1e-12; f32 to the JAX test's 1e-5 (tests/test_recurrence.py)
TOL = {np.float64: dict(rtol=1e-12, atol=1e-12),
       np.float32: dict(rtol=1e-5, atol=1e-5)}


def _loop(a, u, h0=None, axis=0):
    """numpy's h_t = a_t h_{t-1} + u_t along ``axis``, in f64."""
    a_m, u_m = np.moveaxis(a, axis, 0), np.moveaxis(u, axis, 0)
    acc = np.zeros(u_m.shape[1:]) if h0 is None else np.asarray(h0, np.float64)
    out = np.zeros(u_m.shape)
    for t in range(u_m.shape[0]):
        acc = a_m[t] * acc + u_m[t]
        out[t] = acc
    return np.moveaxis(out, 0, axis)


def _inputs(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.2, 0.99, shape).astype(dtype),
            rng.normal(size=shape).astype(dtype))


def _jax(a, u, h0=None, **kw):
    with enable_x64(a.dtype == np.float64):
        args = (jnp.asarray(a), jnp.asarray(u))
        if h0 is not None:
            args += (jnp.asarray(h0),)
        return np.asarray(j_linear_recurrence(*args, **kw))


def _port(a, u, h0=None, **kw):
    h0 = None if h0 is None else torch.from_numpy(h0)
    return linear_recurrence(torch.from_numpy(a), torch.from_numpy(u), h0,
                             **kw).numpy()


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("method", METHODS)
def test_methods_match_jax_and_a_loop(method, dtype):
    a, u = _inputs((33, 3), dtype)
    got = _port(a, u, method=method)
    assert got.dtype == dtype and got.shape == u.shape
    np.testing.assert_allclose(got, _jax(a, u, method=method), **TOL[dtype])
    np.testing.assert_allclose(got, _loop(a, u), **TOL[dtype])


@pytest.mark.parametrize("method", METHODS)
def test_axis1_batched(method):
    a, u = _inputs((2, 17, 3), np.float64, seed=3)
    got = _port(a, u, method=method, axis=1)
    np.testing.assert_allclose(got, _jax(a, u, method=method, axis=1),
                               **TOL[np.float64])
    np.testing.assert_allclose(got, _loop(a, u, axis=1), **TOL[np.float64])


@pytest.mark.parametrize("method", METHODS)
def test_h0_along_axis0_matches_jax(method):
    a, u = _inputs((9, 4), np.float64, seed=1)
    h0 = np.random.default_rng(2).normal(size=4)
    got = _port(a, u, h0, method=method)
    np.testing.assert_allclose(got, _jax(a, u, h0, method=method),
                               **TOL[np.float64])
    np.testing.assert_allclose(got, _loop(a, u, h0), **TOL[np.float64])


@pytest.mark.parametrize("method", METHODS)
def test_h0_along_axis1_with_a_batch(method):
    """The documented answer where the JAX function raises (C-ref 7: its
    ``h0[None]`` broadcasts against the kept axis)."""
    a, u = _inputs((2, 9, 3), np.float64, seed=4)
    h0 = np.random.default_rng(5).normal(size=(2, 3))
    np.testing.assert_allclose(_port(a, u, h0, method=method, axis=1),
                               _loop(a, u, h0, axis=1), **TOL[np.float64])
    with pytest.raises(ValueError):
        _jax(a, u, h0, method=method, axis=1)
    # a batch of one is where the reference runs: the port matches it
    np.testing.assert_allclose(_port(a[:1], u[:1], h0[:1], method=method, axis=1),
                               _jax(a[:1], u[:1], h0[:1], method=method, axis=1),
                               **TOL[np.float64])


@given(st.integers(4, 64), st.integers(0, 10_000))
@settings(max_examples=20, deadline=None)
def test_doubling_matches_scan_property(T, seed):
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.uniform(-1.0, 1.0, (T,)))
    u = torch.from_numpy(rng.normal(size=(T,)))
    s = linear_recurrence(a, u, method="scan")
    d = linear_recurrence(a, u, method="doubling")
    np.testing.assert_allclose(s.numpy(), d.numpy(), rtol=1e-4, atol=1e-5)


def test_recurrence_matrix_matches_jax():
    a = np.random.default_rng(6).uniform(0.5, 0.9, (40,))
    assert_same(recurrence_as_sptrsv(a), j_recurrence_as_sptrsv(a))


def test_chain_levels_collapse_under_rewriting():
    """64 levels before the rewrite, 2 after (row 0, then every other row
    depending on row 0 only), with the JAX package's statistics."""
    a = np.random.default_rng(2).uniform(0.5, 0.9, (64,))
    L, Lj = recurrence_as_sptrsv(a), j_recurrence_as_sptrsv(a)
    cfg = JaxRewriteConfig(thin_threshold=1, max_row_nnz=65, max_fill_ratio=64.0)
    lv = build_level_sets(L)
    assert lv.num_levels == 64
    res = rewrite_matrix(L, lv, carry(cfg, RewriteConfig))
    ref = j_rewrite_matrix(Lj, j_build_level_sets(Lj), cfg)
    assert res.levels.num_levels == 2 and res.levels.counts[1] == 63
    assert res.stats.flops_after > res.stats.flops_before
    assert_same(res.stats, ref.stats)
    assert_same(res.L, ref.L)
    assert_same(res.E, ref.E)


def test_doubling_gradient_matches_jax():
    a, u = _inputs((33, 3), np.float64, seed=7)
    w = np.random.default_rng(8).normal(size=u.shape)
    ta = torch.from_numpy(a).requires_grad_()
    tu = torch.from_numpy(u).requires_grad_()
    (linear_recurrence(ta, tu, method="doubling") * torch.from_numpy(w)).sum() \
        .backward()
    with enable_x64():
        def loss(a_, u_):
            return jnp.sum(j_linear_recurrence(a_, u_, method="doubling") * w)

        ga, gu = jax.grad(loss, argnums=(0, 1))(jnp.asarray(a), jnp.asarray(u))
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(ga), **TOL[np.float64])
    np.testing.assert_allclose(tu.grad.numpy(), np.asarray(gu), **TOL[np.float64])


def test_unknown_method_raises():
    a, u = _inputs((5, 2), np.float64)
    with pytest.raises(ValueError):
        _port(a, u, method="blelloch")
