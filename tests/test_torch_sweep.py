"""The port's sweep executor (``strategy="sweep"``, on ``device="cpu"``)
against the JAX package's: the ``D + N`` layout array for array, the
contraction factor and planned sweep count, the residual terms (``inf``
for a column holding NaN), speculative solves, the per-column fallback
splice, refresh (the lazily built fallback included) and the stats."""
import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import repro.core.sweep as j_sweep
from repro.compat import enable_x64
from repro.core import SpTRSV as JaxSpTRSV
from repro.core import SweepConfig as JaxSweepConfig
from repro.sparse import chain_matrix, lung2_like, refresh_values

import repro_torch.core.sweep as t_sweep
from repro_torch.core import SpTRSV, SweepConfig
from repro_torch.core.codegen import device_ell

from _torch_parity import TOL, carry, jax_matrix, systems, to_port


def _lung2(dtype=np.float64):
    # the JAX sweep tests' dominant lung2 class
    return lung2_like(scale=0.02, fat_levels=6, thin_run=10, dtype=dtype)


def _pair(L, cfg, dtype=np.float64):
    ours = SpTRSV.build_pair(to_port(L), strategy="sweep", sweep=cfg,
                             device="cpu")
    jcfg = carry(cfg, JaxSweepConfig)
    if cfg.fallback in ("pallas_level", "pallas_fused"):
        # the JAX package's kernel fallbacks run its Pallas kernels under
        # the interpreter (and its fused one fails under JAX 0.9, ROADMAP
        # C-ref 1): the reference falls back to levelset, the same answer
        jcfg = dataclasses.replace(jcfg, fallback="levelset")
    with enable_x64(dtype == np.float64):
        ref = JaxSpTRSV.build_pair(L, strategy="sweep", backend="interpret",
                                   sweep=jcfg)
    return ours, ref


def _same_stats(ours, ref, dtype=np.float64):
    """Equal counts; the worst residual ratio, a rounding-level number
    when a solve verifies, on the same side of the tolerance and, above
    it, equal to 1e-6."""
    a, b = ours.report(), ref.report()
    ra, rb = a.pop("last_residual_ratio"), b.pop("last_residual_ratio")
    assert a == b
    tol = t_sweep.default_residual_tol(dtype)
    assert (ra <= tol) == (rb <= tol), (ra, rb)
    if rb > tol:
        assert ra == pytest.approx(rb, rel=1e-6)


def _rhs(n, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n).astype(dtype),
            rng.standard_normal((n, 3)).astype(dtype))


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("name", ["lung2", "chain", "random", "dense_band"])
def test_layout_contraction_and_planned_sweeps_match(name, transpose):
    sj, st, lj, lt = systems(name, transpose)
    a = t_sweep.build_sweep_layout(st, upper=transpose)
    b = j_sweep.build_sweep_layout(sj, upper=transpose)
    for x, y in ((a.ell.cols, b.ell.cols), (a.ell.vals, b.ell.vals),
                 (a.ell.val_src, b.ell.val_src), (a.diag, b.diag),
                 (a.diag_src, b.diag_src)):
        np.testing.assert_array_equal(x, y)
        assert x.dtype == y.dtype
    assert (a.n, a.nnz, a.K) == (b.n, b.nnz, b.K)
    new = refresh_values(jax_matrix(name), seed=3)
    data = new[np.argsort(jax_matrix(name).indices, kind="stable")] \
        if transpose else new
    with enable_x64():
        for x, y in zip(t_sweep.pack_sweep_values(a, data),
                        j_sweep.pack_sweep_values(b, data)):
            np.testing.assert_array_equal(x, np.asarray(y))
    q = t_sweep.contraction_factor(st, upper=transpose)
    assert q == j_sweep.contraction_factor(sj, upper=transpose)
    for dt in (np.float32, np.float64):
        tol = t_sweep.default_residual_tol(dt)
        assert tol == j_sweep.default_residual_tol(dt)
        assert tol == t_sweep.default_residual_tol(
            torch.float32 if dt == np.float32 else torch.float64)
        for cap in (1, 8, 32, 10_000):
            assert t_sweep.planned_sweeps(q, lt.num_levels, tol, cap) == \
                j_sweep.planned_sweeps(q, lj.num_levels, tol, cap)


def test_planned_sweeps_bounds():
    for q, depth, tol, cap in ((0.0, 5, 1e-12, 32), (0.5, 100, 1e-14, 64),
                               (0.9, 10, 1e-14, 32), (1.5, 40, 1e-14, 32),
                               (0.125, 4000, 2.8e-14, 32)):
        assert t_sweep.planned_sweeps(q, depth, tol, cap) == \
            j_sweep.planned_sweeps(q, depth, tol, cap)


@pytest.mark.parametrize("batch", [0, 3])
@pytest.mark.parametrize("poison", [False, True])
def test_residual_terms_match(poison, batch):
    L = _lung2()
    lay_t = t_sweep.build_sweep_layout(to_port(L))
    lay_j = j_sweep.build_sweep_layout(L)
    rng = np.random.default_rng(1)
    shape = (L.n, batch) if batch else (L.n,)
    b = rng.standard_normal(shape)
    x = rng.standard_normal(shape)
    if poison:
        x[L.n // 2] = np.nan  # every column, or the one RHS
        if batch:
            x[3, 1] = np.inf
    ell = device_ell(lay_t.ell, L.n, "cpu")
    r_t, ratio_t = t_sweep.residual_terms(
        torch.from_numpy(b), torch.from_numpy(x),
        torch.from_numpy(lay_t.ell.vals), torch.from_numpy(lay_t.diag), ell)
    with enable_x64():
        r_j, ratio_j = j_sweep.residual_terms(
            jnp.asarray(b), jnp.asarray(x), jnp.asarray(lay_j.ell.vals),
            jnp.asarray(lay_j.diag), jnp.asarray(lay_j.ell.cols))
        np.testing.assert_allclose(r_t.numpy(), np.asarray(r_j),
                                   **TOL[np.float64])
        np.testing.assert_allclose(ratio_t.numpy(), np.asarray(ratio_j),
                                   **TOL[np.float64])
    if poison:
        assert np.isinf(ratio_t.numpy()).all()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_sweep_solves_match_jax(dtype):
    L = _lung2(dtype)
    (fwd, bwd), (jf, jb) = _pair(L, SweepConfig(), dtype)
    for ours, ref in ((fwd, jf), (bwd, jb)):
        for rhs in _rhs(L.n, dtype):
            got = ours.solve(torch.from_numpy(rhs)).numpy()
            with enable_x64(dtype == np.float64):
                want = np.asarray(ref.solve(jnp.asarray(rhs)))
            np.testing.assert_allclose(got, want, **TOL[dtype])
        _same_stats(ours.sweep_stats, ref.sweep_stats, dtype)
        assert ours.sweep_stats.fallback_solves == 0
        a, b = ours.stats(), ref.stats()
        for key in ("strategy", "segments", "packed_value_bytes",
                    "packed_index_bytes", "padded_value_bytes", "n_pad",
                    "permutation_applied", "planned_sweeps"):
            assert a[key] == b[key], key


@pytest.mark.parametrize("fallback", ["levelset", "serial", "pallas_level",
                                      "pallas_fused", "levelset_unroll"])
def test_fallback_fires_and_splices_like_jax(fallback):
    """k=1 cannot converge on a deep system: every column falls back; a
    batch with one trivially converged column keeps it and splices the
    rest."""
    L = _lung2()
    cfg = SweepConfig(k=1, fallback=fallback)
    (fwd, bwd), (jf, jb) = _pair(L, cfg)
    B = np.random.default_rng(2).standard_normal((L.n, 3))
    B[:, 1] = 0.0  # x = 0 verifies after any number of sweeps
    dense = L.to_dense()
    with enable_x64():
        for ours, ref, A in ((fwd, jf, dense), (bwd, jb, dense.T)):
            got = ours.solve(torch.from_numpy(B)).numpy()
            np.testing.assert_allclose(got, np.asarray(ref.solve(jnp.asarray(B))),
                                       **TOL[np.float64])
            np.testing.assert_allclose(got, np.linalg.solve(A, B),
                                       **TOL[np.float64])
            got1 = ours.solve(torch.from_numpy(B[:, 0])).numpy()
            np.testing.assert_allclose(
                got1, np.asarray(ref.solve(jnp.asarray(B[:, 0]))),
                **TOL[np.float64])
            _same_stats(ours.sweep_stats, ref.sweep_stats)
            assert ours.sweep_stats.fallback_columns == 3


def test_refresh_matches_jax_and_updates_the_fallback():
    L = _lung2()
    (fwd, bwd), (jf, jb) = _pair(L, SweepConfig(k=2))
    B = np.random.default_rng(3).standard_normal((L.n, 2))
    new = refresh_values(L, seed=4)
    with enable_x64():
        for ours, ref in ((fwd, jf), (bwd, jb)):
            ours.solve(torch.from_numpy(B))  # builds the lazy fallback
            ref.solve(jnp.asarray(B))
            ptrs = [v.data_ptr() for v in ours._values]
            ours.refresh(new)
            ref.refresh(new)
            assert ptrs == [v.data_ptr() for v in ours._values]
            got = ours.solve(torch.from_numpy(B)).numpy()
            np.testing.assert_allclose(got, np.asarray(ref.solve(jnp.asarray(B))),
                                       **TOL[np.float64])
            _same_stats(ours.sweep_stats, ref.sweep_stats)
        # against a fresh build on the new values
        Lnew = dataclasses.replace(L, data=new)
        dense = Lnew.to_dense()
        np.testing.assert_allclose(bwd.solve(torch.from_numpy(B)).numpy(),
                                   np.linalg.solve(dense.T, B), **TOL[np.float64])


def test_inexact_mode_skips_verification():
    L = _lung2()
    (fwd, _), (jf, _) = _pair(L, SweepConfig(k=3, fallback=None))
    b = _rhs(L.n, np.float64)[1]
    with enable_x64():
        np.testing.assert_allclose(fwd.solve(torch.from_numpy(b)).numpy(),
                                   np.asarray(jf.solve(jnp.asarray(b))),
                                   **TOL[np.float64])
    assert fwd.sweep_stats.last_residual_ratio == 0.0
    assert fwd.sweep_stats.solves == 1


def test_planner_picks_sweep_on_a_long_dominant_chain():
    C = chain_matrix(4000)
    s = SpTRSV.build(to_port(C), strategy="auto", device="cpu")
    with enable_x64():
        ref = JaxSpTRSV.build(C, strategy="auto", backend="interpret")
    assert s.strategy == ref.strategy == "sweep"
    assert s.plan.sweep_k == ref.plan.sweep_k
    assert s.stats()["planned_sweeps"] == s.plan.sweep_k
    b = np.random.default_rng(10).standard_normal(C.n)
    np.testing.assert_allclose(s.solve(torch.from_numpy(b)).numpy(),
                               np.linalg.solve(C.to_dense(), b),
                               rtol=1e-12, atol=1e-12)
    assert s.sweep_stats.fallback_solves == 0
    s2 = SpTRSV.build(to_port(C), strategy="auto", sweep=False, device="cpu")
    assert "sweep" not in s2.plan.costs


def test_sweep_config_validation():
    with pytest.raises(ValueError):
        SweepConfig(k=0)
    with pytest.raises(ValueError):
        SweepConfig(fallback="blocked")
    with pytest.raises(TypeError):
        SpTRSV.build(to_port(jax_matrix("chain")), strategy="sweep",
                     sweep=3, device="cpu")
