"""The port's equation rewriting against the JAX package: ``rewrite_matrix``
(both policies, both engines, forward and upper) and
``replay_rewrite_values`` array for array, the ELL SpMV kernel's plain
version against the JAX SpMV kernel and ``ell_spmv``, the RHS transform,
and rewritten solves (``levelset``, ``pallas_level`` with and without
coarsening, ``pallas_fused``) against ``repro.core.SpTRSV`` with the same
rewrite, before and after ``refresh``."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

import repro.core.codegen as j_codegen
import repro.core.csr as j_csr
import repro.core.rewrite as j_rewrite
from repro.compat import enable_x64
from repro.core import SpTRSV as JaxSpTRSV
from repro.kernels.spmv_ell import lowering_tpu as j_spmv_tpu
from repro.sparse import refresh_values

import repro_torch.core.codegen as t_codegen
import repro_torch.core.csr as t_csr
import repro_torch.core.rewrite as t_rewrite
from repro_torch.core import SpTRSV
from repro_torch.core.packed import make_packed_rhs_transform
from repro_torch.kernels.spmv_ell import cuda as spmv_cuda
from repro_torch.kernels.spmv_ell.ops import device_cols, spmv
from repro_torch.kernels.spmv_ell.ref import spmv_ref

from _torch_parity import (MATRICES, TOL, assert_same, carry, jax_matrix,
                           systems, to_port)

NAMES = sorted(MATRICES)
ENGINES = ("vectorized", "loop")
CONFIGS = {
    "thin": dict(),
    "critical_path": dict(policy="critical_path"),
    "thin4": dict(thin_threshold=4),
    # budgets that bind: per-row width and global fill
    "tight": dict(max_fill_ratio=1.02, max_row_nnz=6),
}


def _rewrites(name, upper, **cfg):
    sj, st, lj, lt = systems(name, upper)
    jc = j_rewrite.RewriteConfig(**cfg)
    return (j_rewrite.rewrite_matrix(sj, lj, jc, upper=upper),
            t_rewrite.rewrite_matrix(st, lt, carry(jc, t_rewrite.RewriteConfig),
                                     upper=upper), sj, st)


@pytest.mark.parametrize("upper", [False, True], ids=["forward", "upper"])
@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("name", NAMES)
def test_rewrite_matrix_matches(name, config, engine, upper):
    a, b, _, _ = _rewrites(name, upper, engine=engine, **CONFIGS[config])
    assert_same(b, a)  # L', E, levels, stats arrays, plan (rows and rounds)
    assert (b.plan.rounds is None) == (engine == "loop")


@pytest.mark.parametrize("upper", [False, True], ids=["forward", "upper"])
@pytest.mark.parametrize("name", NAMES)
def test_rewrite_original_rows_matches(name, upper):
    a, b, _, _ = _rewrites(name, upper, use_original_rows=True)
    assert_same(b, a)
    with pytest.raises(ValueError, match="use_original_rows"):
        t_rewrite.rewrite_matrix(
            systems(name, upper)[1], upper=upper,
            config=t_rewrite.RewriteConfig(use_original_rows=True,
                                           engine="vectorized"))


def test_rewrite_config_checks():
    L = to_port(jax_matrix("chain"))
    with pytest.raises(ValueError, match="engine"):
        t_rewrite.rewrite_matrix(L, config=t_rewrite.RewriteConfig(engine="x"))
    with pytest.raises(ValueError, match="policy"):
        t_rewrite.rewrite_matrix(L, config=t_rewrite.RewriteConfig(policy="x"))
    with pytest.raises(TypeError, match="RewriteConfig"):
        SpTRSV.build(L, device="cpu", rewrite="thin")


def _new_data(M, upper, seed):
    """New values on ``M``'s pattern with a boosted diagonal (stored last in
    a lower row, first in an upper row)."""
    rng = np.random.default_rng(seed)
    d = M.data + 0.05 * rng.standard_normal(M.nnz)
    d[M.indptr[:-1] if upper else M.indptr[1:] - 1] += 2.0
    return d


@pytest.mark.parametrize("upper", [False, True], ids=["forward", "upper"])
@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("name", NAMES)
def test_replay_matches(name, engine, upper):
    a, b, sj, st = _rewrites(name, upper, engine=engine)
    d = _new_data(sj, upper, seed=5)
    ja = j_rewrite.replay_rewrite_values(
        j_csr.CSRMatrix(sj.indptr, sj.indices, d, sj.shape), a.plan, a.L, a.E)
    tb = t_rewrite.replay_rewrite_values(
        t_csr.CSRMatrix(st.indptr, st.indices, d, st.shape), b.plan, b.L, b.E)
    assert_same(tb, ja)


def _cancelling():
    """Row 2's elimination of row 1 cancels its entry at column 0 exactly
    (0.5 - (1/2) * 1 = 0), so L' drops it; new values where it no longer
    cancels land outside the cached pattern."""
    rows, cols = [0, 1, 1, 2, 2, 2], [0, 0, 1, 0, 1, 2]
    vals = np.array([1.0, 1.0, 2.0, 0.5, 1.0, 3.0])
    return rows, cols, vals


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("fault", ["zero_pivot", "fill_outside"])
def test_replay_refuses_where_jax_does(fault, engine):
    if fault == "zero_pivot":
        a, b, sj, st = _rewrites("lung2", False, engine=engine)
        d = _new_data(sj, False, seed=6)
        piv = int(b.plan.rows[0][1][0])
        d[sj.indptr[piv + 1] - 1] = 0.0
        match = "zero pivot"
    else:
        rows, cols, vals = _cancelling()
        cfg = dict(thin_threshold=1, engine=engine)
        sj = j_csr.from_coo(rows, cols, vals, (3, 3))
        st = t_csr.from_coo(rows, cols, vals, (3, 3))
        a = j_rewrite.rewrite_matrix(sj, config=j_rewrite.RewriteConfig(**cfg))
        b = t_rewrite.rewrite_matrix(st, config=t_rewrite.RewriteConfig(**cfg))
        assert_same(b, a)
        assert b.L.row_nnz()[2] == 1  # the cancelled entry is gone
        d = vals.copy()
        d[3] = 0.7
        match = "fill outside"
    with pytest.raises(j_rewrite.RewriteReplayError, match=match):
        j_rewrite.replay_rewrite_values(
            j_csr.CSRMatrix(sj.indptr, sj.indices, d, sj.shape), a.plan, a.L, a.E)
    with pytest.raises(t_rewrite.RewriteReplayError, match=match):
        t_rewrite.replay_rewrite_values(
            t_csr.CSRMatrix(st.indptr, st.indices, d, st.shape), b.plan, b.L, b.E)


# --------------------------------------------------------------------------
# the SpMV kernel's plain version
# --------------------------------------------------------------------------
def _ell(name, dtype):
    L = jax_matrix(name, dtype)
    return L, j_codegen.build_ell(L)


@pytest.mark.parametrize("name", NAMES)
def test_spmv_plain_matches_tpu_kernel_f32(name):
    L, ell = _ell(name, np.float32)
    block = 128
    n_pad = -(-L.n // block) * block
    cols = np.zeros((ell.K, n_pad), np.int32)
    vals = np.zeros((ell.K, n_pad), np.float32)
    cols[:, :L.n], vals[:, :L.n] = ell.cols, ell.vals
    v = np.random.default_rng(1).standard_normal(n_pad).astype(np.float32)
    want = np.asarray(j_spmv_tpu.spmv(jnp.asarray(v), jnp.asarray(cols),
                                      jnp.asarray(vals), block=block,
                                      interpret=True))
    got = spmv_ref(torch.from_numpy(v), torch.from_numpy(cols.astype(np.int64)),
                   torch.from_numpy(vals))
    np.testing.assert_allclose(got.numpy(), want, **TOL[np.float32])


@pytest.mark.parametrize("m", [0, 3])
@pytest.mark.parametrize("name", NAMES)
def test_spmv_plain_matches_ell_spmv_f64(name, m):
    L, ell = _ell(name, np.float64)
    rng = np.random.default_rng(2)
    v = rng.standard_normal((L.n, m) if m else L.n)
    with enable_x64():
        want = np.asarray(j_codegen.ell_spmv(ell, jnp.asarray(v)))
    tell = t_codegen.build_ell(to_port(L))
    cols = device_cols(tell.cols, L.n, torch.device("cpu"))
    got = spmv(torch.from_numpy(v), cols, torch.from_numpy(tell.vals))
    np.testing.assert_allclose(got.numpy(), want, **TOL[np.float64])
    np.testing.assert_allclose(got.numpy(), L.to_dense() @ v, **TOL[np.float64])


def test_spmv_checks():
    cols = np.array([[0, 3], [1, 2]], np.int32)
    with pytest.raises(ValueError, match="outside"):
        device_cols(cols, 3, torch.device("cpu"))
    with pytest.raises(ValueError, match="outside"):
        device_cols(-cols, 4, torch.device("cpu"))
    assert device_cols(cols, 4, torch.device("cpu")).dtype == torch.int64
    v = torch.ones(4, dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA"):
        spmv_cuda.spmv(v, torch.from_numpy(cols), torch.ones(2, 2, dtype=torch.float64))
    with pytest.raises(ValueError, match="device"):
        spmv(v.to("meta"), torch.from_numpy(cols), torch.ones(2, 2))


def test_rhs_transform_is_none_for_identity_e():
    L = to_port(jax_matrix("lung2"))
    res = t_rewrite.rewrite_matrix(L, config=t_rewrite.RewriteConfig(thin_threshold=0))
    assert res.stats.e_nnz_offdiag == 0
    assert make_packed_rhs_transform(res, device="cpu") == (None, None, None)
    s = SpTRSV.build(L, device="cpu", rewrite=t_rewrite.RewriteConfig(thin_threshold=0))
    assert s._rhs_fn is None and s._e_values is None


# --------------------------------------------------------------------------
# rewritten solves against repro.core.SpTRSV
# --------------------------------------------------------------------------
VARIANTS = {
    "levelset": dict(strategy="levelset"),
    "pallas_level": dict(strategy="pallas_level"),
    "pallas_level+coarsen": dict(strategy="pallas_level", coarsen=True),
    # JAX pallas_fused does not run on the installed JAX (ROADMAP C-ref 1):
    # held against JAX levelset with the same rewrite
    "pallas_fused": dict(strategy="pallas_fused"),
}
_JAX = {}


def _jax_pair(variant, dtype, policy="thin"):
    """JAX solvers with the same options and rewrite (cached per variant)."""
    ref = "levelset" if variant == "pallas_fused" else variant
    key = (ref, np.dtype(dtype).name, policy)
    if key not in _JAX:
        with enable_x64(dtype == np.float64):
            _JAX[key] = JaxSpTRSV.build_pair(
                jax_matrix("lung2", dtype), backend="interpret",
                rewrite=j_rewrite.RewriteConfig(policy=policy), **VARIANTS[ref])
    return _JAX[key]


def _jax_solve(s, rhs, dtype):
    with enable_x64(dtype == np.float64):
        return np.asarray(s.solve(jnp.asarray(rhs)))


def _rhs(n, dtype, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n).astype(dtype),
            rng.standard_normal((n, 3)).astype(dtype))


@pytest.mark.parametrize("build", ["pair", "single"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_rewritten_solves_match_jax(dtype, variant, build):
    L = jax_matrix("lung2", dtype)
    Lt = to_port(L)
    cfg = t_rewrite.RewriteConfig()
    if build == "pair":
        ours = SpTRSV.build_pair(Lt, device="cpu", rewrite=cfg, **VARIANTS[variant])
    else:
        ours = tuple(SpTRSV.build(Lt, transpose=tr, device="cpu", rewrite=cfg,
                                  **VARIANTS[variant]) for tr in (False, True))
    refs = _jax_pair(variant, dtype)
    new = refresh_values(L, seed=4)
    for s, ref in zip(ours, refs):
        assert s.rewrite_result.stats.rows_rewritten > 0
        for rhs in _rhs(L.n, dtype, seed=1):
            got = s.solve(torch.from_numpy(rhs))
            assert got.dtype == torch.from_numpy(rhs).dtype
            np.testing.assert_allclose(got.numpy(), _jax_solve(ref, rhs, dtype),
                                       **TOL[dtype])
        ptrs = [v.data_ptr() for v in (*s._values, s._e_values)]
        assert s.refresh(new) is s
        assert [v.data_ptr() for v in (*s._values, s._e_values)] == ptrs
        dense = to_port(L).to_dense().astype(np.float64) * 0
        dense[np.repeat(np.arange(L.n), np.diff(L.indptr)), L.indices] = new
        A = dense.T if s.transpose else dense
        for rhs in _rhs(L.n, dtype, seed=2):
            tol = TOL[dtype] if dtype == np.float64 else dict(rtol=1e-4, atol=1e-5)
            np.testing.assert_allclose(s.solve(torch.from_numpy(rhs)).numpy(),
                                       np.linalg.solve(A, rhs), **tol)
        s.refresh(L.data)  # back to the original values: JAX agrees again
        rhs = _rhs(L.n, dtype, seed=3)[1]
        np.testing.assert_allclose(s.solve(torch.from_numpy(rhs)).numpy(),
                                   _jax_solve(ref, rhs, dtype), **TOL[dtype])


@pytest.mark.parametrize("transpose", [False, True])
def test_critical_path_policy_solve_matches_jax(transpose):
    L = jax_matrix("lung2")
    s = SpTRSV.build(to_port(L), transpose=transpose, device="cpu",
                     strategy="pallas_level",
                     rewrite=t_rewrite.RewriteConfig(policy="critical_path"))
    ref = _jax_pair("pallas_level", np.float64, "critical_path")[int(transpose)]
    assert s.stats()["rewrite_policy"] == "critical_path"
    for rhs in _rhs(L.n, np.float64, seed=7):
        np.testing.assert_allclose(s.solve(torch.from_numpy(rhs)).numpy(),
                                   _jax_solve(ref, rhs, np.float64),
                                   **TOL[np.float64])


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_rewritten_stats_match_jax(variant, transpose):
    ours = SpTRSV.build(to_port(jax_matrix("lung2")), transpose=transpose,
                        device="cpu", rewrite=t_rewrite.RewriteConfig(),
                        **VARIANTS[variant])
    a = ours.stats()
    if variant == "pallas_fused":  # JAX pallas_fused cannot be built here
        assert a["strategy"] == "pallas_fused" and a["segments"] > 0
        b = _jax_pair("levelset", np.float64)[int(transpose)].stats()
        keys = ("rewrite", "rewrite_policy", "nnz", "critical_path_flops",
                "supernode_count", "mean_block_size", "dense_block_fraction")
    else:
        b = _jax_pair(variant, np.float64)[int(transpose)].stats()
        assert set(a) == set(b)
        keys = tuple(k for k in b if k != "backend")
    for key in keys:
        assert a[key] == b[key], key
    assert a["rewrite"].startswith("levels ")
    assert a["backend"] == "cpu"


def test_refresh_falls_back_to_cold_rebuild_when_plan_does_not_transfer():
    rows, cols, vals = _cancelling()
    L = t_csr.from_coo(rows, cols, vals, (3, 3))
    cfg = t_rewrite.RewriteConfig(thin_threshold=1)
    s = SpTRSV.build(L, strategy="pallas_level", device="cpu", rewrite=cfg)
    ptrs = [v.data_ptr() for v in s._values]
    new = vals.copy()
    new[3] = 0.7
    s.refresh(new)  # the plan does not transfer: a cold rebuild
    assert [v.data_ptr() for v in s._values] != ptrs
    b = np.array([1.0, -2.0, 0.5])
    dense = np.zeros((3, 3))
    dense[rows, cols] = new
    np.testing.assert_allclose(s.solve(torch.from_numpy(b)).numpy(),
                               np.linalg.solve(dense, b), **TOL[np.float64])
    with enable_x64():
        ref = JaxSpTRSV.build(j_csr.from_coo(rows, cols, vals, (3, 3)),
                              strategy="pallas_level", backend="interpret",
                              rewrite=j_rewrite.RewriteConfig(thin_threshold=1))
        ref.refresh(new)
    assert_same(s.rewrite_result, ref.rewrite_result)
    np.testing.assert_allclose(s.solve(torch.from_numpy(b)).numpy(),
                               _jax_solve(ref, b, np.float64), **TOL[np.float64])
