"""The port's ``SpTRSV`` (on ``device="cpu"``, where the kernels run their
plain torch versions) against the JAX package's ``SpTRSV`` and a dense
solve: strategies x directions x single/batched RHS x f32/f64, value-only
refresh, option checks and ``stats()``."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.compat import enable_x64
from repro.core import SpTRSV as JaxSpTRSV
from repro.sparse import refresh_values

from repro_torch.core import CoarsenConfig, SpTRSV
from repro_torch.core.csr import CSRMatrix
from repro_torch.kernels.backend import resolve_device
from repro_torch.kernels.sptrsv_fused import cuda as fused_cuda
from repro_torch.kernels.sptrsv_level import cuda as level_cuda

from _torch_parity import TOL, jax_matrix, to_port

VARIANTS = {
    "levelset": dict(strategy="levelset"),
    "pallas_level": dict(strategy="pallas_level"),
    "pallas_level+coarsen": dict(strategy="pallas_level", coarsen=True),
    "pallas_fused": dict(strategy="pallas_fused"),
}

_JAX_CACHE = {}


def _jax_levelset(dtype, transpose, rhs):
    """The JAX package's default strategy on the same factor (cached)."""
    key = (np.dtype(dtype).name, transpose)
    with enable_x64(dtype == np.float64):
        if key not in _JAX_CACHE:
            L = jax_matrix("lung2", dtype)
            _JAX_CACHE[key] = JaxSpTRSV.build(L, strategy="levelset",
                                              transpose=transpose)
        return np.asarray(_JAX_CACHE[key].solve(jnp.asarray(rhs)))


def _rhs(n, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n).astype(dtype),
            rng.standard_normal((n, 3)).astype(dtype))


def _check(solver, L, transpose, dtype):
    dense = L.to_dense().astype(np.float64)
    A = dense.T if transpose else dense
    for rhs in _rhs(L.n, dtype):
        got = solver.solve(torch.from_numpy(rhs))
        assert got.dtype == torch.from_numpy(rhs).dtype
        assert tuple(got.shape) == rhs.shape
        got = got.numpy()
        np.testing.assert_allclose(got, _jax_levelset(dtype, transpose, rhs),
                                   **TOL[dtype])
        tol = TOL[dtype] if dtype == np.float64 else dict(rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(got, np.linalg.solve(A, rhs), **tol)


@pytest.mark.parametrize("direction", ["forward", "transpose", "pair"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_solver_matches_jax_and_dense(dtype, variant, direction):
    L = jax_matrix("lung2", dtype)
    Lt = to_port(L)
    kw = VARIANTS[variant]
    if direction == "pair":
        fwd, bwd = SpTRSV.build_pair(Lt, device="cpu", **kw)
        assert (fwd.transpose, bwd.transpose) == (False, True)
        _check(fwd, L, False, dtype)
        _check(bwd, L, True, dtype)
        r = _rhs(L.n, dtype, seed=9)[1]
        z = bwd.solve(fwd.solve(torch.from_numpy(r))).numpy()
        dense = L.to_dense().astype(np.float64)
        tol = TOL[dtype] if dtype == np.float64 else dict(rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(z, np.linalg.solve(dense @ dense.T, r), **tol)
    else:
        tr = direction == "transpose"
        s = SpTRSV.build(Lt, transpose=tr, device="cpu", **kw)
        assert s.transpose is tr and s.device.type == "cpu"
        _check(s, L, tr, dtype)


@pytest.mark.parametrize("variant", ["pallas_level+coarsen", "pallas_fused"])
@pytest.mark.parametrize("name", ["chain", "banded", "random"])
def test_kernel_strategies_on_other_structures(name, variant):
    L = jax_matrix(name)
    fwd, bwd = SpTRSV.build_pair(to_port(L), device="cpu", **VARIANTS[variant])
    b, B = _rhs(L.n, np.float64, seed=2)
    dense = L.to_dense()
    for s, A in ((fwd, dense), (bwd, dense.T)):
        for rhs in (b, B):
            np.testing.assert_allclose(s.solve(torch.from_numpy(rhs)).numpy(),
                                       np.linalg.solve(A, rhs), **TOL[np.float64])


def test_coarsen_config_and_bucket_pad_ratio():
    L = jax_matrix("lung2")
    s = SpTRSV.build(to_port(L), strategy="pallas_level", device="cpu",
                     coarsen=CoarsenConfig(max_depth=4), bucket_pad_ratio=2.0)
    assert max(sl.depth for sl in s.schedule.slabs) <= 4
    b = _rhs(L.n, np.float64)[0]
    np.testing.assert_allclose(s.solve(torch.from_numpy(b)).numpy(),
                               np.linalg.solve(L.to_dense(), b), **TOL[np.float64])


def test_f32_rhs_on_f64_factor_solves_in_f32():
    L = jax_matrix("lung2")
    s64 = SpTRSV.build(to_port(L), strategy="pallas_level", device="cpu")
    s32 = SpTRSV.build(to_port(L.astype(np.float32)), strategy="pallas_level",
                       device="cpu")
    b = _rhs(L.n, np.float32)[0]
    got = s64.solve(torch.from_numpy(b))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), s32.solve(torch.from_numpy(b)).numpy())


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_refresh_matches_fresh_build(variant, transpose):
    L = jax_matrix("lung2")
    Lt = to_port(L)
    kw = VARIANTS[variant]
    s = SpTRSV.build(Lt, transpose=transpose, device="cpu", **kw)
    ptrs = [v.data_ptr() for v in s._values]
    new = refresh_values(L, seed=4)
    assert s.refresh(new) is s
    assert [v.data_ptr() for v in s._values] == ptrs  # buffers updated in place
    fresh = SpTRSV.build(CSRMatrix(Lt.indptr, Lt.indices, new, Lt.shape),
                         transpose=transpose, device="cpu", **kw)
    for a, b in zip(s._values, fresh._values):
        assert torch.equal(a, b)
    for rhs in _rhs(L.n, np.float64, seed=6):
        np.testing.assert_array_equal(s.solve(torch.from_numpy(rhs)).numpy(),
                                      fresh.solve(torch.from_numpy(rhs)).numpy())
    # a CSRMatrix of the same pattern refreshes too; chained refreshes work
    s.refresh(Lt)
    np.testing.assert_allclose(
        s.solve(torch.from_numpy(_rhs(L.n, np.float64)[0])).numpy(),
        _jax_levelset(np.float64, transpose, _rhs(L.n, np.float64)[0]),
        **TOL[np.float64])


@pytest.mark.parametrize("variant", ["pallas_level+coarsen", "pallas_fused"])
def test_refresh_pair_reorders_transpose_values(variant):
    L = jax_matrix("lung2")
    fwd, bwd = SpTRSV.build_pair(to_port(L), device="cpu", **VARIANTS[variant])
    new = refresh_values(L, seed=8)
    fwd.refresh(new)
    bwd.refresh(new)
    dense = to_port(L).to_dense() * 0
    rows = np.repeat(np.arange(L.n), np.diff(L.indptr))
    dense[rows, L.indices] = new
    b = _rhs(L.n, np.float64)[1]
    np.testing.assert_allclose(fwd.solve(torch.from_numpy(b)).numpy(),
                               np.linalg.solve(dense, b), **TOL[np.float64])
    np.testing.assert_allclose(bwd.solve(torch.from_numpy(b)).numpy(),
                               np.linalg.solve(dense.T, b), **TOL[np.float64])


@pytest.mark.parametrize("fault", ["nan", "inf", "zero_pivot"])
def test_refresh_validate_rejects_bad_values(fault):
    L = jax_matrix("lung2")
    s = SpTRSV.build(to_port(L), strategy="pallas_fused", device="cpu")
    before = [v.clone() for v in s._values]
    bad = L.data.copy()
    if fault == "nan":
        bad[3] = np.nan
    elif fault == "inf":
        bad[-2] = np.inf
    else:
        bad[L.indptr[5] - 1] = 0.0  # diagonal of row 4
    with pytest.raises(ValueError, match="refresh"):
        s.refresh(bad)
    for a, b in zip(s._values, before):  # nothing was swapped in
        assert torch.equal(a, b)
    s.refresh(bad, validate=False)  # accepted on request


def test_refresh_rejects_other_patterns():
    L = jax_matrix("lung2")
    s = SpTRSV.build(to_port(L), strategy="pallas_level", device="cpu")
    with pytest.raises(ValueError, match="shape"):
        s.refresh(L.data[:-1])
    other = to_port(jax_matrix("chain"))
    with pytest.raises(ValueError, match="pattern"):
        s.refresh(other)


# options that raised until the port had them: they build and solve now
# (``strategy="distributed"`` and ``mesh=`` need a process group:
# tests/test_torch_dist.py builds and solves them)
PORTED = {
    "serial": dict(strategy="serial"),
    "levelset_unroll": dict(strategy="levelset_unroll"),
    "auto": dict(strategy="auto"), "sweep": dict(strategy="sweep"),
    "guard=": dict(guard=True), "sweep=": dict(strategy="sweep", sweep=True),
    "scatter": dict(layout="scatter"),
}


@pytest.mark.parametrize("name", sorted(PORTED))
def test_ported_options_build_and_solve(name):
    L = to_port(jax_matrix("chain"))
    b = torch.ones(L.n, dtype=torch.float64)
    want = np.linalg.solve(L.to_dense(), b.numpy())
    s = SpTRSV.build(L, device="cpu", **PORTED[name])
    np.testing.assert_allclose(s.solve(b).numpy(), want, **TOL[np.float64])
    fwd, bwd = SpTRSV.build_pair(L, device="cpu", **PORTED[name])
    np.testing.assert_allclose(fwd.solve(b).numpy(), want, **TOL[np.float64])
    np.testing.assert_allclose(bwd.solve(b).numpy(),
                               np.linalg.solve(L.to_dense().T, b.numpy()),
                               **TOL[np.float64])


def test_unknown_options_raise():
    L = to_port(jax_matrix("chain"))
    with pytest.raises(ValueError, match="strategy"):
        SpTRSV.build(L, strategy="nope", device="cpu")
    with pytest.raises(ValueError, match="layout"):
        SpTRSV.build(L, layout="nope", device="cpu")
    with pytest.raises(ValueError, match="device"):
        SpTRSV.build(L, device="tpu")
    with pytest.raises(TypeError):
        SpTRSV.build_pair(L, transpose=True, device="cpu")


def test_cuda_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    L = to_port(jax_matrix("chain"))
    with pytest.raises(RuntimeError, match="cuda"):
        SpTRSV.build(L)  # the default device is the card
    with pytest.raises(RuntimeError, match="cuda"):
        SpTRSV.build_pair(L, strategy="pallas_fused")
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_cpu_solves_launch_no_kernel():
    before = {**level_cuda.launches, **fused_cuda.launches}
    L = to_port(jax_matrix("chain"))
    for kw in VARIANTS.values():
        SpTRSV.build(L, device="cpu", **kw).solve(torch.ones(L.n, dtype=torch.float64))
    assert {**level_cuda.launches, **fused_cuda.launches} == before


def test_solve_input_checks():
    L = to_port(jax_matrix("chain"))
    s = SpTRSV.build(L, strategy="pallas_level", device="cpu")
    with pytest.raises(TypeError):
        s.solve(np.ones(L.n))
    with pytest.raises(ValueError):
        s.solve(torch.ones(L.n + 1, dtype=torch.float64))
    with pytest.raises(ValueError):
        s.solve(torch.ones(L.n, dtype=torch.int64))
    with pytest.raises(ValueError):
        s.solve_batched(torch.ones(L.n, dtype=torch.float64))
    X = s.solve_batched(torch.ones((L.n, 2), dtype=torch.float64))
    assert tuple(X.shape) == (L.n, 2)


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("variant", ["pallas_level", "pallas_level+coarsen",
                                     "pallas_fused", "levelset"])
def test_stats_match_jax(variant, transpose):
    L = jax_matrix("lung2")
    kw = VARIANTS[variant]
    ours = SpTRSV.build(to_port(L), transpose=transpose, device="cpu", **kw)
    with enable_x64():
        ref = JaxSpTRSV.build(L, transpose=transpose, backend="interpret", **kw)
    a, b = ours.stats(), ref.stats()
    assert set(a) == set(b)
    for key in ("strategy", "layout", "transpose", "n", "nnz", "segments",
                "supernode_count", "mean_block_size", "dense_block_fraction",
                "permutation_applied", "packed_value_bytes", "packed_index_bytes",
                "packed_bytes", "pattern_hash", "padded_value_bytes", "n_pad",
                "refreshable_in_place", "critical_path_flops", "rewrite"):
        assert a[key] == b[key], key
    assert a["backend"] == "cpu"
    assert ours.pattern_hash == ref.pattern_hash
    assert ours.dtype == ref.dtype and ours.n == ref.n
