"""The port's ``serial`` and ``levelset_unroll`` strategies (on
``device="cpu"``) against the JAX package's: single and batched RHS, both
directions, ``build_pair``, ``build_cold``, refresh and ``stats()``; the
host arrays they are built from; and the fused kernels' plain versions
held against ``serial``."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

import repro.core.codegen as j_codegen
import repro.core.packed as j_packed
from repro.compat import enable_x64
from repro.core import RewriteConfig as JaxRewriteConfig
from repro.core import SpTRSV as JaxSpTRSV
from repro.sparse import refresh_values

import repro_torch.core.codegen as t_codegen
import repro_torch.core.packed as t_packed
from repro_torch.core import RewriteConfig, SpTRSV

from _torch_parity import TOL, carry, jax_matrix, to_port

VARIANTS = {
    "serial": dict(strategy="serial"),
    "levelset_unroll": dict(strategy="levelset_unroll"),
    "levelset_unroll+coarsen": dict(strategy="levelset_unroll", coarsen=True),
}
# the JAX package's rewrite tolerance
RW_TOL = {np.float32: dict(rtol=1e-4, atol=1e-4),
          np.float64: dict(rtol=1e-8, atol=1e-8)}


def _rhs(n, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n).astype(dtype),
            rng.standard_normal((n, 3)).astype(dtype))


def _jax_solve(s, rhs):
    return np.asarray(s.solve(jnp.asarray(rhs)))


def _pair(L, dtype, kw, **extra):
    """(port (fwd, bwd), JAX (fwd, bwd)) of one factor and options."""
    ours = SpTRSV.build_pair(to_port(L), device="cpu", **kw, **extra)
    jextra = {k: (carry(v, JaxRewriteConfig) if k == "rewrite" else v)
              for k, v in extra.items()}
    with enable_x64(dtype == np.float64):
        ref = JaxSpTRSV.build_pair(L, backend="interpret", **kw, **jextra)
    return ours, ref


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_solves_match_jax(dtype, variant):
    L = jax_matrix("lung2", dtype)
    (fwd, bwd), (jf, jb) = _pair(L, dtype, VARIANTS[variant])
    assert (fwd.strategy, bwd.strategy) == (jf.strategy, jb.strategy)
    for ours, ref in ((fwd, jf), (bwd, jb)):
        for rhs in _rhs(L.n, dtype):
            got = ours.solve(torch.from_numpy(rhs))
            assert got.dtype == torch.from_numpy(rhs).dtype
            with enable_x64(dtype == np.float64):
                want = _jax_solve(ref, rhs)
            np.testing.assert_allclose(got.numpy(), want, **TOL[dtype])
    r = _rhs(L.n, dtype, seed=4)[1]
    z = bwd.solve(fwd.solve(torch.from_numpy(r))).numpy()
    dense = L.to_dense().astype(np.float64)
    tol = TOL[dtype] if dtype == np.float64 else dict(rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(z, np.linalg.solve(dense @ dense.T, r), **tol)


# the JAX package compiles every unrolled row of a deep matrix (the bands:
# ~300 one-row levels) as scalar code, tens of seconds: unroll runs on the
# shallower structures
@pytest.mark.parametrize("name,variant", [
    ("chain", "serial"), ("banded", "serial"), ("random", "serial"),
    ("dense_band", "serial"), ("chain", "levelset_unroll"),
    ("random", "levelset_unroll")])
def test_other_structures_match_jax(name, variant):
    L = jax_matrix(name)
    (fwd, bwd), (jf, jb) = _pair(L, np.float64, VARIANTS[variant])
    b = _rhs(L.n, np.float64, seed=2)[1]
    with enable_x64():
        for ours, ref in ((fwd, jf), (bwd, jb)):
            np.testing.assert_allclose(ours.solve(torch.from_numpy(b)).numpy(),
                                       _jax_solve(ref, b), **TOL[np.float64])


@pytest.mark.parametrize("variant", ["serial", "levelset_unroll"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_rewritten_match_jax(dtype, variant):
    L = jax_matrix("lung2", dtype)
    (fwd, bwd), (jf, jb) = _pair(L, dtype, VARIANTS[variant],
                                 rewrite=RewriteConfig())
    b = _rhs(L.n, dtype, seed=3)[1]
    dense = L.to_dense().astype(np.float64)
    for ours, ref, A in ((fwd, jf, dense), (bwd, jb, dense.T)):
        got = ours.solve(torch.from_numpy(b)).numpy()
        with enable_x64(dtype == np.float64):
            np.testing.assert_allclose(got, _jax_solve(ref, b), **RW_TOL[dtype])
        np.testing.assert_allclose(got, np.linalg.solve(A, b), **RW_TOL[dtype])
        assert ours.stats()["rewrite"] == ref.stats()["rewrite"]


@pytest.mark.parametrize("variant", ["serial", "levelset_unroll",
                                     "levelset_unroll+coarsen"])
def test_refresh_matches_jax(variant):
    L = jax_matrix("lung2")
    (fwd, bwd), (jf, jb) = _pair(L, np.float64, VARIANTS[variant])
    new = refresh_values(L, seed=7)
    b = _rhs(L.n, np.float64, seed=5)[1]
    with enable_x64():
        for ours, ref in ((fwd, jf), (bwd, jb)):
            ptrs = [v.data_ptr() for v in ours._values]
            ours.refresh(new)
            ref.refresh(new)
            assert ptrs == [v.data_ptr() for v in ours._values]
            np.testing.assert_allclose(ours.solve(torch.from_numpy(b)).numpy(),
                                       _jax_solve(ref, b), **TOL[np.float64])


@pytest.mark.parametrize("transpose_too", [False, True])
def test_build_cold_matches_jax(transpose_too):
    L = jax_matrix("lung2")
    ours = SpTRSV.build_cold(to_port(L), transpose_too=transpose_too,
                             device="cpu", strategy="pallas_fused")
    with enable_x64():
        ref = JaxSpTRSV.build_cold(L, transpose_too=transpose_too,
                                   backend="interpret")
        b = _rhs(L.n, np.float64, seed=6)[0]
        assert (ours[1] is None) == (ref[1] is None) == (not transpose_too)
        for o, r in zip(ours, ref):
            if o is None:
                continue
            assert o.strategy == r.strategy == "serial"
            np.testing.assert_allclose(o.solve(torch.from_numpy(b)).numpy(),
                                       _jax_solve(r, b), **TOL[np.float64])


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("variant", ["serial", "levelset_unroll",
                                     "levelset_unroll+coarsen"])
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
                "permutation_applied", "packed_value_bytes",
                "packed_index_bytes", "packed_bytes", "pattern_hash",
                "padded_value_bytes", "n_pad", "refreshable_in_place",
                "critical_path_flops", "rewrite", "plan", "sweep", "guard"):
        assert a[key] == b[key], key


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("name", ["lung2", "chain", "random"])
def test_host_arrays_match_jax(name, transpose):
    Lj = jax_matrix(name)
    Lt = to_port(Lj)
    sj, st = (Lj.transpose(), Lt.transpose()) if transpose else (Lj, Lt)
    for a, b in zip(t_codegen.serial_arrays(st, upper=transpose),
                    j_codegen.serial_arrays(sj, upper=transpose)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    ell_t, d_t, ds_t = t_codegen.build_offdiag_ell(st, upper=transpose)
    ell_j, d_j, ds_j = j_codegen.build_offdiag_ell(sj, upper=transpose)
    for a, b in ((ell_t.cols, ell_j.cols), (ell_t.vals, ell_j.vals),
                 (ell_t.val_src, ell_j.val_src), (d_t, d_j), (ds_t, ds_j)):
        np.testing.assert_array_equal(a, b)
    assert t_packed.ell_packed_stats(ell_t, d_t, n=st.n).__dict__ == \
        j_packed.ell_packed_stats(ell_j, d_j, n=sj.n).__dict__
    # ell_spmv against the JAX package's, single and batched
    ell = t_codegen.build_ell(st)
    dev_ell = t_codegen.device_ell(ell, st.n, "cpu")
    for v in _rhs(st.n, np.float64, seed=8):
        with enable_x64():
            want = np.asarray(j_codegen.ell_spmv(j_codegen.build_ell(sj),
                                                 jnp.asarray(v)))
        got = t_codegen.ell_spmv(dev_ell, torch.from_numpy(v)).numpy()
        np.testing.assert_allclose(got, want, **TOL[np.float64])


def test_serial_solver_repack_matches_jax():
    L = jax_matrix("lung2")
    new = refresh_values(L, seed=9)
    for upper in (False, True):
        Lt = to_port(L).transpose() if upper else to_port(L)
        Lj = L.transpose() if upper else L
        _, v0, repack = t_packed.make_packed_serial_solver(Lt, upper=upper,
                                                           device="cpu")
        with enable_x64():
            _, jv0, jrepack = j_packed.make_packed_serial_solver(Lj, upper=upper)
            data = new[np.argsort(L.indices, kind="stable")] if upper else new
            for a, b in zip(v0, jv0):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
            for a, b in zip(repack(data), jrepack(data)):
                np.testing.assert_array_equal(a, np.asarray(b))


def test_cast_value_buffers():
    vals = torch.arange(6, dtype=torch.float64).reshape(2, 3) / 7
    diag = torch.ones(3, dtype=torch.float64) / 3
    cv, cd = t_packed.cast_value_buffers((vals, diag))
    assert (cv.dtype, cd.dtype) == (torch.bfloat16, torch.float32)
    with enable_x64():
        jv, jd = j_packed.cast_value_buffers((jnp.asarray(vals.numpy()),
                                              jnp.asarray(diag.numpy())))
        np.testing.assert_array_equal(cv.float().numpy(),
                                      np.asarray(jv.astype(jnp.float32)))
        np.testing.assert_array_equal(cd.numpy(), np.asarray(jd))


@pytest.mark.parametrize("name", ["lung2", "chain", "random", "banded"])
@pytest.mark.parametrize("transpose", [False, True])
def test_fused_plain_versions_match_serial(name, transpose):
    """The single-RHS and batched fused solves' plain versions (what
    ``pallas_fused`` runs on the CPU) against ``serial`` on the same
    factor."""
    L = to_port(jax_matrix(name))
    fused = SpTRSV.build(L, strategy="pallas_fused", transpose=transpose,
                         device="cpu")
    serial = SpTRSV.build(L, strategy="serial", transpose=transpose,
                          device="cpu")
    for rhs in _rhs(L.n, np.float64, seed=11):
        b = torch.from_numpy(rhs)
        np.testing.assert_allclose(fused.solve(b).numpy(),
                                   serial.solve(b).numpy(), **TOL[np.float64])
