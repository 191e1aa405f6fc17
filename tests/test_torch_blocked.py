"""The port's blocked (supernodal) solve against the JAX package: supernode
detection, the block schedule, the packed blocked layout and its value
re-pack array for array, the block-apply kernel's plain version against
the JAX block-apply kernel and ``_dot_apply``, and blocked solves (with
and without rewriting) against ``repro.core.SpTRSV(strategy="blocked")``,
before and after ``refresh``."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

import repro.core.coarsen as j_coarsen
import repro.core.levels as j_levels
import repro.core.packed as j_packed
from repro.compat import enable_x64
from repro.core import RewriteConfig as JaxRewriteConfig
from repro.core import SpTRSV as JaxSpTRSV
from repro.kernels.trsm_block import lowering_tpu as j_trsm_tpu
from repro.kernels.trsm_block.ops import _dot_apply
from repro.sparse import refresh_values

import repro_torch.core.coarsen as t_coarsen
import repro_torch.core.levels as t_levels
import repro_torch.core.packed as t_packed
from repro_torch.core import RewriteConfig, SpTRSV, SupernodeConfig
from repro_torch.kernels.spmv_ell import cuda as spmv_cuda
from repro_torch.kernels.trsm_block import cuda as trsm_cuda
from repro_torch.kernels.trsm_block.ops import block_apply
from repro_torch.kernels.trsm_block.ref import block_apply_ref

from _torch_parity import (MATRICES, TOL, assert_same, carry, jax_matrix,
                           systems, to_port)

NAMES = sorted(MATRICES)
SN_CONFIGS = {"default": dict(), "exact": dict(relax=0.0),
              "relaxed": dict(relax=0.5, max_block=8)}


def _supernodes(name, upper, **cfg):
    sj, st, _, _ = systems(name, upper)
    jc = j_levels.SupernodeConfig(**cfg)
    return (j_levels.detect_supernodes(sj, upper=upper, config=jc),
            t_levels.detect_supernodes(st, upper=upper,
                                       config=carry(jc, SupernodeConfig)),
            sj, st)


@pytest.mark.parametrize("upper", [False, True], ids=["forward", "upper"])
@pytest.mark.parametrize("config", sorted(SN_CONFIGS))
@pytest.mark.parametrize("name", NAMES)
def test_detect_supernodes_matches(name, config, upper):
    a, b, _, _ = _supernodes(name, upper, **SN_CONFIGS[config])
    assert_same(b, a)
    assert b.mean_block_size == a.mean_block_size
    assert b.dense_block_fraction == a.dense_block_fraction


def test_supernodes_found_only_on_the_dense_band():
    assert _supernodes("dense_band", False)[1].mean_block_size > 8
    assert _supernodes("lung2", False)[1].mean_block_size == 1.0
    with pytest.raises(ValueError, match="relax"):
        SupernodeConfig(relax=-0.1)
    with pytest.raises(ValueError, match="max_block"):
        SupernodeConfig(max_block=0)


def _block_schedules(name, upper):
    a, b, sj, st = _supernodes(name, upper)
    return (j_coarsen.build_block_schedule(sj, a, upper=upper),
            t_coarsen.build_block_schedule(st, b, upper=upper), sj, st)


@pytest.mark.parametrize("upper", [False, True], ids=["forward", "upper"])
@pytest.mark.parametrize("name", NAMES)
def test_block_schedule_matches(name, upper):
    a, b, _, _ = _block_schedules(name, upper)
    assert_same(b, a)
    assert (b.num_segments, b.num_blocks, b.panel_flops(), b.gemm_flops()) == \
        (a.num_segments, a.num_blocks, a.panel_flops(), a.gemm_flops())
    np.testing.assert_array_equal(b.perm(), a.perm())


@pytest.mark.parametrize("upper", [False, True], ids=["forward", "upper"])
@pytest.mark.parametrize("name", NAMES)
def test_packed_blocked_layout_and_repack_match(name, upper):
    a, b, sj, _ = _block_schedules(name, upper)
    ja = j_packed.build_packed_blocked_layout(a)
    tb = t_packed.build_packed_blocked_layout(b)
    assert_same(tb, ja)
    assert tb.stats() == t_packed.PackedStats(**vars(ja.stats()))
    rng = np.random.default_rng(3)
    d = sj.data * (1.0 + 0.1 * rng.standard_normal(sj.nnz))
    with enable_x64():  # the JAX re-pack returns jnp arrays
        wants = [np.asarray(w) for w in j_packed.pack_blocked_values(ja, d)]
    for want, got in zip(wants, t_packed.pack_blocked_values(tb, d)):
        assert isinstance(got, np.ndarray)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


# --------------------------------------------------------------------------
# the block-apply kernel's plain version
# --------------------------------------------------------------------------
def _blocks(B, T, m, dtype, seed=0):
    rng = np.random.default_rng(seed)
    dinv = rng.standard_normal((B, T, T)).astype(dtype)
    rhs = rng.standard_normal((B, T, m) if m else (B, T)).astype(dtype)
    return dinv, rhs


@pytest.mark.parametrize("B,T", [(8, 16), (3, 64)])
def test_block_apply_plain_matches_tpu_kernel_f32(B, T):
    dinv, rhs = _blocks(B, T, 0, np.float32)
    want = np.asarray(j_trsm_tpu.block_apply(jnp.asarray(dinv), jnp.asarray(rhs),
                                             batch_block=1, interpret=True))
    got = block_apply_ref(torch.from_numpy(dinv), torch.from_numpy(rhs))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("m", [0, 1, 5])
def test_block_apply_plain_matches_dot_apply_f64(m):
    dinv, rhs = _blocks(6, 24, m, np.float64, seed=1)
    with enable_x64():
        want = np.asarray(_dot_apply(jnp.asarray(dinv), jnp.asarray(rhs)))
    got = block_apply(torch.from_numpy(dinv), torch.from_numpy(rhs))
    assert tuple(got.shape) == rhs.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL[np.float64])


def test_block_apply_checks():
    dinv, rhs = _blocks(2, 4, 0, np.float64)
    with pytest.raises(ValueError, match="CUDA"):
        trsm_cuda.block_apply(torch.from_numpy(dinv), torch.from_numpy(rhs))
    with pytest.raises(ValueError, match="device"):
        block_apply(torch.from_numpy(dinv).to("meta"),
                    torch.from_numpy(rhs).to("meta"))


# --------------------------------------------------------------------------
# blocked solves against repro.core.SpTRSV
# --------------------------------------------------------------------------
_JAX = {}


def _jax_pair(name, dtype, rewrite):
    key = (name, np.dtype(dtype).name, rewrite)
    if key not in _JAX:
        with enable_x64(dtype == np.float64):
            _JAX[key] = JaxSpTRSV.build_pair(
                jax_matrix(name, dtype), strategy="blocked",
                rewrite=JaxRewriteConfig() if rewrite else None)
    return _JAX[key]


def _jax_solve(s, rhs, dtype):
    with enable_x64(dtype == np.float64):
        return np.asarray(s.solve(jnp.asarray(rhs)))


def _rhs(n, dtype, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n).astype(dtype),
            rng.standard_normal((n, 3)).astype(dtype))


@pytest.mark.parametrize("rewrite", [False, True], ids=["plain", "rewrite"])
@pytest.mark.parametrize("name", ["dense_band", "lung2"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_blocked_solves_match_jax(dtype, name, rewrite):
    L = jax_matrix(name, dtype)
    Lt = to_port(L)
    kw = dict(strategy="blocked", device="cpu",
              rewrite=RewriteConfig() if rewrite else None)
    pair = SpTRSV.build_pair(Lt, **kw)
    single = tuple(SpTRSV.build(Lt, transpose=tr, **kw) for tr in (False, True))
    new = refresh_values(L, seed=4)
    dense = to_port(L).to_dense().astype(np.float64) * 0
    dense[np.repeat(np.arange(L.n), np.diff(L.indptr)), L.indices] = new
    tol = TOL[dtype] if dtype == np.float64 else dict(rtol=1e-4, atol=1e-5)
    for s, s1, ref in zip(pair, single, _jax_pair(name, dtype, rewrite)):
        assert s.supernodes is not None and s.schedule is None
        for rhs in _rhs(L.n, dtype, seed=1):
            got = s.solve(torch.from_numpy(rhs))
            assert got.dtype == torch.from_numpy(rhs).dtype
            np.testing.assert_allclose(got.numpy(), _jax_solve(ref, rhs, dtype),
                                       **TOL[dtype])
            np.testing.assert_array_equal(s1.solve(torch.from_numpy(rhs)).numpy(),
                                          got.numpy())
        ptrs = [v.data_ptr() for v in s._values]
        assert s.refresh(new) is s
        assert [v.data_ptr() for v in s._values] == ptrs
        A = dense.T if s.transpose else dense
        for rhs in _rhs(L.n, dtype, seed=2):
            np.testing.assert_allclose(s.solve(torch.from_numpy(rhs)).numpy(),
                                       np.linalg.solve(A, rhs), **tol)
        s.refresh(L.data)
        rhs = _rhs(L.n, dtype, seed=3)[1]
        np.testing.assert_allclose(s.solve(torch.from_numpy(rhs)).numpy(),
                                   _jax_solve(ref, rhs, dtype), **TOL[dtype])


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("rewrite", [False, True], ids=["plain", "rewrite"])
def test_blocked_stats_match_jax(rewrite, transpose):
    ours = SpTRSV.build(to_port(jax_matrix("dense_band")), transpose=transpose,
                        strategy="blocked", device="cpu",
                        rewrite=RewriteConfig() if rewrite else None)
    a = ours.stats()
    b = _jax_pair("dense_band", np.float64, rewrite)[int(transpose)].stats()
    assert set(a) == set(b)
    for key in b:
        if key != "backend":
            assert a[key] == b[key], key
    assert a["segments"] == ours.block_schedule.num_segments
    # rewriting the band's one-row levels fills its rows unevenly, and the
    # rewritten factor amalgamates to singletons, in both packages
    assert (a["mean_block_size"] > 8) is not rewrite


def test_blocked_supernode_config_and_block_kernel_option():
    L = to_port(jax_matrix("dense_band"))
    s = SpTRSV.build(L, strategy="blocked", device="cpu",
                     supernodes=SupernodeConfig(relax=0.5, max_block=8))
    assert s.supernodes.max_block_size <= 8
    for flag in (True, False):
        assert SpTRSV.build(L, strategy="blocked", device="cpu",
                            supernodes=flag).supernodes.config == SupernodeConfig()
    with pytest.raises(TypeError, match="supernodes"):
        SpTRSV.build(L, strategy="blocked", device="cpu", supernodes="dense")
    for kernel in ("pallas", "jnp"):
        with pytest.raises(ValueError, match="block_kernel"):
            SpTRSV.build(L, strategy="blocked", device="cpu", block_kernel=kernel)
    b = np.ones(L.n)
    x = SpTRSV.build(L, strategy="blocked", device="cpu", block_kernel="auto")
    np.testing.assert_allclose(x.solve(torch.from_numpy(b)).numpy(),
                               np.linalg.solve(L.to_dense(), b), **TOL[np.float64])


def test_blocked_cpu_solves_launch_no_kernel():
    before = {**spmv_cuda.launches, **trsm_cuda.launches}
    L = to_port(jax_matrix("dense_band"))
    for s in SpTRSV.build_pair(L, strategy="blocked", device="cpu",
                               rewrite=RewriteConfig()):
        s.solve(torch.ones((L.n, 2), dtype=torch.float64))
    assert {**spmv_cuda.launches, **trsm_cuda.launches} == before
