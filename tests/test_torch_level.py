"""The level kernel's plain torch version against the JAX TPU lowering
(``level_solve_blocks{,_batched}`` under the pallas interpreter) and the
JAX oracle, and the packed level-scheduled solve against the JAX packed
solver.  The CUDA kernel itself is held against the
plain version on the card by ``test_torch_cuda.py``."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

import repro.sparse as jsparse
from repro.compat import enable_x64
from repro.core.coarsen import coarsen_schedule as j_coarsen_schedule
from repro.core.codegen import build_schedule as j_build_schedule
from repro.core.levels import build_level_sets as j_levels, \
    build_reverse_level_sets as j_rlevels
from repro.kernels.sptrsv_level import lowering_tpu
from repro.kernels.sptrsv_level import ops as j_ops
from repro.kernels.sptrsv_level.ref import level_solve_ref as j_level_solve_ref

from repro_torch.core.coarsen import coarsen_schedule
from repro_torch.core.codegen import build_schedule
from repro_torch.core.levels import build_level_sets, build_reverse_level_sets
from repro_torch.core.packed import segment_steps
from repro_torch.kernels.sptrsv_level import cuda as level_cuda
from repro_torch.kernels.sptrsv_level import ops
from repro_torch.kernels.sptrsv_level.ref import level_solve_ref

from _torch_parity import TOL, jax_matrix, to_port


def _inputs(rng, K, n_pad, R_pad, m, dtype):
    xs = (n_pad,) if m == 1 else (n_pad, m)
    bs = (R_pad,) if m == 1 else (R_pad, m)
    return (rng.standard_normal(xs).astype(dtype),
            rng.standard_normal(bs).astype(dtype),
            rng.integers(0, n_pad, size=(K, R_pad)).astype(np.int32),
            (0.3 * rng.standard_normal((K, R_pad))).astype(dtype),
            (2.0 + rng.random(R_pad)).astype(dtype))


def _jax_run(fn, *args, dtype, **kw):
    if dtype == np.float64:
        with enable_x64():
            return np.asarray(fn(*map(jnp.asarray, args), **kw))
    return np.asarray(fn(*map(jnp.asarray, args), **kw))


@pytest.mark.parametrize("m", [1, 3])
@pytest.mark.parametrize("K", [1, 4, 9])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_level_ref_matches_jax_kernel(dtype, K, m):
    rng = np.random.default_rng(10 * K + m)
    args = _inputs(rng, K, 1024, 256, m, dtype)
    got = level_solve_ref(*map(torch.from_numpy, args)).numpy()
    assert got.dtype == dtype
    np.testing.assert_allclose(
        got, _jax_run(j_level_solve_ref, *args, dtype=dtype), **TOL[dtype])
    kern = (lowering_tpu.level_solve_blocks if m == 1
            else lowering_tpu.level_solve_blocks_batched)
    try:
        want = _jax_run(kern, *args, dtype=dtype, block_rows=128, interpret=True)
    except NotImplementedError as err:  # pragma: no cover
        pytest.skip(f"pallas interpret mode unsupported here: {err}")
    np.testing.assert_allclose(got, want, **TOL[dtype])


def _schedules(L, transpose, coarsen):
    Lt = to_port(L)
    if transpose:
        a = j_build_schedule(L.transpose(), j_rlevels(L), upper=True)
        b = build_schedule(Lt.transpose(), build_reverse_level_sets(Lt), upper=True)
    else:
        a = j_build_schedule(L, j_levels(L))
        b = build_schedule(Lt, build_level_sets(Lt))
    if coarsen:
        a, b = j_coarsen_schedule(a), coarsen_schedule(b)
    return a, b


@pytest.mark.parametrize("coarsen", [False, True])
@pytest.mark.parametrize("transpose", [False, True])
def test_packed_level_solve_matches_jax(transpose, coarsen):
    """The port's packed level walk (plain version on the CPU) against the
    JAX packed solver running the TPU kernel under the interpreter, one RHS
    and a batch, on a coarsened (chained) schedule too."""
    dtype = np.float32
    L = jsparse.lung2_like(scale=0.01, fat_levels=3, thin_run=5, dtype=dtype)
    a, b = _schedules(L, transpose, coarsen)
    try:
        jsolve, jvals, _, _ = j_ops.make_packed_solver(a, backend="interpret")
    except NotImplementedError as err:  # pragma: no cover
        pytest.skip(f"pallas interpret mode unsupported here: {err}")
    tsolve, tvals, _, _ = ops.make_packed_solver(b, device="cpu")
    rng = np.random.default_rng(3)
    dense = L.to_dense().astype(np.float64)
    A = dense.T if transpose else dense
    for rhs in (rng.standard_normal(L.n), rng.standard_normal((L.n, 3))):
        rhs = rhs.astype(dtype)
        got = tsolve(torch.from_numpy(rhs), tvals).numpy()
        np.testing.assert_allclose(got, np.asarray(jsolve(jnp.asarray(rhs), jvals)),
                                   **TOL[dtype])
        np.testing.assert_allclose(got, np.linalg.solve(A, rhs), rtol=1e-4, atol=1e-5)


def test_packed_level_solve_f64_matches_dense():
    L = jax_matrix("lung2")
    _, b = _schedules(L, False, True)
    tsolve, tvals, repack, lay = ops.make_packed_solver(b, device="cpu")
    steps = segment_steps(lay)
    assert len(steps) == b.total_depth  # one launch per wavefront
    rhs = np.random.default_rng(4).standard_normal((L.n, 2))
    got = tsolve(torch.from_numpy(rhs), tvals).numpy()
    np.testing.assert_allclose(got, np.linalg.solve(L.to_dense(), rhs), **TOL[np.float64])


def test_segment_steps_cover_every_wavefront():
    L = jax_matrix("lung2")
    _, b = _schedules(L, False, True)
    _, _, _, lay = ops.make_packed_solver(b, device="cpu")
    steps = segment_steps(lay)
    assert steps.dtype == np.int64 and steps.flags.c_contiguous
    o, K, Rp, voff, doff = steps.T
    # every permuted row is written by exactly the step that owns it
    assert (np.diff(o) > 0).all() and o[0] == 0
    assert (voff + K * Rp).max() <= lay.vals_flat.size
    assert (doff + Rp).max() <= lay.diag_flat.size
    assert (o + Rp).max() <= lay.n_pad


def test_cuda_wrapper_refuses_cpu_tensors():
    x = torch.zeros(8)
    before = dict(level_cuda.launches)
    with pytest.raises(ValueError, match="CUDA"):
        level_cuda.level_walk(x, x, torch.zeros(4, dtype=torch.int32), x, x,
                              np.zeros((1, 5), np.int64))
    assert level_cuda.launches == before
