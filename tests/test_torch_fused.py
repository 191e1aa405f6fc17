"""The fused kernel's plain torch version against the JAX oracle
``sptrsv_fused/ref.py::fused_solve_ref`` on the JAX fused layout, and the
port's packed fused solve against the same JAX composition.  (The JAX
``pallas_fused`` kernel itself does not run under this JAX build, so it is
not the reference.)  The CUDA kernel itself is held against
the plain version on the card by ``test_torch_cuda.py``."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.compat import enable_x64
from repro.core.codegen import build_schedule as j_build_schedule
from repro.core.levels import build_level_sets as j_levels, \
    build_reverse_level_sets as j_rlevels
from repro.kernels.sptrsv_fused import ops as j_ops
from repro.kernels.sptrsv_fused.ref import fused_solve_ref as j_fused_solve_ref

from repro_torch.core.codegen import build_schedule
from repro_torch.core.levels import build_level_sets, build_reverse_level_sets
from repro_torch.kernels.sptrsv_fused import cuda as fused_cuda
from repro_torch.kernels.sptrsv_fused import ops
from repro_torch.kernels.sptrsv_fused.ref import fused_solve_ref

from _torch_parity import TOL, jax_matrix, to_port


def _jax(fn, *args, dtype, **kw):
    if dtype == np.float64:
        with enable_x64():
            return np.asarray(fn(*map(jnp.asarray, args), **kw))
    return np.asarray(fn(*map(jnp.asarray, args), **kw))


@pytest.mark.parametrize("m", [1, 4])
@pytest.mark.parametrize("K,nchunks", [(1, 1), (4, 3), (9, 7)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_fused_ref_matches_jax_ref(dtype, K, nchunks, m):
    """Chunks form a dependency chain: chunk c may read any position < c*C."""
    rng = np.random.default_rng(K * 31 + nchunks + m)
    C = 256
    n_pad = nchunks * C
    cols = np.zeros((K, n_pad), np.int32)
    for c in range(1, nchunks):
        cols[:, c * C: (c + 1) * C] = rng.integers(0, c * C, size=(K, C))
    vals = (0.3 * rng.standard_normal((K, n_pad))).astype(dtype)
    vals[:, :C] = 0.0
    bl = rng.standard_normal((n_pad,) if m == 1 else (n_pad, m)).astype(dtype)
    diag = (2.0 + rng.random(n_pad)).astype(dtype)
    got = fused_solve_ref(*map(torch.from_numpy, (bl, cols, vals, diag)),
                          chunk=C).numpy()
    assert got.dtype == dtype and got.shape == bl.shape
    want = _jax(j_fused_solve_ref, bl, cols, vals, diag, chunk=C, dtype=dtype)
    np.testing.assert_allclose(got, want, **TOL[dtype])


def _schedules(L, transpose):
    Lt = to_port(L)
    if transpose:
        return (j_build_schedule(L.transpose(), j_rlevels(L), upper=True),
                build_schedule(Lt.transpose(), build_reverse_level_sets(Lt),
                               upper=True))
    return j_build_schedule(L, j_levels(L)), build_schedule(Lt, build_level_sets(Lt))


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("name", ["lung2", "chain", "banded"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_packed_fused_solve_matches_jax(dtype, name, transpose):
    """The port's solve (permute, plain walk, un-permute) against the JAX
    oracle on the JAX layout and against a dense solve, single and batched."""
    L = jax_matrix(name, dtype)
    a, b = _schedules(L, transpose)
    lay = j_ops.build_layout(a)
    solve, vals, _, tlay = ops.make_packed_solver(b, device="cpu")
    assert tlay.spans == lay.spans
    rng = np.random.default_rng(5)
    dense = L.to_dense().astype(np.float64)
    A = dense.T if transpose else dense
    for rhs in (rng.standard_normal(L.n), rng.standard_normal((L.n, 3))):
        rhs = rhs.astype(dtype)
        got = solve(torch.from_numpy(rhs), vals).numpy()
        b_ext = np.concatenate([rhs, np.zeros((1,) + rhs.shape[1:], dtype)])
        xp = _jax(j_fused_solve_ref, b_ext[lay.perm_rows], lay.cols, lay.vals,
                  lay.diag, chunk=lay.chunk, dtype=dtype)
        np.testing.assert_allclose(got, xp[lay.pos[: L.n]], **TOL[dtype])
        tol = TOL[dtype] if dtype == np.float64 else dict(rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(got, np.linalg.solve(A, rhs), **tol)


def test_cuda_wrapper_refuses_cpu_tensors():
    x = torch.zeros(512)
    before = dict(fused_cuda.launches)
    with pytest.raises(ValueError, match="CUDA"):
        fused_cuda.fused_solve(x, torch.zeros((1, 512), dtype=torch.int32),
                               x[None], x, torch.zeros((1, 2), dtype=torch.int32))
    assert fused_cuda.launches == before
