"""The fused kernel's plain torch version against the JAX oracle
``sptrsv_fused/ref.py::fused_solve_ref`` on the JAX fused layout, and the
port's packed fused solve against the same JAX composition; the
single-RHS walk's table (groups, row lengths, pad columns) and its plain
version against both.  (The JAX
``pallas_fused`` kernel itself does not run under this JAX build, so it is
not the reference.)  The CUDA kernel itself is held against
the plain version on the card by ``test_torch_cuda.py``."""
import dataclasses

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
from repro_torch.kernels.sptrsv_fused.ref import fused_solve_ref, fused_walk_ref
from repro_torch.kernels.sptrsv_fused.table import GROUP_ROWS, WIDE_K, fused_table

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


# -- the single-RHS walk's table and its plain version ----------------------

def _layouts(name, transpose, dtype=np.float64):
    """(JAX fused layout, port fused layout) of one matrix and direction."""
    a, b = _schedules(jax_matrix(name, dtype), transpose)
    return j_ops.build_layout(a), ops.build_layout(b)


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("name", ["lung2", "chain", "banded"])
def test_fused_table_groups_and_row_lengths(name, transpose):
    jlay, lay = _layouts(name, transpose)
    table = fused_table(lay, "cpu")
    groups = table.host_groups
    real = lay.perm_rows < lay.n
    # row lengths: the JAX layout's count of real entries
    np.testing.assert_array_equal(table.row_len.numpy(),
                                  (jlay.val_src >= 0).sum(axis=0))
    # every position in exactly one group; real groups first, in order
    p0, r = groups[:, 0], groups[:, 1]
    assert (r >= 1).all() and (r <= GROUP_ROWS).all()
    pos = np.concatenate([np.arange(a, a + k) for a, k in groups])
    assert np.array_equal(np.sort(pos), np.arange(lay.n_pad))
    nr = table.num_real
    assert np.array_equal(pos[: real.sum()], np.flatnonzero(real))
    assert real[pos[: real.sum()]].all() and not real[pos[real.sum():]].any()
    assert (np.diff(p0[:nr]) > 0).all() and (np.diff(p0[nr:]) > 0).all()
    # no group crosses a span or a chunk; wide rows are alone
    span_of = np.repeat(np.arange(len(lay.spans)), [rp for _, rp in lay.spans])
    last = p0 + r - 1
    assert (span_of[p0] == span_of[last]).all()
    assert (p0[:nr] // lay.chunk == last[:nr] // lay.chunk).all()
    wide = table.row_len.numpy()[p0] > WIDE_K
    assert (r[wide] == 1).all()
    if name == "lung2" and transpose:
        assert wide.any()
    # pad columns: the distinct columns of a row's pad slots below its chunk
    K = lay.cols.shape[0]
    rl = table.row_len.numpy()
    lim = np.arange(lay.n_pad) // lay.chunk * lay.chunk
    pad = (np.arange(K)[:, None] >= rl[None, :]) & (lay.cols < lim[None, :])
    hi = np.where(pad, lay.cols, -1).max(axis=0, initial=-1)
    lo = np.where(pad, lay.cols, lay.n_pad).min(axis=0, initial=lay.n_pad)
    want = np.stack([hi, np.where(lo < hi, lo, -1)])
    np.testing.assert_array_equal(table.pad_cols.numpy(), want)
    # every term reads a real row below its group's first position
    pc = table.pad_cols.numpy()
    for a, k in groups[:nr]:
        for p in range(a, a + k):
            c = np.concatenate([lay.cols[: rl[p], p], pc[:, p][pc[:, p] >= 0]])
            assert (c < a).all() and real[c].all()


def test_fused_table_refuses_a_slot_past_the_row_length():
    _, lay = _layouts("lung2", False)
    p = int(np.flatnonzero((lay.val_src >= 0).sum(0) == 1)[0])
    vals = lay.vals.copy()
    vals[2, p] = 0.5                      # a value after the first pad slot
    with pytest.raises(ValueError, match="not a pad"):
        fused_table(dataclasses.replace(lay, vals=vals), "cpu")
    src = lay.val_src.copy()
    src[2, p] = 0                         # a source after the first pad slot
    with pytest.raises(ValueError, match="not a pad"):
        fused_table(dataclasses.replace(lay, val_src=src), "cpu")


def test_fused_table_refuses_a_term_that_could_wait_forever():
    _, lay = _layouts("lung2", False)
    p = lay.spans[3][0]                   # the first row of a later span
    cols = lay.cols.copy()
    cols[0, p] = p                        # it reads itself
    with pytest.raises(ValueError, match="earlier chunk"):
        fused_table(dataclasses.replace(lay, cols=cols), "cpu")


def test_fused_table_survives_refresh():
    from repro_torch.core import SpTRSV
    from repro_torch.sparse import refresh_values

    L = to_port(jax_matrix("lung2", np.float64))
    s = SpTRSV.build(L, strategy="pallas_fused", device="cpu")
    table = s._solve_fn.table
    before = [t.clone() for t in (table.groups, table.row_len, table.pad_cols)]
    s.refresh(refresh_values(L, seed=4))
    assert s._solve_fn.table is table
    for a, b in zip(before, (table.groups, table.row_len, table.pad_cols)):
        assert torch.equal(a, b)


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_fused_walk_ref_matches_chunk_walk(dtype, transpose):
    """The walk's plain version against the plain chunk walk, also with
    inf and NaN at the positions the pad columns read: NaN where it has
    NaN, inf where it has inf, the finite values close."""
    _, lay = _layouts("lung2", transpose, dtype)
    table = fused_table(lay, "cpu")
    cols, vals, diag = (torch.from_numpy(a) for a in (lay.cols.astype(np.int64),
                                                      lay.vals, lay.diag))
    rng = np.random.default_rng(7)
    bl = torch.from_numpy(rng.standard_normal(lay.n_pad).astype(dtype))
    tol = {np.float32: 1e-5, np.float64: 1e-12}[dtype]
    assert _rel(fused_walk_ref(bl, cols, vals, diag, table),
                fused_solve_ref(bl, cols, vals, diag, chunk=lay.chunk)) <= tol
    targets = np.unique(table.pad_cols.numpy()[table.pad_cols.numpy() >= 0])
    assert targets.size == (2 if transpose else 1)
    for bad in (float("inf"), float("nan")):
        b = bl.clone()
        b[torch.from_numpy(targets)] = bad
        got = fused_walk_ref(b, cols, vals, diag, table)
        want = fused_solve_ref(b, cols, vals, diag, chunk=lay.chunk)
        assert torch.isnan(want).any()
        assert torch.equal(torch.isnan(got), torch.isnan(want))
        assert torch.equal(torch.isinf(got), torch.isinf(want))
        fin = torch.isfinite(want)
        assert _rel(got[fin], want[fin]) <= tol


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("name", ["lung2", "chain", "banded"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_packed_fused_walk_matches_jax(dtype, name, transpose):
    """The single-RHS walk's plain version on the port's solver table
    (permute, walk, un-permute) against the JAX oracle on the JAX layout."""
    L = jax_matrix(name, dtype)
    a, b = _schedules(L, transpose)
    lay = j_ops.build_layout(a)
    solve, (vals, diag), _, tlay = ops.make_packed_solver(b, device="cpu")
    rhs = np.random.default_rng(9).standard_normal(L.n).astype(dtype)
    b_ext = np.concatenate([rhs, np.zeros(1, dtype)])
    bl = torch.from_numpy(b_ext[tlay.perm_rows])
    xp = fused_walk_ref(bl, torch.from_numpy(tlay.cols.astype(np.int64)),
                        vals, diag, solve.table)
    got = xp[torch.from_numpy(tlay.pos[: L.n])].numpy()
    want = _jax(j_fused_solve_ref, b_ext[lay.perm_rows], lay.cols, lay.vals,
                lay.diag, chunk=lay.chunk, dtype=dtype)
    np.testing.assert_allclose(got, want[lay.pos[: L.n]], **TOL[dtype])
