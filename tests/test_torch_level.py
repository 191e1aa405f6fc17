"""The level kernel's plain torch version against the JAX TPU lowering
(``level_solve_blocks{,_batched}`` under the pallas interpreter) and the
JAX oracle, the packed level-scheduled solve against the JAX packed
solver, and the level walk's segment table (one row per segment, chains
expanded only by the plain version) and row lengths.  The CUDA kernels
themselves are held against the plain version on the card by
``test_torch_cuda.py``."""
import dataclasses
from pathlib import Path

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
from repro_torch.core.csr import CSRMatrix
from repro_torch.core.packed import (level_table, pack_values, row_lengths,
                                     segment_table)
from repro_torch.kernels.sptrsv_level import cuda as level_cuda
from repro_torch.kernels.sptrsv_level import ops
from repro_torch.kernels.sptrsv_level.ref import level_solve_ref, level_walk_ref
from repro_torch.kernels.sptrsv_level.table import WIDE_K, make_level_table

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
    table = level_table(lay, "cpu")
    # one launch per segment, one plain-version step per wavefront
    assert table.num_segments == len(lay.segments) < b.total_depth
    assert len(table.steps) == b.total_depth
    rhs = np.random.default_rng(4).standard_normal((L.n, 2))
    got = tsolve(torch.from_numpy(rhs), tvals).numpy()
    np.testing.assert_allclose(got, np.linalg.solve(L.to_dense(), rhs), **TOL[np.float64])


def test_segment_steps_cover_every_wavefront():
    L = jax_matrix("lung2")
    _, b = _schedules(L, False, True)
    _, _, _, lay = ops.make_packed_solver(b, device="cpu")
    steps = level_table(lay, "cpu").steps
    assert steps.dtype == np.int64 and steps.flags.c_contiguous
    o, K, Rp, voff, doff = steps.T
    # every permuted row is written by exactly the step that owns it
    assert (np.diff(o) > 0).all() and o[0] == 0
    assert (voff + K * Rp).max() <= lay.vals_flat.size
    assert (doff + Rp).max() <= lay.diag_flat.size
    assert (o + Rp).max() <= lay.n_pad


def test_cuda_wrapper_refuses_cpu_tensors():
    x = torch.zeros(8)
    table = make_level_table(np.array([[0, 1, 4, 0, 0, 1, -1]]),
                             np.zeros(0, np.int64), np.zeros(4, np.int32), "cpu")
    before = dict(level_cuda.launches)
    with pytest.raises(ValueError, match="CUDA"):
        level_cuda.level_walk(x, x, torch.zeros(4, dtype=torch.int32), x, x,
                              table)
    assert level_cuda.launches == before


def test_wide_k_matches_the_kernel():
    src = (Path(__file__).resolve().parents[1]
           / "src/repro_torch/kernels/csrc/sptrsv_level.cu").read_text()
    assert f"constexpr int kWideK = {WIDE_K};" in src


def _old_steps(lay):
    """The step table of the walk before chains ran as one launch: one row
    ``(o, K, R_pad, val_off, diag_off)`` per wavefront, a chain's ``depth``
    sub-steps at its ``sub_offs``."""
    rows = []
    for seg in lay.segments:
        offs = seg.sub_offs if seg.kind == "chain" else (seg.off,)
        for t, o in enumerate(offs):
            rows.append((int(o), seg.K, seg.R_pad,
                         seg.val_off + t * seg.K * seg.R_pad,
                         seg.diag_off + t * seg.R_pad))
    return np.array(rows, dtype=np.int64).reshape(-1, 5)


def _wide_factor(n=300, wide=200, seed=0):
    """A random lower factor (up to 3 entries left of the diagonal) whose
    last row has ``wide`` entries left of it: a level of K > 32."""
    rng = np.random.default_rng(seed)
    rows = [np.unique(rng.integers(0, i, size=min(i, 3))) if i else
            np.zeros(0, np.int64) for i in range(n - 1)]
    rows.append(np.sort(rng.choice(n - 1, size=wide, replace=False)))
    indptr = np.concatenate([[0], np.cumsum([len(r) + 1 for r in rows])])
    indices = np.concatenate([np.append(r, i) for i, r in enumerate(rows)])
    data = rng.uniform(-1, 1, indices.size) / 8
    data[indptr[1:] - 1] = 2.0 + rng.random(n)
    return CSRMatrix.from_numpy(indptr, indices, data, (n, n))


def _port_layout(case):
    if case == "wide":
        L = _wide_factor()
        return ops.make_packed_solver(
            build_schedule(L, build_level_sets(L)), device="cpu")[3]
    transpose = case.endswith("T")
    _, b = _schedules(jsparse.lung2_like(scale=0.01, fat_levels=3, thin_run=5),
                      transpose, coarsen=True)
    return ops.make_packed_solver(b, device="cpu")[3]


@pytest.mark.parametrize("case", ["lung2", "lung2T", "wide"])
def test_segment_table_has_one_row_per_segment(case):
    """One table row per segment; the chains' sub-steps, expanded, are the
    old per-wavefront step table, and the plain walk over the new table
    equals the old walk bit for bit."""
    lay = _port_layout(case)
    geo, subs = segment_table(lay)
    table = level_table(lay, "cpu")
    assert geo.shape == (len(lay.segments), 7) and geo.dtype == np.int64
    np.testing.assert_array_equal(table.host, geo)
    chains = [s for s in lay.segments if s.kind == "chain"]
    assert (case == "wide") == (not chains)
    assert subs.size == sum(s.depth for s in chains)
    for row, seg in zip(geo.tolist(), lay.segments):
        o, K, Rp, vo, do, depth, so = row
        assert (o, K, Rp, vo, do, depth) == (seg.off, seg.K, seg.R_pad,
                                             seg.val_off, seg.diag_off, seg.depth)
        if seg.kind == "chain":
            np.testing.assert_array_equal(subs[so: so + depth], seg.sub_offs)
        else:
            assert so == -1
    old = _old_steps(lay)
    np.testing.assert_array_equal(table.steps, old)
    assert sum(table.kinds().values()) == table.num_segments
    rng = np.random.default_rng(5)
    cols = torch.from_numpy(lay.cols_flat.astype(np.int64))
    vals, diag = map(torch.from_numpy, (lay.vals_flat, lay.diag_flat))
    for m in (1, 3):
        shape = (table.need["x"],) + (() if m == 1 else (m,))
        x0 = torch.from_numpy(rng.standard_normal(shape))
        bhat = torch.from_numpy(rng.standard_normal(shape))
        got, want = x0.clone(), x0.clone()
        level_walk_ref(got, bhat, cols, vals, diag, table)
        for o, K, Rp, vo, do in old.tolist():
            want[o: o + Rp] = level_solve_ref(
                want, bhat[o: o + Rp], cols[vo: vo + K * Rp].view(K, Rp),
                vals[vo: vo + K * Rp].view(K, Rp), diag[do: do + Rp])
        assert torch.equal(got, want)


@pytest.mark.parametrize("case", ["lung2", "lung2T", "wide"])
def test_row_lengths_count_real_entries(case):
    """Each row's length is its count of ``vals_src >= 0``; every slot past
    it is a pad (no source, value 0, the row's one pad column); a re-pack
    of new values leaves the lengths as they are."""
    lay = _port_layout(case)
    lens = row_lengths(lay)
    assert lens.dtype == np.int32 and lens.shape == lay.diag_flat.shape
    table = level_table(lay, "cpu")
    np.testing.assert_array_equal(table.row_len.numpy(), lens)
    widest = 0
    for seg in lay.segments:
        d, K, Rp = seg.depth, seg.K, seg.R_pad
        span = slice(seg.val_off, seg.val_off + d * K * Rp)
        src = lay.vals_src[span].reshape(d, K, Rp)
        n = lens[seg.diag_off: seg.diag_off + d * Rp].reshape(d, Rp)
        np.testing.assert_array_equal(n, (src >= 0).sum(1))
        cols = lay.cols_flat[span].reshape(d, K, Rp)
        vals = lay.vals_flat[span].reshape(d, K, Rp)
        for t, r in zip(*np.nonzero(n < K)):
            k = n[t, r]
            assert (src[t, k:, r] < 0).all() and (vals[t, k:, r] == 0).all()
            assert (cols[t, k:, r] == cols[t, k, r]).all()
        widest = max(widest, int(n.max()))
    if case == "wide":
        assert widest == 200 and table.kinds()["segment_warp"] > 0
    else:
        assert table.kinds()["chain"] > 0
    data = np.random.default_rng(6).uniform(1, 2, int(lay.vals_src.max()) + 1
                                            + int(lay.diag_src.max()) + 1)
    vals, diag = pack_values(lay, data)
    np.testing.assert_array_equal(
        row_lengths(dataclasses.replace(lay, vals_flat=vals, diag_flat=diag)), lens)


def test_row_lengths_and_table_refuse_bad_layouts():
    lay = _port_layout("wide")
    src = lay.vals_src.copy()
    # a source in the last slot of a pad row: a real entry after pads
    seg = next(s for s in lay.segments if s.K > 1 and s.R < s.R_pad)
    src[seg.val_off + (seg.K - 1) * seg.R_pad + seg.R] = 0
    with pytest.raises(ValueError, match="not a pad"):
        row_lengths(dataclasses.replace(lay, vals_src=src))
    geo, subs = segment_table(_port_layout("lung2"))
    lens = np.zeros(10 ** 6, np.int32)
    c = int(np.nonzero(geo[:, 6] >= 0)[0][0])
    bad = geo.copy()
    bad[c, 0] += 1                      # the chain's o is not its first offset
    with pytest.raises(ValueError, match="chains"):
        make_level_table(bad, subs, lens, "cpu")
    bad = geo.copy()
    bad[c, 5] = subs.size + 1           # more sub-steps than offsets
    with pytest.raises(ValueError, match="chains"):
        make_level_table(bad, subs, lens, "cpu")
    with pytest.raises(ValueError, match="cover"):
        make_level_table(geo, subs, lens[:10], "cpu")
    lens[:] = 99
    with pytest.raises(ValueError, match="outside"):
        make_level_table(geo, subs, lens, "cpu")
