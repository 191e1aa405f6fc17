"""The blocked walk's plain version and the row-length SpMV against the JAX
package: ``blocked_walk_ref`` (the CPU side of the one-launch blocked solve)
against the JAX blocked executor ``repro.core.packed.make_packed_blocked_solver``
on the same layout and values, before and after a value re-pack; the walk's
segment table; and the SpMV's plain version against the JAX SpMV kernel (TPU
lowering under ``interpret``) on a rewritten E, NaN rows for a non-finite
``v[0]`` included, with the row-length checks the kernel relies on."""
import re
from pathlib import Path

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import repro.core.codegen as j_codegen
import repro.core.coarsen as j_coarsen
import repro.core.levels as j_levels
import repro.core.packed as j_packed
import repro.core.rewrite as j_rewrite
import repro.sparse as jsparse
from repro.compat import enable_x64
from repro.kernels.spmv_ell import lowering_tpu as j_spmv_tpu

import repro_torch.core.codegen as t_codegen
import repro_torch.core.coarsen as t_coarsen
import repro_torch.core.levels as t_levels
import repro_torch.core.packed as t_packed
import repro_torch.core.rewrite as t_rewrite
from repro_torch.kernels.spmv_ell.ops import device_cols, device_row_len
from repro_torch.kernels.spmv_ell.ref import spmv_ref
from repro_torch.kernels.trsm_block import cuda as trsm_cuda
from repro_torch.kernels.trsm_block.ops import blocked_walk, make_walk_table
from repro_torch.kernels.trsm_block.ref import blocked_walk_ref

from _torch_parity import carry, to_port

# the walk's layouts: a dense band (B = 1, T = 64, K = 24), lung2's
# single-row supernodes (B > 1, T = 1) and a random factor (mixed T, pads)
WALK_MATRICES = {
    "band600": ("banded_lower", dict(n=600, bandwidth=24, fill=1.0, seed=3)),
    "lung2": ("lung2_like", dict(scale=0.02, fat_levels=4)),
    "random": ("random_lower", dict(n=200, seed=3)),
}
# the blocked path's tolerances (f64 1e-12, f32 1e-5): the two executors
# sum in another order
WALK_TOL = {np.float64: dict(rtol=1e-12, atol=1e-12),
            np.float32: dict(rtol=1e-5, atol=1e-5)}


def _matrix(name, dtype):
    gen, kw = WALK_MATRICES[name]
    return getattr(jsparse, gen)(dtype=dtype, **kw)


def _layouts(L, transpose):
    """(JAX layout, port layout) of one direction of ``L``."""
    Lj = L.transpose() if transpose else L
    Lt = to_port(Lj)
    jsn = j_levels.detect_supernodes(Lj, upper=transpose)
    tsn = t_levels.detect_supernodes(
        Lt, upper=transpose, config=carry(jsn.config, t_levels.SupernodeConfig))
    return (j_packed.build_packed_blocked_layout(
                j_coarsen.build_block_schedule(Lj, jsn, upper=transpose)),
            t_packed.build_packed_blocked_layout(
                t_coarsen.build_block_schedule(Lt, tsn, upper=transpose)))


def _port_walk(lay, data, b, dtype):
    """The port's solve of ``b`` through ``blocked_walk_ref`` (as
    ``make_packed_blocked_solver`` calls it on the CPU)."""
    vals, dinv = t_packed.pack_blocked_values(lay, data)
    table = make_walk_table(t_packed.walk_geometry(lay),
                            [s.lane_idx for s in lay.segments], "cpu")
    bt = torch.from_numpy(b)
    bhat = bt[torch.from_numpy(lay.perm)]
    x = torch.zeros_like(bhat)
    blocked_walk_ref(x, bhat, torch.from_numpy(lay.cols_flat.astype(np.int64)),
                     torch.from_numpy(vals).to(bt.dtype),
                     torch.from_numpy(dinv).to(bt.dtype), table)
    return x[torch.from_numpy(lay.pos)].numpy()


def _jax_solver(lay, dtype):
    """The JAX blocked executor's solve, jitted as ``repro.core.SpTRSV``
    runs it (the values are runtime arguments, so a re-pack reuses it)."""
    solve = jax.jit(j_packed.make_packed_blocked_solver(lay))

    def run(data, b):
        with enable_x64(dtype == np.float64):
            return np.asarray(solve(jnp.asarray(b),
                                    j_packed.pack_blocked_values(lay, data)))
    return run


@pytest.mark.parametrize("transpose", [False, True], ids=["forward", "transpose"])
@pytest.mark.parametrize("m", [1, 3])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name", sorted(WALK_MATRICES))
def test_walk_plain_matches_jax_blocked_executor(name, dtype, m, transpose):
    L = _matrix(name, dtype)
    jlay, tlay = _layouts(L, transpose)
    rng = np.random.default_rng(7)
    b = rng.standard_normal((L.n,) if m == 1 else (L.n, m)).astype(dtype)
    # the layout's target is the factor itself (forward) or its transpose,
    # whose data follow the transposed pattern
    target = L.transpose() if transpose else L
    jax_solve = _jax_solver(jlay, dtype)
    got = _port_walk(tlay, target.data, b, dtype)
    np.testing.assert_allclose(got, jax_solve(target.data, b), **WALK_TOL[dtype])
    dense = target.to_dense().astype(np.float64)
    np.testing.assert_allclose(got, np.linalg.solve(dense, b.astype(np.float64)),
                               rtol=1e-4 if dtype == np.float32 else 1e-10,
                               atol=1e-4 if dtype == np.float32 else 1e-10)
    # new values of the same pattern: both re-pack and solve again
    new = (target.data * (1.0 + 0.1 * rng.standard_normal(target.nnz))).astype(dtype)
    np.testing.assert_allclose(_port_walk(tlay, new, b, dtype),
                               jax_solve(new, b), **WALK_TOL[dtype])


@pytest.mark.parametrize("name", sorted(WALK_MATRICES))
def test_walk_geometry_matches_layout(name):
    _, lay = _layouts(_matrix(name, np.float64), False)
    geo = t_packed.walk_geometry(lay)
    table = make_walk_table(geo, [s.lane_idx for s in lay.segments], "cpu")
    assert geo.dtype == np.int64 and geo.shape == (len(lay.segments), 8)
    lane_row = table.lane_row.numpy()
    for (off, R, B, T, K, voff, doff, loff), seg in zip(geo.tolist(), lay.segments):
        assert (off, R, B, T, K, voff, doff) == (seg.off, seg.R, seg.B, seg.T,
                                                 seg.K, seg.val_off, seg.dinv_off)
        lanes = lane_row[loff: loff + B * T]
        np.testing.assert_array_equal(np.nonzero(lanes >= 0)[0], seg.lane_idx)
        np.testing.assert_array_equal(lanes[seg.lane_idx], np.arange(R))
        np.testing.assert_array_equal(table.row_lane[off: off + R].numpy(),
                                      seg.lane_idx)
    assert table.need == {"x": lay.n, "vals": lay.vals_flat.size,
                          "dinv": lay.dinv_flat.size}


def test_walk_table_checks():
    _, lay = _layouts(_matrix("random", np.float64), False)
    geo = t_packed.walk_geometry(lay)
    lanes = [s.lane_idx for s in lay.segments]
    bad = geo.copy()
    bad[1, 0] += 1
    with pytest.raises(ValueError, match="tile"):
        make_walk_table(bad, lanes, "cpu")
    wide = [lanes[0] + geo[0, 2] * geo[0, 3]] + lanes[1:]
    with pytest.raises(ValueError, match="lanes outside"):
        make_walk_table(geo, wide, "cpu")
    table = make_walk_table(geo, lanes, "cpu")
    x = torch.zeros(lay.n, dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA"):
        trsm_cuda.blocked_walk(x, x, torch.zeros(1, dtype=torch.int32), x, x, table)
    with pytest.raises(ValueError, match="device"):
        blocked_walk(x.to("meta"), x.to("meta"), x, x, x, table)


def test_blocked_solver_runs_the_walk_once_per_solve(monkeypatch):
    """The solver's solve is one walk call on the whole layout (the CPU
    dispatch target), with the value buffers passed by reference."""
    from repro_torch.core import SpTRSV
    from repro_torch.kernels.trsm_block import ops as trsm_ops

    calls = []
    real = trsm_ops.blocked_walk_ref

    def counted(x, bhat, cols, vals, dinv, table):
        calls.append((vals.data_ptr(), dinv.data_ptr(), table.num_segments))
        return real(x, bhat, cols, vals, dinv, table)

    monkeypatch.setattr(trsm_ops, "blocked_walk_ref", counted)
    L = to_port(_matrix("band600", np.float64))
    s = SpTRSV.build(L, strategy="blocked", device="cpu")
    b = np.random.default_rng(1).standard_normal((L.n, 2))
    x = s.solve(torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(x, np.linalg.solve(L.to_dense(), b), rtol=1e-12,
                               atol=1e-12)
    assert calls == [(s._values[0].data_ptr(), s._values[1].data_ptr(),
                      s.block_schedule.num_segments)]


# --------------------------------------------------------------------------
# the SpMV's plain version on a rewritten E, and its row lengths
# --------------------------------------------------------------------------
def _rewritten_e(dtype):
    L = jsparse.lung2_like(scale=0.02, fat_levels=4, dtype=dtype)
    E = j_rewrite.rewrite_matrix(L, j_levels.build_level_sets(L),
                                 j_rewrite.RewriteConfig()).E
    assert E.nnz > E.n          # the rewrite eliminated something
    return E


@pytest.mark.parametrize("v0", ["finite", "inf"])
def test_spmv_plain_matches_tpu_kernel_on_rewritten_e(v0):
    E = _rewritten_e(np.float32)
    ell = j_codegen.build_ell(E)
    block = 128
    n_pad = -(-E.n // block) * block
    cols = np.zeros((ell.K, n_pad), np.int32)
    vals = np.zeros((ell.K, n_pad), np.float32)
    cols[:, :E.n], vals[:, :E.n] = ell.cols, ell.vals
    v = np.random.default_rng(2).standard_normal(n_pad).astype(np.float32)
    if v0 == "inf":
        v[0] = np.inf
    want = np.asarray(j_spmv_tpu.spmv(jnp.asarray(v), jnp.asarray(cols),
                                      jnp.asarray(vals), block=block,
                                      interpret=True))[:E.n]
    got = spmv_ref(torch.from_numpy(v), torch.from_numpy(cols.astype(np.int64)),
                   torch.from_numpy(vals)).numpy()[:E.n]
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=2e-5, atol=2e-6)
    if v0 == "inf":
        # a row with a pad or a column-0 entry gathers v[0]: 0 * inf is NaN
        # in a pad, inf times a nonzero in a real entry
        touches = (ell.cols == 0).any(0)
        assert np.isnan(got).sum() + np.isinf(got).sum() == touches.sum()
        assert np.isnan(got).sum() > 0


def test_spmv_row_lengths_of_rewritten_e():
    E = to_port(_rewritten_e(np.float64))
    tell = t_codegen.build_ell(E)
    row_nnz = E.row_nnz()
    assert device_row_len(row_nnz, tell.cols, torch.device("cpu")) is None
    # the slots past each row's length are the ELL pads the kernel skips
    K = tell.cols.shape[0]
    past = np.arange(K)[:, None] >= row_nnz[None, :]
    assert (tell.cols[past] == 0).all() and (tell.vals[past] == 0).all()
    assert (row_nnz < K).sum() > 0.9 * E.n
    with pytest.raises(ValueError, match="outside"):
        device_row_len(row_nnz + K, tell.cols, torch.device("cpu"))
    short = row_nnz.copy()
    short[np.argmax(row_nnz > 1)] -= 1
    with pytest.raises(ValueError, match="not a pad"):
        device_row_len(short, tell.cols, torch.device("cpu"))
    # the RHS transform's plain version equals E b, pads included
    res = t_rewrite.rewrite_matrix(E.__class__.from_numpy(
        *[getattr(to_port(_matrix("lung2", np.float64)), k)
          for k in ("indptr", "indices", "data", "shape")]),
        config=t_rewrite.RewriteConfig())
    transform, e_vals, _ = t_packed.make_packed_rhs_transform(res, device="cpu")
    b = np.random.default_rng(3).standard_normal(res.E.n)
    np.testing.assert_allclose(transform(torch.from_numpy(b), e_vals).numpy(),
                               res.E.to_dense() @ b, rtol=1e-12, atol=1e-12)
    cols = device_cols(t_codegen.build_ell(res.E).cols, res.E.n, torch.device("cpu"))
    assert cols.dtype == torch.int64


# A twin of the walk's shared-memory sizing (plan() in trsm_block.cu), held
# against the source: its constants are read from it, and its formulas must
# stand there as written here.
_WALK_CU = (Path(__file__).resolve().parents[1]
            / "src/repro_torch/kernels/csrc/trsm_block.cu").read_text()
_WALK_FORMULAS = (
    "return (T * sz) % 16 == 0 ? T + 16 / sz : T | 1;",
    "return T * (dinv_ld(static_cast<int>(T), sz) * sz + K * (4 + sz) + 4 + mc * sz);",
    "return 3 * K * (4 + sz) + 96;",
    "*ks = *per + *fixed <= pcap ? K : 0;",
    "*per -= T * K * (4 + sz);",
    "*fixed = stage_fixed(0, sz);",
    "const long long rhs = rup((nt > Tmax * mc ? nt : Tmax * mc) * sz, 16);",
    "const long long avail = kMaxSmem - rhs;",
    "const long long pcap = avail;",
    "stage_size(T_, K, mc, sz, pcap, &per, &fixed, &Ks);",
    "if (per + fixed > need1) need1 = per + fixed;",
)


def _walk_const(name):
    return int(re.search(rf"constexpr (?:int|long long) {name} = (-?\d+);",
                         _WALK_CU).group(1))


def _stage_per(T, K, mc, sz):
    ld = T + 16 // sz if (T * sz) % 16 == 0 else T | 1
    return T * (ld * sz + K * (4 + sz) + 4 + mc * sz)


def _stage_fixed(K, sz):
    return 3 * K * (4 + sz) + 96


def _walk_sizing(geo, m, sz, *, stage_panels=None):
    """``(need1, avail, global_panels)`` of plan(): the bytes of the largest
    one-block stage, the shared memory beside the rhs buffer, and the
    segments whose panel stays in device memory.  ``stage_panels=True``
    sizes every panel staged, as the walk did before wide panels."""
    cols, threads = _walk_const("kCols"), _walk_const("kMaxThreads")
    mc = min(m, cols)
    nt = threads if mc >= 4 else threads // 2
    rhs = -(-max(nt, int(geo[:, 3].max()) * mc) * sz // 16) * 16
    avail = _walk_const("kMaxSmem") - rhs
    need1, glob = 16, 0
    for T, K in geo[:, 3:5].tolist():
        staged = stage_panels or (_stage_per(T, K, mc, sz)
                                  + _stage_fixed(K, sz) <= avail)
        Ks = K if staged else 0
        glob += Ks < K
        need1 = max(need1, _stage_per(T, Ks, mc, sz) + _stage_fixed(Ks, sz))
    return -(-need1 // 16) * 16, avail, glob


def test_walk_sizing_twin_matches_the_source():
    for line in _WALK_FORMULAS:
        assert line in _WALK_CU, line
    assert _walk_const("kMaxSmem") == trsm_cuda.MAX_SMEM_BYTES
    assert (_walk_const("kCols"), _walk_const("kMaxThreads"),
            _walk_const("kTooBig")) == (8, 512, -2)


@pytest.mark.parametrize("m", [1, 32])
@pytest.mark.parametrize("sz", [4, 8])
def test_walk_stage_does_not_grow_with_k(sz, m):
    """A 64-row block's largest stage stops growing once its panel is too
    wide to stage: any K fits, where staging every panel would not."""
    need = {}
    for K in (24, 120, 250, 300, 400, 2_000, 100_000):
        geo = np.array([[0, 64, 1, 64, K, 0, 0, 0]], dtype=np.int64)
        need[K], avail, glob = _walk_sizing(geo, m, sz)
        assert need[K] <= avail
        assert glob == (need[K] < _stage_per(64, K, min(m, 8), sz))
    assert need[24] < need[120] and need[400] == need[2_000] == need[100_000]
    geo = np.array([[0, 64, 1, 64, 400, 0, 0, 0]], dtype=np.int64)
    assert _walk_sizing(geo, m, sz, stage_panels=True)[0] > avail


@pytest.mark.parametrize("bandwidth,sizes", [(24, ()), (250, (8,)), (300, (8,)),
                                             (400, (4, 8))])
def test_wide_band_layouts_fit_the_walk(bandwidth, sizes):
    """The bands of ROADMAP C1: a band whose full panel stage the walk
    refused (``sizes``: f32 4, f64 8) reads those panels from device memory
    and fits; a narrow band stages every panel, as before."""
    L = to_port(jsparse.banded_lower(2048, bandwidth=bandwidth, fill=1.0))
    sn = t_levels.detect_supernodes(L)
    lay = t_packed.build_packed_blocked_layout(t_coarsen.build_block_schedule(L, sn))
    geo = t_packed.walk_geometry(lay)
    for sz in (4, 8):
        for m in (1, 32):
            need1, avail, glob = _walk_sizing(geo, m, sz)
            assert need1 <= avail
            refused = _walk_sizing(geo, m, sz, stage_panels=True)[0] > avail
            assert refused == (sz in sizes) == (glob > 0), (sz, m)
