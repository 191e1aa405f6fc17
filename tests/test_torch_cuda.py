"""The CUDA kernels on the card: each held against its plain torch version
on the same CUDA tensors; the solver's kernel strategies, with and without
equation rewriting, against the plain ``levelset`` executor; the scatter
layout's level step and its blocked solve's block applies on a path; the
blocked solve against a dense solve; the flash kernel's score softcap,
its query groups of 5 and 7 (llama4-scout, arctic), its prefix-LM mask
(paligemma) and whisper's full and cross-attention shapes; each LM
family's prefill and decode on the card against the same model on the
CPU; and the
MoE layer, locally and expert parallel on one NCCL rank, against its CPU
run.  Marked ``cuda``: they skip where no GPU is
visible, and run on a machine with one via

    PYTHONPATH=src python -m pytest -q -m cuda --noconftest tests/test_torch_cuda.py

This file imports only the port, and ``--noconftest`` skips the suite's
JAX set-up: the GPU machine has no JAX."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import RewriteConfig, SpTRSV
from repro_torch.core.coarsen import build_block_schedule, coarsen_schedule
from repro_torch.core.codegen import build_ell, build_schedule
from repro_torch.core.levels import (SupernodeConfig, build_level_sets,
                                     build_reverse_level_sets, detect_supernodes)
from repro_torch.core.csr import CSRMatrix
from repro_torch.core.packed import (build_packed_blocked_layout, level_table,
                                     pack_blocked_values, walk_geometry)
from repro_torch.core.rewrite import rewrite_matrix
from repro_torch.kernels.flash_attn import cuda as flash_cuda
from repro_torch.kernels.flash_attn.ref import attention_ref, gqa_attention_ref
from repro_torch.kernels.spmv_ell import cuda as spmv_cuda
from repro_torch.kernels.spmv_ell.ops import device_cols, device_row_len
from repro_torch.kernels.spmv_ell.ref import spmv_ref
from repro_torch.kernels.sptrsv_fused import cuda as fused_cuda
from repro_torch.kernels.sptrsv_fused.ops import build_layout
from repro_torch.kernels.sptrsv_fused.ref import fused_solve_ref
from repro_torch.kernels.sptrsv_fused.table import fused_table
from repro_torch.kernels.sptrsv_level import cuda as level_cuda
from repro_torch.kernels.sptrsv_level.ops import make_packed_solver
from repro_torch.kernels.sptrsv_level.ref import level_walk_ref
from repro_torch.kernels.sptrsv_level.table import WIDE_K
from repro_torch.kernels.trsm_block import cuda as trsm_cuda
from repro_torch.kernels.trsm_block.ops import make_walk_table
from repro_torch.kernels.trsm_block.ref import block_apply_ref, blocked_walk_ref
from repro_torch.configs import smoke_config
from repro_torch.models.model import Model
from repro_torch.sparse import (banded_lower, chain_matrix, lung2_like,
                                random_lower, refresh_values)

# |kernel - plain| / max |plain|: nvcc contracts to FMA, bits may differ
KERNEL_TOL = {torch.float32: 1e-5, torch.float64: 1e-12}
# flash attention, max |kernel - plain| / max |plain|: both sum in f32 in
# another order; bf16 outputs may then round one bf16 step apart (the JAX
# package's tests/test_flash_kernel.py uses 2e-2 for bf16)
FLASH_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def check_waits(monkeypatch):
    """The fused walk reads its error word back after every launch here: a
    wait that runs out raises."""
    monkeypatch.setattr(fused_cuda, "check_waits", True)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _schedule(coarsen):
    L = lung2_like(scale=0.02, fat_levels=4)
    s = build_schedule(L, build_level_sets(L))
    return coarsen_schedule(s) if coarsen else s


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("m", [1, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_level_kernel_matches_plain(card, dtype, m):
    _, vals, _, lay = make_packed_solver(_schedule(True), device=card)
    table = level_table(lay, card)
    cols = torch.from_numpy(lay.cols_flat).to(card)
    g = torch.Generator().manual_seed(0)
    shape = (lay.n_pad + 128,) + (() if m == 1 else (m,))
    x0 = torch.randn(shape, generator=g, dtype=dtype).to(card)
    bhat = torch.randn(shape, generator=g, dtype=dtype).to(card)
    vf, df = vals[0].to(dtype), vals[1].to(dtype)
    key = "sptrsv_level" if m == 1 else "sptrsv_level_batched"
    before = level_cuda.launches[key]
    xk, xr = x0.clone(), x0.clone()
    level_cuda.level_walk(xk, bhat, cols, vf, df, table)
    level_walk_ref(xr, bhat, cols, vf, df, table)
    torch.cuda.synchronize()
    assert level_cuda.launches[key] - before == len(lay.segments)
    assert _rel(xk, xr) <= KERNEL_TOL[dtype]


def _arrow(n=3000, wide=1500, seed=0):
    """A random lower factor (up to 3 entries left of the diagonal) whose
    last row has ``wide`` entries left of it."""
    rng = np.random.default_rng(seed)
    rows = [np.unique(rng.integers(0, i, size=min(i, 3))) if i else
            np.zeros(0, np.int64) for i in range(n - 1)]
    rows.append(np.sort(rng.choice(n - 1, size=wide, replace=False)))
    indptr = np.concatenate([[0], np.cumsum([len(r) + 1 for r in rows])])
    indices = np.concatenate([np.append(r, i) for i, r in enumerate(rows)])
    data = rng.uniform(-1, 1, indices.size) / 8
    data[indptr[1:] - 1] = 2.0 + rng.random(n)
    return CSRMatrix.from_numpy(indptr, indices, data, (n, n))


def _level_layout(name):
    """lung2 (scale 0.05) coarsened, forward (chains of K = 2) or transpose
    (wide plain steps, chains of K up to 106: warp chains), and a factor
    with a row of 1,500 entries, coarsened."""
    L = _arrow() if name == "arrow" else lung2_like(scale=0.05, seed=0)
    if name == "lung2T":
        s = build_schedule(L.transpose(), build_reverse_level_sets(L), upper=True)
    else:
        s = build_schedule(L, build_level_sets(L))
    return make_packed_solver(coarsen_schedule(s), device="cpu")[3]


@pytest.mark.parametrize("m", [1, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", ["lung2", "lung2T", "arrow"])
def test_level_chain_and_wide_kernels_match_plain(card, name, dtype, m):
    """Every launch variant (a thread or a warp per row, one launch per
    segment or one block per chain) against the plain walk, one launch per
    segment."""
    lay = _level_layout(name)
    table = level_table(lay, card)
    kinds = table.kinds()
    assert kinds["chain"] + kinds["chain_warp"] > 0
    if name != "lung2":
        assert kinds["segment_warp"] + kinds["chain_warp"] > 0
        assert int(table.host[:, 1].max()) > (1000 if name == "arrow" else WIDE_K)
    cols = torch.from_numpy(lay.cols_flat).to(card)
    vf = torch.from_numpy(lay.vals_flat).to(card, dtype)
    df = torch.from_numpy(lay.diag_flat).to(card, dtype)
    g = torch.Generator().manual_seed(m)
    shape = (-(-lay.n_pad // 128) * 128,) + (() if m == 1 else (m,))
    x0 = torch.randn(shape, generator=g, dtype=dtype).to(card)
    bhat = torch.randn(shape, generator=g, dtype=dtype).to(card)
    key = "sptrsv_level" if m == 1 else "sptrsv_level_batched"
    before, kinds0 = level_cuda.launches[key], dict(level_cuda.launch_kinds)
    xk, xr = x0.clone(), x0.clone()
    level_cuda.level_walk(xk, bhat, cols, vf, df, table)
    level_walk_ref(xr, bhat, cols.long(), vf, df, table)
    torch.cuda.synchronize()
    assert level_cuda.launches[key] - before == table.num_segments
    assert {k: level_cuda.launch_kinds[k] - kinds0[k] for k in kinds} == kinds
    assert torch.isfinite(xk).all()
    assert _rel(xk, xr) <= KERNEL_TOL[dtype]


@pytest.mark.parametrize("kw", [dict(strategy="pallas_level"),
                                dict(strategy="pallas_level", coarsen=True)],
                         ids=["level", "level+coarsen"])
def test_level_solver_launches_one_kernel_per_segment(card, kw):
    L = lung2_like(scale=0.05, seed=0)
    b = torch.from_numpy(np.random.default_rng(8).standard_normal((L.n, 32))).to(card)
    for s, ref in zip(SpTRSV.build_pair(L, device=card, **kw),
                      SpTRSV.build_pair(L, device=card, strategy="levelset")):
        for rhs in (b[:, 0].contiguous(), b):
            level_cuda.reset_launches()
            x = s.solve(rhs)
            torch.cuda.synchronize()
            key = "sptrsv_level" if rhs.dim() == 1 else "sptrsv_level_batched"
            assert level_cuda.launches[key] == s.stats()["segments"]
            assert _rel(x, ref.solve(rhs)) <= 1e-12


def _fused_layout(name):
    """lung2 forward (scale 0.02), a lung2 transpose whose rows reach 106
    slots (56 rows wider than 32), and a 1,000-row chain (one row per
    span: 999 dependent hops)."""
    if name == "lung2":
        return build_layout(_schedule(False))
    if name == "lung2T":
        L = lung2_like(scale=0.05, seed=0)
        return build_layout(build_schedule(L.transpose(), build_reverse_level_sets(L),
                                           upper=True))
    L = chain_matrix(1000)
    return build_layout(build_schedule(L, build_level_sets(L)))


def _fused_args(lay, card, dtype):
    return (torch.from_numpy(lay.cols).to(card),
            torch.from_numpy(lay.vals).to(card, dtype),
            torch.from_numpy(lay.diag).to(card, dtype))


@pytest.mark.parametrize("m", [1, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", ["lung2", "lung2T", "chain"])
def test_fused_kernel_matches_plain(card, name, dtype, m):
    """One launch per call: the single-RHS walk (m = 1) or the batched
    grid (m = 32) against the plain chunk walk."""
    lay = _fused_layout(name)
    cols, vals, diag = _fused_args(lay, card, dtype)
    spans = torch.tensor(lay.spans, dtype=torch.int32, device=card)
    table = fused_table(lay, card)
    if name == "lung2T":
        assert int(table.row_len.max()) > WIDE_K
    g = torch.Generator().manual_seed(1)
    bl = torch.randn((lay.n_pad,) + (() if m == 1 else (m,)), generator=g,
                     dtype=dtype).to(card)
    key = "sptrsv_fused" if m == 1 else "sptrsv_fused_batched"
    before = fused_cuda.launches[key]
    xk = fused_cuda.fused_solve(bl, cols, vals, diag, spans, table)
    xr = fused_solve_ref(bl, cols, vals, diag, chunk=lay.chunk)
    torch.cuda.synchronize()
    assert fused_cuda.launches[key] == before + 1
    assert torch.isfinite(xk).all()
    assert _rel(xk, xr) <= KERNEL_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", ["lung2", "lung2T"])
def test_fused_walk_nonfinite_like_plain(card, name, dtype):
    """inf and NaN at the positions the pad columns read: the walk's NaN
    and inf where the plain chunk walk has them, the rest close."""
    lay = _fused_layout(name)
    cols, vals, diag = _fused_args(lay, card, dtype)
    table = fused_table(lay, card)
    pc = table.pad_cols[table.pad_cols >= 0].unique().long()
    g = torch.Generator().manual_seed(2)
    for bad in (float("inf"), float("nan")):
        bl = torch.randn(lay.n_pad, generator=g, dtype=dtype).to(card)
        bl[pc] = bad
        xk = fused_cuda.fused_solve(bl, cols, vals, diag, table=table)
        xr = fused_solve_ref(bl, cols, vals, diag, chunk=lay.chunk)
        torch.cuda.synchronize()
        assert torch.isnan(xr).any()
        assert torch.equal(torch.isnan(xk), torch.isnan(xr))
        assert torch.equal(torch.isinf(xk), torch.isinf(xr))
        fin = torch.isfinite(xr)
        assert _rel(xk[fin], xr[fin]) <= KERNEL_TOL[dtype]


def test_fused_walk_twice_in_a_row(card):
    """Two solves with different right-hand sides: nothing of the first
    (x̂, ticket) leaks into the second."""
    lay = _fused_layout("lung2T")
    cols, vals, diag = _fused_args(lay, card, torch.float64)
    table = fused_table(lay, card)
    g = torch.Generator().manual_seed(3)
    b1, b2 = (torch.randn(lay.n_pad, generator=g, dtype=torch.float64).to(card)
              for _ in range(2))
    x1 = fused_cuda.fused_solve(b1, cols, vals, diag, table=table)
    x2 = fused_cuda.fused_solve(b2, cols, vals, diag, table=table)
    torch.cuda.synchronize()
    assert _rel(x1, fused_solve_ref(b1, cols, vals, diag, chunk=lay.chunk)) <= 1e-12
    assert _rel(x2, fused_solve_ref(b2, cols, vals, diag, chunk=lay.chunk)) <= 1e-12


def test_fused_walk_broken_table_raises(card, monkeypatch):
    """A row that waits on its own position (which only it writes) gives up
    after the spin limit: under ``check_waits`` RuntimeError and no launch
    counted; without the check the launch returns, its row NaN and the
    real rows before it right.  Then a solve on the sound table is right."""
    lay = _fused_layout("lung2")
    cols, vals, diag = _fused_args(lay, card, torch.float64)
    table = fused_table(lay, card)
    p = int(table.host_groups[table.num_real // 2, 0])
    pc = table.pad_cols.clone()
    pc[:, p] = torch.tensor([p, -1], dtype=torch.int32)
    broken = dataclasses.replace(table, pad_cols=pc)
    bl = torch.ones(lay.n_pad, dtype=torch.float64, device=card)
    before = fused_cuda.launches["sptrsv_fused"]
    with pytest.raises(RuntimeError, match="ran out"):
        fused_cuda.fused_solve(bl, cols, vals, diag, table=broken)
    assert fused_cuda.launches["sptrsv_fused"] == before
    monkeypatch.setattr(fused_cuda, "check_waits", False)
    x = fused_cuda.fused_solve(bl, cols, vals, diag, table=broken)
    torch.cuda.synchronize()
    real = torch.from_numpy(lay.perm_rows[:p] < lay.n).to(card)
    assert torch.isnan(x[p]) and torch.isfinite(x[:p][real]).all()
    x = fused_cuda.fused_solve(bl, cols, vals, diag, table=table)
    assert _rel(x, fused_solve_ref(bl, cols, vals, diag, chunk=lay.chunk)) <= 1e-12


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_fused_solver_pair_after_refresh(card, dtype):
    """``build_pair(..., strategy="pallas_fused")`` at m = 1, forward and
    transpose: one walk launch per solve, against ``levelset`` before and
    after a refresh (the table stays, the values change)."""
    L = lung2_like(scale=0.05, seed=0)
    if dtype == torch.float32:
        L = L.astype(np.float32)
    new = refresh_values(L, seed=6)
    b = torch.from_numpy(np.random.default_rng(4).standard_normal(L.n)).to(card, dtype)
    pairs = (SpTRSV.build_pair(L, device=card, strategy="pallas_fused"),
             SpTRSV.build_pair(L, device=card, strategy="levelset"))
    for s, ref in zip(*pairs):
        for values in (None, new):
            if values is not None:
                table = s._solve_fn.table
                s.refresh(values)
                ref.refresh(values)
                assert s._solve_fn.table is table
            fused_cuda.reset_launches()
            x = s.solve(b)
            torch.cuda.synchronize()
            assert fused_cuda.launches == {"sptrsv_fused": 1, "sptrsv_fused_batched": 0}
            assert _rel(x, ref.solve(b)) <= KERNEL_TOL[dtype]


@pytest.mark.parametrize("kw", [dict(strategy="pallas_level"),
                                dict(strategy="pallas_level", coarsen=True),
                                dict(strategy="pallas_fused")],
                         ids=["level", "level+coarsen", "fused"])
def test_solver_on_card_matches_levelset(card, kw):
    L = lung2_like(scale=0.02, fat_levels=4)
    B = torch.from_numpy(np.random.default_rng(2).standard_normal((L.n, 4))).to(card)
    for s, ref in zip(SpTRSV.build_pair(L, device=card, **kw),
                      SpTRSV.build_pair(L, device=card, strategy="levelset")):
        for rhs in (B[:, 0].contiguous(), B):
            assert _rel(s.solve(rhs), ref.solve(rhs)) <= 1e-12


@pytest.mark.parametrize("m", [1, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_spmv_kernel_matches_plain(card, dtype, m):
    L = lung2_like(scale=0.02, fat_levels=4)
    ell = build_ell(rewrite_matrix(L, config=RewriteConfig()).E)
    cols = device_cols(ell.cols, L.n, card)
    vals = torch.from_numpy(ell.vals).to(card, dtype)
    g = torch.Generator().manual_seed(3)
    v = torch.randn((L.n,) + (() if m == 1 else (m,)), generator=g,
                    dtype=dtype).to(card)
    key = "spmv_ell" if m == 1 else "spmv_ell_batched"
    before = spmv_cuda.launches[key]
    yk = spmv_cuda.spmv(v, cols, vals)
    yr = spmv_ref(v, cols.long(), vals)
    torch.cuda.synchronize()
    assert spmv_cuda.launches[key] == before + 1
    assert _rel(yk, yr) <= KERNEL_TOL[dtype]


@pytest.mark.parametrize("m", [1, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_block_apply_kernel_matches_plain(card, dtype, m):
    g = torch.Generator().manual_seed(4)
    dinv = torch.randn((512, 64, 64), generator=g, dtype=dtype).to(card)
    rhs = torch.randn((512, 64) + (() if m == 1 else (m,)), generator=g,
                      dtype=dtype).to(card)
    key = "trsm_block_apply" if m == 1 else "trsm_block_apply_batched"
    before = trsm_cuda.launches[key]
    out = trsm_cuda.block_apply(dinv, rhs)
    ref = block_apply_ref(dinv, rhs)
    torch.cuda.synchronize()
    assert trsm_cuda.launches[key] == before + 1
    assert _rel(out, ref) <= KERNEL_TOL[dtype]


@pytest.mark.parametrize("kw", [dict(strategy="levelset"),
                                dict(strategy="pallas_level"),
                                dict(strategy="pallas_level", coarsen=True),
                                dict(strategy="pallas_fused")],
                         ids=["levelset", "level", "level+coarsen", "fused"])
def test_rewritten_solver_on_card_matches_levelset(card, kw):
    L = lung2_like(scale=0.02, fat_levels=4)
    B = torch.from_numpy(np.random.default_rng(5).standard_normal((L.n, 4))).to(card)
    for s, ref in zip(SpTRSV.build_pair(L, device=card, rewrite=RewriteConfig(), **kw),
                      SpTRSV.build_pair(L, device=card, strategy="levelset")):
        for rhs in (B[:, 0].contiguous(), B):
            assert _rel(s.solve(rhs), ref.solve(rhs)) <= 1e-12


def test_blocked_solver_on_card_matches_dense(card):
    L = banded_lower(300, bandwidth=8, fill=1.0)
    dense = L.to_dense()
    b = np.random.default_rng(6).standard_normal((L.n, 4))
    for s, A in zip(SpTRSV.build_pair(L, device=card, strategy="blocked"),
                    (dense, dense.T)):
        for rhs in (b[:, 0].copy(), b):
            x = s.solve(torch.from_numpy(rhs).to(card)).cpu().numpy()
            np.testing.assert_allclose(x, np.linalg.solve(A, rhs),
                                       rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("m", [1, 32])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_blocked_wide_band_matches_scipy(card, dtype, m):
    """A band whose panels (K = 300) do not fit a stage in f64: one walk
    launch per solve, panels read from device memory, against scipy's f64
    triangular solve (1e-12 f64, 1e-4 f32)."""
    import scipy.sparse as sp
    from scipy.sparse.linalg import spsolve_triangular

    L = banded_lower(8192, bandwidth=300, fill=1.0, seed=0)
    A = sp.csr_matrix((L.data, L.indices, L.indptr), shape=L.shape)
    b = np.random.default_rng(9).standard_normal((L.n, m)).astype(dtype)
    rhs = torch.from_numpy(b[:, 0].copy() if m == 1 else b).to(card)
    for s in SpTRSV.build_pair(L.astype(dtype), device=card, strategy="blocked"):
        trsm_cuda.reset_launches()
        x = s.solve(rhs)
        torch.cuda.synchronize()
        key = "trsm_block_walk" if m == 1 else "trsm_block_walk_batched"
        assert trsm_cuda.launches == {**{k: 0 for k in trsm_cuda.launches}, key: 1}
        want = spsolve_triangular(A.T.tocsr() if s.transpose else A,
                                  b.astype(np.float64), lower=not s.transpose)
        got = x.double().cpu().numpy().reshape(want.shape)
        err = float(np.abs(got - want).max() / np.abs(want).max())
        assert err <= (1e-12 if dtype == np.float64 else 1e-4), err


def test_blocked_solver_launches_the_walk_once(card):
    """One walk launch per blocked solve, and no SpMV or per-segment apply."""
    L = banded_lower(2000, bandwidth=24, fill=1.0, seed=1)
    b = torch.from_numpy(np.random.default_rng(7).standard_normal((L.n, 32))).to(card)
    for s in SpTRSV.build_pair(L, device=card, strategy="blocked"):
        for rhs in (b[:, 0].contiguous(), b, b[:, :3].contiguous()):
            trsm_cuda.reset_launches()
            spmv_cuda.reset_launches()
            s.solve(rhs)
            torch.cuda.synchronize()
            key = "trsm_block_walk" if rhs.dim() == 1 else "trsm_block_walk_batched"
            assert trsm_cuda.launches == {**{k: 0 for k in trsm_cuda.launches}, key: 1}
            assert set(spmv_cuda.launches.values()) == {0}


# the walk's layouts: a dense band (B = 1, T = 64: one block per column
# group), a band whose panels (K = 120) leave room for one f64 stage only,
# a band whose f64 panels (K = 300) are read from device memory, lung2 (B > 1, T = 1: the cooperative grid, forward K <= 4 and the
# transpose's wide panels), and mixed T (1 to 9, up to 298 blocks of T > 1)
# with pad lanes
def _walk_matrix(name):
    if name == "band":
        return banded_lower(6400, bandwidth=24, fill=1.0, seed=2), False, None
    if name == "wide":
        return banded_lower(1500, bandwidth=120, fill=1.0, seed=1), False, None
    if name == "wide300":
        return banded_lower(2000, bandwidth=300, fill=1.0, seed=1), False, None
    if name.startswith("lung2"):
        return lung2_like(scale=0.05, seed=0), name.endswith("T"), None
    return (random_lower(4000, seed=5), False,
            SupernodeConfig(relax=1.0, max_block=32))


def _walk_case(name, dev, dtype):
    L, upper, cfg = _walk_matrix(name)
    M = L.transpose() if upper else L
    sn = detect_supernodes(M, upper=upper, config=cfg or SupernodeConfig())
    lay = build_packed_blocked_layout(build_block_schedule(M, sn, upper=upper))
    vals, dinv = pack_blocked_values(lay, M.data)
    table = make_walk_table(walk_geometry(lay), [g.lane_idx for g in lay.segments], dev)
    return (lay, table, device_cols(lay.cols_flat, lay.n, dev),
            torch.from_numpy(vals).to(dev, dtype), torch.from_numpy(dinv).to(dev, dtype))


@pytest.mark.parametrize("m", [1, 7, 32, 33])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", ["band", "wide", "wide300", "lung2", "lung2T",
                                  "mixed"])
def test_walk_kernel_matches_plain(card, name, dtype, m):
    lay, table, cols, vals, dinv = _walk_case(name, card, dtype)
    g = torch.Generator().manual_seed(m)
    bhat = torch.randn((lay.n,) + (() if m == 1 else (m,)), generator=g,
                       dtype=dtype).to(card)
    key = "trsm_block_walk" if m == 1 else "trsm_block_walk_batched"
    cfg = trsm_cuda.walk_config(table, m, dtype)
    if name.startswith(("band", "wide")):   # B = 1: a block per column group
        assert not cfg["cooperative"] and cfg["grid"] == cfg["groups"]
    if name == "wide" and dtype == torch.float64:
        assert cfg["stages"] == 1
    # f64 panels of K = 300 stay in device memory; every other one is staged
    assert (cfg["global_panels"] > 0) == (name == "wide300" and dtype == torch.float64)
    if name.startswith("lung2") and m > 1:      # B > 32 blocks of T = 1
        assert cfg["cooperative"] and cfg["barriers"] > 0
    for _ in range(2):      # the second launch reuses the barrier's scratch
        xk, xr = torch.zeros_like(bhat), torch.zeros_like(bhat)
        before = trsm_cuda.launches[key]
        trsm_cuda.blocked_walk(xk, bhat, cols, vals, dinv, table)
        blocked_walk_ref(xr, bhat, cols.long(), vals, dinv, table)
        torch.cuda.synchronize()
        assert trsm_cuda.launches[key] == before + 1
        assert torch.isfinite(xk).all()
        assert _rel(xk, xr) <= KERNEL_TOL[dtype], (cfg, _rel(xk, xr))


@pytest.mark.parametrize("m", [1, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_spmv_row_lengths_match_plain(card, dtype, m):
    """The row-length SpMV on a rewritten E against its plain version (all
    K slots), also with v[0] = inf: the same NaN rows."""
    L = lung2_like(scale=0.05, seed=0)
    E = rewrite_matrix(L, config=RewriteConfig()).E
    ell = build_ell(E)
    cols = device_cols(ell.cols, E.n, card)
    row_len = device_row_len(E.row_nnz(), ell.cols, card)
    vals = torch.from_numpy(ell.vals).to(card, dtype)
    g = torch.Generator().manual_seed(11)
    v = torch.randn((E.n,) + (() if m == 1 else (m,)), generator=g,
                    dtype=dtype).to(card)
    for v0 in (None, float("inf")):
        if v0 is not None:
            v[0] = v0
        yk = spmv_cuda.spmv(v, cols, vals, row_len)
        yf = spmv_cuda.spmv(v, cols, vals)
        yr = spmv_ref(v, cols.long(), vals)
        torch.cuda.synchronize()
        for y in (yk, yf):
            assert torch.equal(torch.isnan(y), torch.isnan(yr))
            assert torch.equal(torch.isinf(y), torch.isinf(yr))
        ok = torch.isfinite(yr)
        assert torch.equal(yk[ok], yf[ok])
        assert _rel(yk[ok], yr[ok]) <= KERNEL_TOL[dtype]
    assert torch.isnan(yk).any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,Hq,Hkv,hd,causal,window", [
    (1, 512, 8, 2, 128, True, 0),      # granite-like GQA, 8 tiles
    (2, 200, 4, 4, 64, True, 128),     # ragged S, sliding window
    (1, 130, 2, 1, 256, True, 0),      # widest head dim, ragged
    (1, 96, 2, 2, 40, False, 0),       # no mask, odd head dim
], ids=["granite", "ragged-window", "hd256", "full-hd40"])
def test_flash_kernel_matches_plain(card, dtype, B, S, Hq, Hkv, hd, causal, window):
    g = torch.Generator().manual_seed(7)
    q, k, v = (torch.randn((B, S, H, hd), generator=g).to(card, dtype)
               for H in (Hq, Hkv, Hkv))
    before = flash_cuda.launches["flash_attn"]
    got = flash_cuda.flash_attn(q, k, v, causal=causal, window=window)
    want = gqa_attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_cuda.launches["flash_attn"] == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    assert _rel(got.float(), want.float()) <= FLASH_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_valid_len(card, dtype):
    g = torch.Generator().manual_seed(8)
    q, k, v = (torch.randn((3, 256, 1, 64), generator=g).to(card, dtype)
               for _ in range(3))
    got = flash_cuda.flash_attn(q, k, v, causal=True, valid_len=150)
    want = attention_ref(q[:, :, 0], k[:, :, 0], v[:, :, 0], 150, causal=True)
    assert _rel(got[:, :, 0].float(), want.float()) <= FLASH_TOL[dtype]


def test_flash_kernel_rejects_bad_inputs(card):
    q = torch.zeros((1, 64, 4, 64), device=card)
    with pytest.raises(ValueError):
        flash_cuda.flash_attn(q, q[:, :, :3].contiguous(), q[:, :, :3].contiguous())
    with pytest.raises(ValueError):
        flash_cuda.flash_attn(q, q.double(), q.double())
    wide = torch.zeros((1, 8, 1, 320), device=card)
    with pytest.raises(ValueError):
        flash_cuda.flash_attn(wide, wide, wide)


def _qkv(B, Sq, Sk, Hq, Hkv, hd, dtype, dev, seed):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal((B, S, H, hd), dtype=np.float32))
                 .to(dev, dtype) for S, H in ((Sq, Hq), (Sk, Hkv), (Sk, Hkv)))


def _flash_case(dev, dtype, B, Sq, Sk, Hq, Hkv, hd, seed, **kw):
    q, k, v = _qkv(B, Sq, Sk, Hq, Hkv, hd, dtype, dev, seed)
    before = flash_cuda.launches["flash_attn"]
    got = flash_cuda.flash_attn(q, k, v, **kw)
    want = gqa_attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_cuda.launches["flash_attn"] == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    assert torch.isfinite(got).all()
    err = _rel(got.float(), want.float())
    assert err <= FLASH_TOL[dtype], (Sq, Sk, Hq, Hkv, hd, kw, err)


@pytest.mark.parametrize("S", [1, 63, 64, 65, 200, 2048])
@pytest.mark.parametrize("hd", [64, 80, 128, 256])
def test_flash_bf16_tensor_cores_match_plain(card, hd, S):
    """The bf16 kernel (mma.sync) at every head-dim template and ragged
    edge: B = 2, query/KV head ratios 1, 4 and 8, causal and not."""
    for i, (Hq, Hkv) in enumerate(((2, 2), (4, 1), (8, 1))):
        for causal in (True, False):
            _flash_case(card, torch.bfloat16, 2, S, S, Hq, Hkv, hd,
                        seed=S + hd + i, causal=causal)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("Sq,Sk,causal,window,valid_len", [
    (1, 200, True, 0, None),         # Sq < Sk
    (65, 130, True, 0, None),
    (200, 63, True, 0, None),        # Sq > Sk
    (300, 1000, False, 0, None),
    (200, 200, True, 1, None),       # window edges
    (200, 200, True, 64, None),
    (300, 300, False, 100, None),
    (200, 200, True, 0, 150),        # valid_len < Sk
    (200, 200, False, 0, 63),
    (200, 200, True, 0, 0),          # no live key anywhere
    (200, 200, False, 0, 0),
    (300, 300, True, 64, 150),       # rows past valid_len + window: dead
], ids=lambda v: str(v))
def test_flash_masks_match_plain(card, dtype, Sq, Sk, causal, window, valid_len):
    """Sq != Sk, windows, valid_len < Sk (including 0 and rows with no live
    key, which the plain version gives the mean of v) in both kernels."""
    for hd in (64, 128):
        _flash_case(card, dtype, 2, Sq, Sk, 8, 2, hd, seed=Sq + Sk + hd,
                    causal=causal, window=window, valid_len=valid_len)


@pytest.mark.parametrize("hd", [33, 64, 200])
def test_flash_bf16_plain_load_path(card, hd):
    """Head dims that are not a multiple of 8, and tensors that are not
    16-byte aligned, load without cp.async."""
    _flash_case(card, torch.bfloat16, 2, 130, 130, 4, 2, hd, seed=hd, causal=True)
    q, k, v = _qkv(1, 100, 100, 4, 2, hd, torch.bfloat16, card, seed=hd + 1)
    shifted = []
    for t in (q, k, v):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=card)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        shifted.append(view)
    got = flash_cuda.flash_attn(*shifted, causal=True)
    assert shifted[0].data_ptr() % 16 != 0
    assert _rel(got.float(), gqa_attention_ref(q, k, v).float()) <= FLASH_TOL[torch.bfloat16]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [240, 256])
@pytest.mark.parametrize("window", [0, 64])
@pytest.mark.parametrize("cap", [30.0, 2.0])
def test_flash_softcap_matches_plain(card, dtype, hd, window, cap):
    """The score softcap (gemma3's 30, and 2, which bites on most scores):
    gemma3-12b's head dim 240 under the 256 template, and 256; causal,
    with and without a window; ragged S, GQA 2:1."""
    for S, seed in ((200, 1), (65, 2)):
        _flash_case(card, dtype, 2, S, S, 4, 2, hd, seed=seed + hd + window,
                    causal=True, window=window, softcap=cap)
    q, k, v = _qkv(1, 130, 130, 2, 1, hd, dtype, card, seed=3)
    capped = flash_cuda.flash_attn(q, k, v, softcap=cap).float()
    uncapped = flash_cuda.flash_attn(q, k, v).float()
    assert not torch.equal(capped, uncapped)
    if cap == 2.0:                      # bites on most scores of N(0, 1)
        assert _rel(capped, uncapped) > FLASH_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("Hq", [40, 56], ids=["llama4-scout", "arctic"])
def test_flash_query_groups_of_5_and_7(card, Hq, dtype):
    """The MoE archs' attention: 40 or 56 query heads over 8 KV heads of
    128, causal and not, ragged and whole tiles."""
    for S in (300, 1024):
        for causal in (True, False):
            _flash_case(card, dtype, 1, S, S, Hq, 8, 128, seed=Hq + S, causal=causal)


def test_flash_rejects_a_negative_softcap(card):
    q = torch.zeros((1, 64, 2, 64), device=card)
    for cap in (-1.0, float("nan"), float("inf")):
        with pytest.raises(ValueError, match="softcap"):
            flash_cuda.flash_attn(q, q, q, softcap=cap)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hd", [64, 256])
@pytest.mark.parametrize("S", [64, 300, 2048])
def test_flash_prefix_matches_plain(card, S, hd, dtype):
    """The prefix-LM mask ``(k <= q) | (k < prefix_len)`` in both kernels:
    prefixes of 1, one tile less one, one tile, one more, paligemma's 256
    and the whole sequence (those up to S), query groups of 1 and 8, all
    keys valid and valid_len < S; and valid_len 0 (every row dead: the mean
    of v)."""
    for prefix in sorted({p for p in (1, 63, 64, 65, 256, S) if p <= S}):
        for Hq, Hkv in ((2, 2), (8, 1)):
            for valid_len in (None, S - 37 if S > 64 else 50):
                _flash_case(card, dtype, 1, S, S, Hq, Hkv, hd, seed=S + prefix + Hq,
                            causal=True, prefix_len=prefix, valid_len=valid_len)
    _flash_case(card, dtype, 1, S, S, 8, 1, hd, seed=S, causal=True, prefix_len=S // 2,
                valid_len=0)


def test_flash_prefix_rejections(card):
    """A prefix with ``causal=0`` or with a window, or outside ``[0, Sk]``:
    the wrapper raises, and the C entry refuses the launch on its own."""
    q = torch.zeros((1, 64, 2, 64), device=card)
    for kw in (dict(causal=False, prefix_len=4), dict(window=8, prefix_len=4),
               dict(prefix_len=65), dict(prefix_len=-1)):
        with pytest.raises(ValueError, match="prefix_len"):
            flash_cuda.flash_attn(q, q, q, **kw)
    o = torch.empty_like(q)
    for dtype in (torch.float32, torch.bfloat16):
        qd, od = q.to(dtype), o.to(dtype)
        for causal, window, prefix in ((0, 0, 4), (1, 8, 4), (1, 0, 65), (1, 0, -1)):
            rc = flash_cuda._entry(dtype)(
                od.data_ptr(), qd.data_ptr(), qd.data_ptr(), qd.data_ptr(), 1, 64, 64,
                2, 2, 64, 64, causal, window, prefix, 0.125, 0.0,
                torch.cuda.current_stream(card).cuda_stream)
            assert rc != 0, (dtype, causal, window, prefix)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("Sq,Sk", [(1500, 1500), (432, 1500), (32, 1500)],
                         ids=["encoder", "cross-432", "cross-32"])
def test_flash_whisper_shapes_match_plain(card, Sq, Sk, dtype):
    """Whisper-medium's full attention: the encoder over 1,500 frames and
    the decoder's cross-attention (``Sq != Sk``), 16 heads of 64."""
    _flash_case(card, dtype, 1, Sq, Sk, 16, 16, 64, seed=Sq, causal=False)


def _stub(model, B, rows, seed, dev):
    if model.stub is None:
        return {}
    rows = rows if model.stub == "enc_embed" else model.cfg.prefix_len
    return {model.stub: torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (B, rows, model.cfg.d_model), dtype=np.float32)).to(dev)}


def _prefill_launches(cfg) -> int:
    """Flash launches of one prefill: every attention layer, and whisper's
    encoder layers and cross-attention blocks."""
    n = sum(k.startswith("attn") for k in cfg.kinds())
    return n + (cfg.encoder_layers + n if cfg.family == "audio" else 0)


@pytest.mark.parametrize("arch", ["whisper-medium", "paligemma-3b"])
def test_stub_archs_on_card_match_cpu(card, arch):
    """Whisper and paligemma at their smoke size (f32): prefill with the
    modality stub and three decode steps on the card against the CPU, same
    weights, tokens and stub (8e-3: the bf16 KV cache rounds in both, as
    for the other families); then a ServeEngine of 2 slots over 3 requests
    with a stub each."""
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = smoke_config(arch)
    rng = np.random.default_rng(9)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 20))).int()
    nxt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (3, 2, 1))).int()
    out = {}
    for dev in (torch.device("cpu"), card):
        model = Model(cfg, device=dev)
        params = model.init(torch.Generator().manual_seed(0))
        before = flash_cuda.launches["flash_attn"]
        logits, cache = model.prefill(params, toks.to(dev), 32,
                                      **_stub(model, 2, 24, 3, dev))
        steps = [logits]
        for t in nxt:
            logits, cache = model.decode_step(params, t.to(dev), cache)
            steps.append(logits)
        if dev.type == "cuda":
            assert flash_cuda.launches["flash_attn"] - before == _prefill_launches(cfg)
        out[dev.type] = torch.cat([t.float().cpu() for t in steps], 1)
    assert torch.isfinite(out["cuda"]).all()
    assert _rel(out["cuda"], out["cpu"]) <= 8e-3
    eng = ServeEngine(model, params, batch_slots=2, s_cache=32)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32), max_new=6,
                    extras={k: t[0].cpu().numpy() for k, t in _stub(model, 1, 24, i, "cpu").items()})
            for i, n in enumerate((5, 12, 7))]
    for r in reqs:
        eng.submit(r)
    before = flash_cuda.launches["flash_attn"]
    eng.run(max_steps=100)
    torch.cuda.synchronize()
    assert all(r.done and len(r.out) == 7 for r in reqs)
    assert flash_cuda.launches["flash_attn"] - before == 3 * _prefill_launches(cfg)


@pytest.mark.parametrize("arch,rows,T", [("whisper-medium", 300, 32),
                                         ("paligemma-3b", 256, 64)])
def test_stub_arch_prefill_at_full_width_matches_cpu_bf16(card, arch, rows, T):
    """Two layers of whisper (two encoder and two decoder layers) and of
    paligemma at full width, bf16: the prefill's logits and cache on the
    card (the flash kernel: full, cross and prefix) within 2e-2 of the
    CPU's bf16 on the same weights, tokens and stub."""
    from repro_torch.configs import get_config

    full = get_config(arch)
    cfg = dataclasses.replace(full, num_layers=2,
                              encoder_layers=min(full.encoder_layers, 2))
    model = Model(cfg, device=card)
    params = model.init(torch.Generator(device=card).manual_seed(0))
    cpu = Model(cfg, device="cpu")

    def to_cpu(tree):
        if isinstance(tree, list):
            return [to_cpu(t) for t in tree]
        return {k: to_cpu(v) if isinstance(v, (dict, list)) else v.cpu()
                for k, v in tree.items()}

    toks = torch.from_numpy(np.random.default_rng(4).integers(0, cfg.vocab_size, (1, T)))
    stub = _stub(model, 1, rows, 5, card)
    before = flash_cuda.launches["flash_attn"]
    got, cache = model.prefill(params, toks.to(card), T + rows, **stub)
    torch.cuda.synchronize()
    assert flash_cuda.launches["flash_attn"] - before == _prefill_launches(cfg)
    want, wcache = cpu.prefill(to_cpu(params), toks, T + rows,
                               **{k: t.cpu() for k, t in stub.items()})
    assert torch.isfinite(got).all()
    assert _rel(got.float().cpu(), want.float()) <= 2e-2
    for a, b in zip(cache["layers"], wcache["layers"]):
        assert _rel(a["k"].float().cpu(), b["k"].float()) <= 2e-2
    if "enc_out" in cache:
        assert _rel(cache["enc_out"].float().cpu(), wcache["enc_out"].float()) <= 2e-2


def _fused_matrix(name):
    if name == "chain":
        return chain_matrix(300)          # one row per span: 299 grid barriers
    if name == "lung2":
        return lung2_like(scale=0.05, seed=0)
    return random_lower(2000, seed=4)


def test_fused_batched_grid_fills_the_card(card):
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    for dtype in (torch.float32, torch.float64):
        assert fused_cuda.batched_grid(dtype) >= sms > 1


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("name", ["chain", "lung2", "random"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("m", [1, 7, 32, 33, 64])
def test_fused_batched_grid_matches_plain(card, m, dtype, name, transpose):
    """The cooperative-grid fused solve against the same solver on the CPU
    (the plain chunk walk): three solves back to back, with a value
    refresh before the third, so the barrier's counters are reused across
    launches."""
    L = _fused_matrix(name).astype(np.float32 if dtype == torch.float32 else np.float64)
    new = refresh_values(L, seed=1)
    rng = np.random.default_rng(m)
    bs = [torch.from_numpy(rng.standard_normal((L.n, m))).to(dtype) for _ in range(3)]
    out = {}
    for dev in (torch.device("cpu"), card):
        s = SpTRSV.build(L, transpose=transpose, device=dev, strategy="pallas_fused")
        before = fused_cuda.launches["sptrsv_fused_batched"]
        xs = [s.solve(bs[0].to(dev)), s.solve(bs[1].to(dev))]
        s.refresh(new)
        xs.append(s.solve(bs[2].to(dev)))
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert fused_cuda.launches["sptrsv_fused_batched"] == before + 3
        out[dev.type] = [x.cpu() for x in xs]
    for got, want in zip(out["cuda"], out["cpu"]):
        assert got.shape == want.shape
        assert _rel(got, want) <= KERNEL_TOL[dtype]


def test_lm_prefill_on_card_matches_cpu(card):
    """Smoke granite-3-8b: prefill and two decode steps on the card (the
    flash kernel) against the CPU (its plain version), same f32 weights and
    tokens.  Tolerance 1e-3: the KV cache is bf16 in both, and an f32
    difference of one rounding step can round a cached key one bf16 step
    apart."""
    cfg = smoke_config("granite-3-8b")
    rng = np.random.default_rng(9)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 40))).int()
    nxt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 2, 1))).int()
    out = {}
    for dev in (torch.device("cpu"), card):
        model = Model(cfg, device=dev)
        params = model.init(torch.Generator().manual_seed(0))
        before = flash_cuda.launches["flash_attn"]
        logits, cache = model.prefill(params, toks.to(dev), 64)
        steps = [logits]
        for t in nxt:
            logits, cache = model.decode_step(params, t.to(dev), cache)
            steps.append(logits)
        if dev.type == "cuda":
            assert flash_cuda.launches["flash_attn"] - before == cfg.num_layers
        out[dev.type] = torch.cat([t.float().cpu() for t in steps], 1)
    assert _rel(out["cuda"], out["cpu"]) <= 1e-3


@pytest.mark.parametrize("arch", ["gemma3-1b", "gemma3-12b", "qwen1.5-32b",
                                  "recurrentgemma-2b", "llama4-scout-17b-a16e",
                                  "arctic-480b", "xlstm-350m"])
def test_lm_family_on_card_matches_cpu(card, arch):
    """Each family of the later LM slices at its smoke size (f32): prefill
    (a prompt longer than the window of 8) and three decode steps on the
    card (the flash kernel, with gemma3's softcap; the experts; the mLSTM
    and sLSTM) against the CPU (its plain version), same weights and
    tokens; then a ServeEngine of 2 slots over 3 requests on the card.
    Tolerance 8e-3: the bf16 KV and conv caches and qwen's int8 cache round
    in both, and an f32 difference of one rounding step can round a cached
    entry one bf16 step (up to 2^-7) or one int8 step (1/127) apart."""
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = smoke_config(arch)
    n_attn = sum(k.startswith("attn") for k in cfg.kinds())
    rng = np.random.default_rng(9)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 20))).int()
    nxt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (3, 2, 1))).int()
    out = {}
    for dev in (torch.device("cpu"), card):
        model = Model(cfg, device=dev)
        params = model.init(torch.Generator().manual_seed(0))
        before = flash_cuda.launches["flash_attn"]
        logits, cache = model.prefill(params, toks.to(dev), 32)
        steps = [logits]
        for t in nxt:
            logits, cache = model.decode_step(params, t.to(dev), cache)
            steps.append(logits)
        if dev.type == "cuda":
            assert flash_cuda.launches["flash_attn"] - before == n_attn
        out[dev.type] = torch.cat([t.float().cpu() for t in steps], 1)
    assert torch.isfinite(out["cuda"]).all()
    assert _rel(out["cuda"], out["cpu"]) <= 8e-3
    eng = ServeEngine(model, params, batch_slots=2, s_cache=16)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32), max_new=10)
            for i, n in enumerate((5, 12, 7))]
    for r in reqs:
        eng.submit(r)
    before = flash_cuda.launches["flash_attn"]
    eng.run(max_steps=100)
    torch.cuda.synchronize()
    assert all(r.done and len(r.out) == 11 for r in reqs)
    assert flash_cuda.launches["flash_attn"] - before == n_attn * eng.prefills == 3 * n_attn


@pytest.mark.parametrize("arch", ["llama4-scout-17b-a16e", "arctic-480b"])
def test_moe_layer_on_card_matches_cpu(card, arch):
    """The MoE layer at its smoke size, f32: the same (token, choice)
    routes on the card as on the CPU, ``y`` within 1e-5 (the same f32
    products summed in another order) and ``aux`` within 1e-6; then the
    expert-parallel path on a world of one NCCL rank (the all-gather and
    both all-to-alls run) equal to the local path on the card."""
    from repro_torch.launch.mesh import destroy_process_group, make_mesh
    from repro_torch.models import moe
    from repro_torch.models.layers import Init

    cfg = smoke_config(arch)
    params = moe.init_moe(Init(torch.Generator().manual_seed(0), torch.float32,
                               torch.device("cpu")), cfg)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 40, cfg.d_model),
                                                                  dtype=np.float32))

    def to(tree, dev):
        return {k: to(v, dev) if isinstance(v, dict) else v.to(dev)
                for k, v in tree.items()}

    out, routes = {}, {}
    for dev in (torch.device("cpu"), card):
        p, xd = to(params, dev), x.to(dev)
        h = moe.rms_norm(p["ln"], xd).reshape(-1, cfg.d_model)
        r = moe._Routes(p, cfg, h, moe.capacity(h.shape[0], cfg))
        routes[dev.type] = (r.eflat.cpu(), r.slot.cpu())
        out[dev.type] = moe.moe_apply(p, cfg, xd)
    assert all(torch.equal(a, b) for a, b in zip(routes["cuda"], routes["cpu"]))
    y, aux = out["cuda"]
    assert y.is_cuda and _rel(y.cpu(), out["cpu"][0]) <= 1e-5
    assert abs(float(aux) - float(out["cpu"][1])) <= 1e-6
    mesh = make_mesh((1, 1), ("data", "model"))
    try:
        p = to(params, card)
        got, got_aux = moe.moe_apply(moe.shard_moe_params(p, mesh), cfg, x.to(card),
                                     mesh=mesh)
    finally:
        destroy_process_group()
    assert _rel(got, y) <= 1e-6 and abs(float(got_aux) - float(aux)) <= 1e-7


# --------------------------------------------------------------------------
# the rest of the solver's surface on the card
# --------------------------------------------------------------------------
SURFACE = {
    "serial": dict(strategy="serial"),
    "levelset_unroll": dict(strategy="levelset_unroll"),
    "levelset_unroll+coarsen": dict(strategy="levelset_unroll", coarsen=True),
    "auto": dict(strategy="auto"),
    "sweep": dict(strategy="sweep"),
    "sweep k=1": dict(strategy="sweep", sweep=dict(k=1)),
    "guard": dict(strategy="pallas_fused", guard=True),
    "guard mixed level": dict(strategy="pallas_level",
                              guard=dict(precision="mixed", refine_steps=4)),
    "guard mixed fused": dict(strategy="pallas_fused",
                              guard=dict(precision="mixed", refine_steps=4)),
}


def _surface_options(kw):
    from repro_torch.core import GuardConfig, SweepConfig
    kw = dict(kw)
    if isinstance(kw.get("sweep"), dict):
        kw["sweep"] = SweepConfig(**kw["sweep"])
    if isinstance(kw.get("guard"), dict):
        kw["guard"] = GuardConfig(**kw["guard"])
    return kw


@pytest.mark.parametrize("name", sorted(SURFACE))
def test_surface_strategy_on_card_matches_levelset(card, name):
    """Every strategy and option this slice added, on the card, against the
    plain levelset executor on the card (both directions, one RHS and a
    batch); the sweep's and the guard's SpMV launches are counted."""
    L = lung2_like(scale=0.02, fat_levels=4)
    B = torch.from_numpy(np.random.default_rng(5).standard_normal((L.n, 4))).to(card)
    spmv_cuda.reset_launches()
    for s, ref in zip(SpTRSV.build_pair(L, device=card,
                                        **_surface_options(SURFACE[name])),
                      SpTRSV.build_pair(L, device=card, strategy="levelset")):
        for rhs in (B[:, 0].contiguous(), B):
            assert _rel(s.solve(rhs), ref.solve(rhs)) <= 1e-12
    if name.startswith(("sweep", "guard")):
        assert spmv_cuda.launches["spmv_ell"] > 0
        assert spmv_cuda.launches["spmv_ell_batched"] > 0


def test_residual_terms_on_card_match_cpu(card):
    from repro_torch.core.codegen import device_ell
    from repro_torch.core.sweep import build_sweep_layout, residual_terms
    L = lung2_like(scale=0.02, fat_levels=4)
    lay = build_sweep_layout(L)
    rng = np.random.default_rng(6)
    b = rng.standard_normal((L.n, 3))
    x = rng.standard_normal((L.n, 3))
    x[5, 2] = np.nan
    out = {}
    for dev in (torch.device("cpu"), card):
        ell = device_ell(lay.ell, L.n, dev)
        r, ratio = residual_terms(torch.from_numpy(b).to(dev),
                                  torch.from_numpy(x).to(dev), ell.vals,
                                  torch.from_numpy(lay.diag).to(dev), ell)
        out[dev.type] = (r.cpu(), ratio.cpu())
    assert torch.isinf(out["cuda"][1][2])
    assert _rel(out["cuda"][1][:2], out["cpu"][1][:2]) <= 1e-12
    assert _rel(out["cuda"][0][:, :2], out["cpu"][0][:, :2]) <= 1e-12


@pytest.mark.parametrize("kw", [dict(strategy="pallas_fused"),
                                dict(strategy="pallas_level"),
                                dict(sweeps=8)], ids=["fused", "level", "sweeps"])
def test_pcg_on_card_matches_cpu(card, kw):
    from repro_torch.core.pcg import make_ic_preconditioner, pcg, pcg_batched
    from repro_torch.sparse import ic0_factor, poisson2d
    A = poisson2d(24, 24)
    Lf = ic0_factor(A)
    B = np.random.default_rng(7).standard_normal((A.n, 3))
    res = {}
    for dev in (torch.device("cpu"), card):
        M = make_ic_preconditioner(Lf, rewrite=None, device=dev, **kw)
        one = pcg(A, torch.from_numpy(B[:, 0]).to(dev), M, tol=1e-10)
        many = pcg_batched(A, torch.from_numpy(B).to(dev), M, tol=1e-10)
        res[dev.type] = (one.iters, many.iters.tolist(), one.x.cpu(), many.x.cpu())
    assert res["cuda"][:2] == res["cpu"][:2]
    assert _rel(res["cuda"][2], res["cpu"][2]) <= 1e-10
    assert _rel(res["cuda"][3], res["cpu"][3]) <= 1e-10


def test_guard_fault_policies_on_card(card):
    from repro_torch.core import GuardBreakdownError, GuardConfig
    from repro_torch.sparse import inject_values
    L = lung2_like(scale=0.02, fat_levels=4)
    b = torch.from_numpy(np.random.default_rng(8).standard_normal(L.n)).to(card)
    bad = inject_values(L, "zero_pivot")
    for policy in ("refine", "fallback", "raise"):
        s = SpTRSV.build(L, strategy="pallas_fused", device=card,
                         guard=GuardConfig(on_breakdown=policy))
        if policy == "raise":
            with pytest.raises(GuardBreakdownError):
                s.refresh(bad, validate=False)
            continue
        s.refresh(bad, validate=False)
        x = s.solve(b)
        st = s.guard.stats
        assert st.pivot_alarms == 1 and st.breakdown_columns == 1
        if policy == "fallback":
            assert st.fallback_solves == 1 and bool(torch.isfinite(x).all())


@pytest.mark.parametrize("strategy", ["pallas_fused", "pallas_level"])
def test_mixed_guard_refresh_keeps_tables_and_buffers(card, strategy):
    """A mixed-precision guarded pair refreshed in place: the bf16 / f32
    buffers keep their addresses, the kernels' tables (built from the
    pattern) stay valid, and the refreshed solve matches levelset."""
    from repro_torch.core import GuardConfig
    L = lung2_like(scale=0.02, fat_levels=4)
    new = refresh_values(L, seed=3)
    b = torch.from_numpy(np.random.default_rng(9).standard_normal((L.n, 3))).to(card)
    cfg = GuardConfig(precision="mixed", refine_steps=4)
    for s, ref in zip(SpTRSV.build_pair(L, strategy=strategy, device=card, guard=cfg),
                      SpTRSV.build_pair(L, strategy="levelset", device=card)):
        ptrs = [v.data_ptr() for v in s._values]
        s.refresh(new)
        ref.refresh(new)
        assert [v.data_ptr() for v in s._values] == ptrs
        assert [v.dtype for v in s._values] == [torch.bfloat16, torch.float32]
        assert _rel(s.solve(b), ref.solve(b)) <= 1e-12
        assert s.guard.stats.verified == 1


@pytest.mark.parametrize("transpose", [False, True], ids=["forward", "transpose"])
def test_engine_bucket_launch_counts(card, transpose):
    """A width-1 step of a ``pallas_fused`` engine is one single-RHS walk
    and no batched launch; a width-4 step one batched launch.  A
    ``pallas_level`` engine's width-1 step runs the single-RHS level
    kernel only."""
    from repro_torch.serve import SolveEngine
    L = lung2_like(scale=0.02, fat_levels=4)
    rng = np.random.default_rng(10)
    fused = SolveEngine.from_matrix(L, strategy="pallas_fused", device=card,
                                    max_batch=8)
    level = SolveEngine.from_matrix(L, strategy="pallas_level", device=card,
                                    max_batch=8)
    ref = SpTRSV.build(L, strategy="levelset", transpose=transpose, device="cpu")
    for width, want in ((1, {"sptrsv_fused": 1, "sptrsv_fused_batched": 0}),
                        (4, {"sptrsv_fused": 0, "sptrsv_fused_batched": 1})):
        reqs = [fused.submit(rng.standard_normal(L.n), transpose=transpose)
                for _ in range(width)]
        fused_cuda.reset_launches()
        assert fused.step() == width
        assert dict(fused_cuda.launches) == want
        for r in reqs:
            x = ref.solve(torch.from_numpy(r.b)).numpy()
            assert np.abs(r.x - x).max() / np.abs(x).max() <= 1e-12
    level.submit(rng.standard_normal(L.n), transpose=transpose)
    level_cuda.reset_launches()
    assert level.step() == 1
    assert level_cuda.launches["sptrsv_level"] > 0
    assert level_cuda.launches["sptrsv_level_batched"] == 0


def test_service_on_card_matches_cpu(card):
    """The same ``serve_traffic`` stream through a ``SolveService`` on the
    card and on the CPU (``background=False``, ``pallas_fused``): equal
    counters, answers to 1e-12."""
    from repro_torch.serve import SolveService
    from repro_torch.sparse import serve_traffic
    _, events = serve_traffic(num_patterns=3, num_tenants=4, num_events=60,
                              n=200, seed=7)
    out = {}
    for dev in (torch.device("cpu"), card):
        svc = SolveService(strategy="pallas_fused", background=False,
                           max_entries=2, max_batch=8, device=dev)
        reqs = []
        for ev in events:
            if ev["op"] == "register":
                svc.register(ev["tenant"], ev["matrix"])
            elif ev["op"] == "refresh":
                svc.refresh(ev["tenant"], ev["values"])
            else:
                reqs.append(svc.submit(ev["tenant"], ev["b"],
                                       transpose=ev["transpose"]))
            svc.step()
        svc.run()
        st = svc.stats()
        out[dev.type] = (reqs, {k: st[k] for k in ("completed", "failed",
                                                   "batches_completed")},
                         {k: st["registry"][k] for k in
                          ("hits", "misses", "promotions", "evictions")})
    assert out["cuda"][1:] == out["cpu"][1:]
    assert out["cuda"][1]["failed"] == 0
    for a, b in zip(out["cuda"][0], out["cpu"][0]):
        assert np.abs(a.x - b.x).max() / np.abs(b.x).max() <= 1e-12


def test_registry_background_build_promotes_on_card(card):
    """A background ``auto`` build promotes on the card; its answers equal
    the cold serial pair's."""
    import threading
    from repro_torch.serve import SolverRegistry
    L = lung2_like(scale=0.02, fat_levels=4)
    gate = threading.Event()
    reg = SolverRegistry(strategy="auto", device=card, build_gate=gate)
    entry = reg.get(L)
    b = np.random.default_rng(11).standard_normal(L.n)
    cold = entry.engine.submit(b, transpose=True)
    entry.engine.run()
    assert entry.state == "cold"
    gate.set()
    assert entry.wait_ready(timeout=120) and entry.build_error is None
    warm = entry.engine.submit(b, transpose=True)
    entry.engine.run()
    assert entry.state == "ready"
    assert np.abs(warm.x - cold.x).max() / np.abs(cold.x).max() <= 1e-10
    assert reg.wait_idle(timeout=120)


# -- the scatter layout (layout="scatter") ------------------------------------
@pytest.mark.parametrize("m", [1, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("coarsen", [False, True])
@pytest.mark.parametrize("transpose", [False, True])
def test_level_scatter_kernel_matches_plain(card, transpose, coarsen, dtype, m):
    """The scatter layout's level step (``sptrsv_level_scatter``) over a
    whole lung2 schedule, chains sub-step by sub-step, against its plain
    version: one launch per wavefront."""
    from repro_torch.kernels.sptrsv_level.ops import make_solver
    from repro_torch.kernels.sptrsv_level.ref import level_scatter_ref

    L = lung2_like(scale=0.05, fat_levels=8)
    if transpose:
        s = build_schedule(L.transpose(), build_reverse_level_sets(L), upper=True)
    else:
        s = build_schedule(L, build_level_sets(L))
    if coarsen:
        s = coarsen_schedule(s)
    fn = make_solver(s, device=card)
    rows, cols, vals, diag = fn.buffers
    vals, diag = vals.to(dtype), diag.to(dtype)
    rng = np.random.default_rng(11)
    tail = () if m == 1 else (m,)
    b_ext = torch.from_numpy(rng.standard_normal((L.n + 1,) + tail)).to(card, dtype)
    b_ext[L.n] = 0
    xk = torch.zeros((fn.n_pad,) + tail, dtype=dtype, device=card)
    xr = xk.clone()
    name = "sptrsv_level_scatter" + ("" if m == 1 else "_batched")
    before = level_cuda.launches[name]
    level_cuda.level_scatter(xk, b_ext, rows, cols, vals, diag, fn.table)
    level_scatter_ref(xr, b_ext, rows.long(), cols.long(), vals, diag, fn.table)
    torch.cuda.synchronize()
    assert level_cuda.launches[name] - before == fn.table.num_steps == s.total_depth
    assert torch.isfinite(xk).all()
    assert _rel(xk, xr) <= KERNEL_TOL[dtype]
    assert float(xk[L.n].abs().max()) == 0.0


@pytest.mark.parametrize("strategy", ["serial", "levelset", "levelset_unroll",
                                      "pallas_level", "pallas_fused", "sweep",
                                      "blocked", "auto"])
@pytest.mark.parametrize("kw", [{}, dict(coarsen=True),
                                dict(rewrite=RewriteConfig())])
def test_scatter_solver_on_card_matches_permuted(card, strategy, kw):
    L = lung2_like(scale=0.02, fat_levels=4)
    rng = np.random.default_rng(12)
    for m in (1, 3):
        b = torch.from_numpy(rng.standard_normal((L.n,) if m == 1 else (L.n, m))).to(card)
        for s, p in zip(SpTRSV.build_pair(L, device=card, strategy=strategy,
                                          layout="scatter", **kw),
                        SpTRSV.build_pair(L, device=card, strategy="levelset", **kw)):
            assert s.layout == "scatter"
            tol = 1e-8 if kw.get("rewrite") or s.strategy == "sweep" else 1e-12
            assert _rel(s.solve(b), p.solve(b)) <= tol


@pytest.mark.parametrize("m", [1, 32])
def test_scatter_blocked_runs_the_block_apply_per_super_level(card, m):
    """The scatter layout's blocked solve: one panel SpMV and one
    ``trsm_block_apply`` launch per super-level, against a dense solve."""
    L = banded_lower(600, bandwidth=24, fill=1.0)
    dense = L.to_dense()
    rhs = np.random.default_rng(13).standard_normal((L.n,) if m == 1 else (L.n, m))
    sfx = "" if m == 1 else "_batched"
    for s, A in zip(SpTRSV.build_pair(L, device=card, strategy="blocked",
                                      layout="scatter"), (dense, dense.T)):
        trsm_cuda.reset_launches()
        spmv_cuda.reset_launches()
        x = s.solve(torch.from_numpy(rhs).to(card)).cpu().numpy()
        segs = s.stats()["segments"]
        assert trsm_cuda.launches == {**{k: 0 for k in trsm_cuda.launches},
                                      f"trsm_block_apply{sfx}": segs}
        assert spmv_cuda.launches[f"spmv_ell{sfx}"] == segs
        np.testing.assert_allclose(x, np.linalg.solve(A, rhs), rtol=1e-12,
                                   atol=1e-12)
        seg = s.block_schedule.slabs[0]
        d = torch.from_numpy(seg.dinv).to(card)
        r = torch.from_numpy(np.random.default_rng(14).standard_normal(
            (seg.B, seg.T) if m == 1 else (seg.B, seg.T, m))).to(card)
        assert _rel(trsm_cuda.block_apply(d, r), block_apply_ref(d, r)) <= 1e-12


def test_scatter_refresh_on_card_rebuilds(card):
    L = lung2_like(scale=0.02, fat_levels=4)
    new = refresh_values(L, seed=2)
    s = SpTRSV.build(L, device=card, strategy="pallas_level", layout="scatter",
                     coarsen=True)
    s.refresh(new)
    fresh = SpTRSV.build(CSRMatrix(L.indptr, L.indices, new, L.shape), device=card,
                         strategy="pallas_level", layout="scatter", coarsen=True)
    b = torch.from_numpy(np.random.default_rng(15).standard_normal(L.n)).to(card)
    assert torch.equal(s.solve(b), fresh.solve(b))
    assert not s.stats()["refreshable_in_place"]


@pytest.mark.parametrize("layout", ["permuted", "scatter"])
def test_distributed_world_of_one_on_card(card, layout):
    """``strategy="distributed"`` on a world of one NCCL rank: the answers
    of both exchanges equal the ``levelset`` solve, one collective per
    sharded segment."""
    from repro_torch.core import dist as tdist
    from repro_torch.launch.mesh import destroy_process_group, make_mesh

    mesh = make_mesh((1,), ("data",))
    try:
        L = lung2_like(scale=0.02, fat_levels=4)
        B = torch.from_numpy(np.random.default_rng(0).standard_normal((L.n, 3))).to(card)
        for kw in ({}, dict(coarsen=True), dict(rewrite=RewriteConfig())):
            ref = SpTRSV.build_pair(L, strategy="levelset", **kw)
            for ds in tdist.DIST_STRATEGIES:
                pair = SpTRSV.build_pair(L, strategy="distributed", mesh=mesh,
                                         dist_strategy=ds, layout=layout, **kw)
                for s, r in zip(pair, ref):
                    for b in (B[:, 0].contiguous(), B):
                        tdist.reset_collectives()
                        x = s.solve(b)
                        assert x.is_cuda
                        assert tdist.collectives[ds] == sum(
                            sl.depth == 1 for sl in s.schedule.slabs)
                        assert _rel(x, r.solve(b)) <= KERNEL_TOL[torch.float64]
    finally:
        destroy_process_group()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_doubling_recurrence_on_card(card, dtype):
    from repro_torch.core.recurrence import linear_recurrence

    rng = np.random.default_rng(1)
    a = torch.from_numpy(rng.uniform(0.2, 0.99, (2, 300, 64))).to(card, dtype)
    u = torch.from_numpy(rng.normal(size=(2, 300, 64))).to(card, dtype)
    h = linear_recurrence(a, u, method="doubling", axis=1)
    want = linear_recurrence(a.cpu().double(), u.cpu().double(),
                             method="scan", axis=1)
    assert h.is_cuda and h.dtype == dtype
    assert _rel(h.cpu().double(), want) <= (1e-5 if dtype == torch.float32
                                            else 1e-12)
