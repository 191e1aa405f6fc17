"""The CUDA kernels on the card: each held against its plain torch version
on the same CUDA tensors; the solver's kernel strategies, with and without
equation rewriting, against the plain ``levelset`` executor; and the
blocked solve against a dense solve.  Marked ``cuda``: they skip where no GPU is
visible, and run on a machine with one via

    PYTHONPATH=src python -m pytest -q -m cuda --noconftest tests/test_torch_cuda.py

This file imports only the port, and ``--noconftest`` skips the suite's
JAX set-up: the GPU machine has no JAX."""
import numpy as np
import pytest
import torch

from repro_torch.core import RewriteConfig, SpTRSV
from repro_torch.core.coarsen import coarsen_schedule
from repro_torch.core.codegen import build_ell, build_schedule
from repro_torch.core.levels import build_level_sets
from repro_torch.core.packed import segment_steps
from repro_torch.core.rewrite import rewrite_matrix
from repro_torch.kernels.spmv_ell import cuda as spmv_cuda
from repro_torch.kernels.spmv_ell.ops import device_cols
from repro_torch.kernels.spmv_ell.ref import spmv_ref
from repro_torch.kernels.sptrsv_fused import cuda as fused_cuda
from repro_torch.kernels.sptrsv_fused.ops import build_layout
from repro_torch.kernels.sptrsv_fused.ref import fused_solve_ref
from repro_torch.kernels.sptrsv_level import cuda as level_cuda
from repro_torch.kernels.sptrsv_level.ops import make_packed_solver
from repro_torch.kernels.sptrsv_level.ref import level_walk_ref
from repro_torch.kernels.trsm_block import cuda as trsm_cuda
from repro_torch.kernels.trsm_block.ref import block_apply_ref
from repro_torch.sparse import banded_lower, lung2_like

# |kernel - plain| / max |plain|: nvcc contracts to FMA, bits may differ
KERNEL_TOL = {torch.float32: 1e-5, torch.float64: 1e-12}

pytestmark = pytest.mark.cuda


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
    steps = segment_steps(lay)
    cols = torch.from_numpy(lay.cols_flat).to(card)
    g = torch.Generator().manual_seed(0)
    shape = (lay.n_pad + 128,) + (() if m == 1 else (m,))
    x0 = torch.randn(shape, generator=g, dtype=dtype).to(card)
    bhat = torch.randn(shape, generator=g, dtype=dtype).to(card)
    vf, df = vals[0].to(dtype), vals[1].to(dtype)
    key = "sptrsv_level" if m == 1 else "sptrsv_level_batched"
    before = level_cuda.launches[key]
    xk, xr = x0.clone(), x0.clone()
    level_cuda.level_walk(xk, bhat, cols, vf, df, steps)
    level_walk_ref(xr, bhat, cols, vf, df, steps)
    torch.cuda.synchronize()
    assert level_cuda.launches[key] - before == len(steps)
    assert _rel(xk, xr) <= KERNEL_TOL[dtype]


@pytest.mark.parametrize("m", [1, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_fused_kernel_matches_plain(card, dtype, m):
    lay = build_layout(_schedule(False))
    cols = torch.from_numpy(lay.cols).to(card)
    vals = torch.from_numpy(lay.vals).to(card, dtype)
    diag = torch.from_numpy(lay.diag).to(card, dtype)
    spans = torch.tensor(lay.spans, dtype=torch.int32, device=card)
    g = torch.Generator().manual_seed(1)
    bl = torch.randn((lay.n_pad,) + (() if m == 1 else (m,)), generator=g,
                     dtype=dtype).to(card)
    key = "sptrsv_fused" if m == 1 else "sptrsv_fused_batched"
    before = fused_cuda.launches[key]
    xk = fused_cuda.fused_solve(bl, cols, vals, diag, spans)
    xr = fused_solve_ref(bl, cols, vals, diag, chunk=lay.chunk)
    torch.cuda.synchronize()
    assert fused_cuda.launches[key] == before + 1
    assert _rel(xk, xr) <= KERNEL_TOL[dtype]


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
