"""The port's scatter layout (``layout="scatter"``, on ``device="cpu"``)
against the JAX package's: every strategy, both directions, with the
rewrite and with coarsening, ``(n,)`` and ``(n, m)`` right-hand sides, f32
and f64; refresh as a cold rebuild, the mixed-precision ``ValueError``,
``stats()``, ``build_pair`` / ``build_cold``, the lazy fallbacks and the
scatter executors' pieces.

The JAX scatter executors compile one program per level, so the parity
matrix is a small lung2 (147 rows, 21 levels).  The JAX ``pallas_fused``
build fails under JAX 0.9.0 (ROADMAP C-ref 1), so the port's scatter fused
solve is held against the JAX scatter ``levelset`` (and so is the scatter
``sweep``, whose JAX twin takes minutes to compile on the transpose; it is
held against the JAX sweep forward); the JAX
``pallas_level`` runs on ``backend="interpret"``; the JAX ``blocked`` runs
its ``dot_general`` apply (``block_kernel="jnp"``: its Pallas kernel sums
in f32, C-ref 3)."""
import logging

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import repro.sparse as jsparse
from repro.compat import enable_x64
from repro.core import GuardConfig as JaxGuardConfig
from repro.core import RewriteConfig as JaxRewriteConfig
from repro.core import SpTRSV as JaxSpTRSV
from repro.core.sweep import SweepConfig as JaxSweepConfig
from repro.sparse import refresh_values

import repro_torch.core.codegen as t_codegen
from repro_torch.core import (CoarsenConfig, GuardConfig, RewriteConfig,
                              STRATEGIES, SpTRSV, SweepConfig)
from repro_torch.core.rewrite import rewrite_matrix
from repro_torch.core.levels import build_level_sets
from repro_torch.kernels.sptrsv_level import cuda as level_cuda
from repro_torch.kernels.sptrsv_level.ops import make_solver as level_make_solver
from repro_torch.kernels.sptrsv_level.ref import level_scatter_ref
from repro_torch.kernels.trsm_block import cuda as trsm_cuda
from repro_torch.kernels.trsm_block.ops import block_apply, make_block_apply

from _torch_parity import TOL, carry, jax_matrix, to_port

# lung2's structure (fat wavefronts between runs of thin chained pairs) at
# a depth the JAX scatter executors compile in seconds
SMALL_LUNG2 = dict(scale=0.01, fat_levels=3, thin_run=6)
# the JAX strategy each port strategy is held against (C-ref 1 for fused)
# the JAX scatter sweep on the transpose takes minutes to compile (XLA's
# fusion search over the unrolled sweeps): the port's is held against the
# JAX scatter levelset, and against the JAX sweep forward only
JAX_TWIN = {"pallas_fused": "levelset", "sweep": "levelset"}
JAX_OPTIONS = {"pallas_level": dict(backend="interpret"),
               "blocked": dict(block_kernel="jnp")}
TRANSFORMS = {"rewrite": dict(rewrite=RewriteConfig()),
              "coarsen": dict(coarsen=True)}
# every strategy but ``distributed``, which needs a process group
# (tests/test_torch_dist.py runs it in both layouts)
LOCAL_STRATEGIES = tuple(s for s in STRATEGIES if s != "distributed")
# the rewrite changes the arithmetic (the JAX package's rewrite tolerance)
RW_TOL = {np.float32: dict(rtol=1e-4, atol=1e-4),
          np.float64: dict(rtol=1e-8, atol=1e-8)}

_JAX_CACHE = {}


def _lung2(dtype=np.float64):
    return jsparse.lung2_like(dtype=dtype, **SMALL_LUNG2)


def _rhs(n, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n).astype(dtype),
            rng.standard_normal((n, 3)).astype(dtype))


def _jax_kw(kw):
    return {k: (carry(v, JaxRewriteConfig) if k == "rewrite" else v)
            for k, v in kw.items()}


def _jax_answers(strategy, dtype, transform):
    """The JAX scatter pair's answers (forward, transpose) x (b, B) on the
    small lung2, cached across tests."""
    key = (strategy, np.dtype(dtype).name, transform)
    if key not in _JAX_CACHE:
        L = _lung2(dtype)
        kw = dict(TRANSFORMS.get(transform, {}))
        with enable_x64(dtype == np.float64):
            pair = JaxSpTRSV.build_pair(
                L, strategy=strategy, layout="scatter",
                **JAX_OPTIONS.get(strategy, {}), **_jax_kw(kw))
            answers = [[np.asarray(s.solve(jnp.asarray(r))) for r in _rhs(L.n, dtype)]
                       for s in pair]
            _JAX_CACHE[key] = ([s.strategy for s in pair], answers)
    return _JAX_CACHE[key]


def _port_pair(L, **kw):
    return SpTRSV.build_pair(to_port(L), layout="scatter", device="cpu", **kw)


@pytest.mark.parametrize("strategy", LOCAL_STRATEGIES)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_scatter_matches_jax(dtype, strategy):
    L = _lung2(dtype)
    pair = _port_pair(L, strategy=strategy)
    strategies, want = _jax_answers(JAX_TWIN.get(strategy, strategy), dtype,
                                    None)
    if strategy not in JAX_TWIN:
        assert [s.strategy for s in pair] == strategies
    dense = L.to_dense().astype(np.float64)
    for s, A, answers in zip(pair, (dense, dense.T), want):
        assert s.layout == "scatter" and s._values is None
        for rhs, ref in zip(_rhs(L.n, dtype), answers):
            got = s.solve(torch.from_numpy(rhs))
            assert got.dtype == torch.from_numpy(rhs).dtype
            assert tuple(got.shape) == rhs.shape
            np.testing.assert_allclose(got.numpy(), ref, **TOL[dtype])
            tol = TOL[dtype] if dtype == np.float64 else dict(rtol=1e-4, atol=1e-5)
            np.testing.assert_allclose(got.numpy(), np.linalg.solve(A, rhs), **tol)


@pytest.mark.parametrize("transform", sorted(TRANSFORMS))
@pytest.mark.parametrize("strategy", LOCAL_STRATEGIES)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_scatter_transforms_match_jax(dtype, strategy, transform):
    """With the rewrite or coarsening, every strategy against the JAX
    scatter ``levelset`` on the same transform (and ``auto``'s and the
    rewrite's decisions against the JAX package's own)."""
    L = _lung2(dtype)
    kw = TRANSFORMS[transform]
    pair = _port_pair(L, strategy=strategy, **kw)
    _, want = _jax_answers("levelset", dtype, transform)
    if strategy == "auto":
        with enable_x64(dtype == np.float64):
            jpair = JaxSpTRSV.build_pair(L, strategy="auto", layout="scatter",
                                         **_jax_kw(kw))
        assert [s.strategy for s in pair] == [s.strategy for s in jpair]
        # the reasons differ only in the backend's name
        assert ([s.plan.reason.rsplit("backend=", 1)[0] for s in pair]
                == [s.plan.reason.rsplit("backend=", 1)[0] for s in jpair])
    tol = RW_TOL[dtype] if transform == "rewrite" else TOL[dtype]
    if transform == "rewrite":
        assert pair[0].rewrite_result.stats.rows_rewritten > 0
    for s, answers in zip(pair, want):
        if transform == "rewrite":
            assert (s._rhs_fn is None) == (s.rewrite_result.stats.e_nnz_offdiag == 0)
            assert s._e_values is None
        for rhs, ref in zip(_rhs(L.n, dtype), answers):
            np.testing.assert_allclose(s.solve(torch.from_numpy(rhs)).numpy(),
                                       ref, **tol)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_scatter_sweep_matches_jax_forward(dtype):
    L = _lung2(dtype)
    kw = dict(strategy="sweep", layout="scatter", sweep=SweepConfig(k=24))
    ours = SpTRSV.build(to_port(L), device="cpu", **kw)
    with enable_x64(dtype == np.float64):
        ref = JaxSpTRSV.build(L, **{**kw, "sweep": carry(kw["sweep"], JaxSweepConfig)})
        for rhs in _rhs(L.n, dtype):
            np.testing.assert_allclose(ours.solve(torch.from_numpy(rhs)).numpy(),
                                       np.asarray(ref.solve(jnp.asarray(rhs))),
                                       **TOL[dtype])
    assert ours.sweep_stats.report() == {**ref.sweep_stats.report(),
                                         "last_residual_ratio": ours.sweep_stats.last_residual_ratio}
    assert ours.sweep_stats.fallback_solves == 0


@pytest.mark.parametrize("strategy", ["pallas_level", "levelset"])
def test_scatter_chains_run_every_sub_step(strategy):
    """A coarsened schedule's chains run sub-step by sub-step: the level
    kernel's step table holds one row per wavefront."""
    L = _lung2()
    fwd, bwd = _port_pair(L, strategy=strategy, coarsen=CoarsenConfig())
    for s in (fwd, bwd):
        assert any(sl.depth > 1 for sl in s.schedule.slabs)
        if strategy == "pallas_level":
            assert s._solve_fn.table.num_steps == s.schedule.total_depth
        assert s.stats()["segments"] == s.schedule.num_segments


# (the sparse band's ~170 one-block super-levels take the JAX package
# half a minute to compile)
@pytest.mark.parametrize("name", ["chain", "random", "dense_band"])
def test_scatter_blocked_matches_jax_on_structures(name):
    """Blocked in the scatter layout (a panel SpMV and a batched block apply
    per super-level) against the JAX scatter blocked solve (``dot_general``
    apply, f64) and a dense solve."""
    L = jax_matrix(name)
    pair = _port_pair(L, strategy="blocked")
    with enable_x64():
        jpair = JaxSpTRSV.build_pair(L, strategy="blocked", layout="scatter",
                                     block_kernel="jnp")
        dense = L.to_dense()
        for s, j, A in zip(pair, jpair, (dense, dense.T)):
            assert s.stats()["segments"] == j.stats()["segments"]
            for rhs in _rhs(L.n, np.float64, seed=2):
                got = s.solve(torch.from_numpy(rhs)).numpy()
                np.testing.assert_allclose(
                    got, np.asarray(j.solve(jnp.asarray(rhs))), **TOL[np.float64])
                np.testing.assert_allclose(got, np.linalg.solve(A, rhs),
                                           **TOL[np.float64])


def test_scatter_refresh_is_a_cold_rebuild(caplog):
    L = _lung2()
    s = SpTRSV.build(to_port(L), strategy="pallas_level", layout="scatter",
                     device="cpu", coarsen=True)
    new = refresh_values(L, seed=3)
    b = torch.from_numpy(_rhs(L.n, np.float64)[1])
    with caplog.at_level(logging.WARNING, logger="repro_torch.core.solver"):
        assert s.refresh(new) is s
    assert ("layout='scatter' embeds values as trace-time constants — "
            "falling back to a cold rebuild") in caplog.text
    assert s.layout == "scatter" and s.strategy == "pallas_level"
    assert not s.stats()["refreshable_in_place"]
    fresh = SpTRSV.build(type(to_port(L)).from_numpy(L.indptr, L.indices, new,
                                                     L.shape),
                         strategy="pallas_level", layout="scatter", device="cpu",
                         coarsen=True)
    assert torch.equal(s.solve(b), fresh.solve(b))
    np.testing.assert_allclose(s.solve(b).numpy(),
                               np.linalg.solve(_dense_of(L, new), b.numpy()),
                               **TOL[np.float64])


def _dense_of(L, data):
    out = np.zeros(L.shape)
    rows = np.repeat(np.arange(L.n), np.diff(L.indptr))
    out[rows, L.indices] = data
    return out


@pytest.mark.parametrize("strategy", ["serial", "sweep", "blocked"])
def test_scatter_refresh_pair_and_rewrite(strategy):
    """A transpose scatter solver and a rewritten one rebuild cold on the
    reordered / replayed values."""
    L = _lung2()
    new = refresh_values(L, seed=5)
    kw = dict(strategy=strategy, rewrite=RewriteConfig())
    fwd, bwd = _port_pair(L, **kw)
    fwd.refresh(new)
    bwd.refresh(new)
    A = _dense_of(L, new)
    for s, M in ((fwd, A), (bwd, A.T)):
        for rhs in _rhs(L.n, np.float64):
            np.testing.assert_allclose(s.solve(torch.from_numpy(rhs)).numpy(),
                                       np.linalg.solve(M, rhs), **RW_TOL[np.float64])


def test_scatter_mixed_precision_raises():
    L = to_port(_lung2())
    msg = ("guard precision='mixed' requires layout='permuted' — mixed "
           "storage lowers the runtime value buffers, and the scatter layout "
           "embeds values as trace-time constants")
    with pytest.raises(ValueError, match=msg):
        SpTRSV.build(L, layout="scatter", device="cpu",
                     guard=GuardConfig(precision="mixed"))
    with pytest.raises(ValueError, match=msg):
        SpTRSV.build_pair(L, layout="scatter", device="cpu",
                          guard=GuardConfig(precision="mixed"))
    with enable_x64():
        with pytest.raises(ValueError, match=msg):
            JaxSpTRSV.build(_lung2(), layout="scatter",
                            guard=JaxGuardConfig(precision="mixed"))


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("strategy", ["serial", "levelset", "pallas_level",
                                      "blocked", "sweep"])
def test_scatter_stats_match_jax(strategy, transpose):
    L = _lung2()
    ours = SpTRSV.build(to_port(L), transpose=transpose, strategy=strategy,
                        layout="scatter", device="cpu")
    with enable_x64():
        ref = JaxSpTRSV.build(L, transpose=transpose, strategy=strategy,
                              layout="scatter", **JAX_OPTIONS.get(strategy, {}))
    a, b = ours.stats(), ref.stats()
    assert set(a) == set(b)
    for key in ("strategy", "layout", "transpose", "n", "nnz", "segments",
                "supernode_count", "mean_block_size", "dense_block_fraction",
                "permutation_applied", "packed_value_bytes", "packed_index_bytes",
                "packed_bytes", "pattern_hash", "padded_value_bytes", "n_pad",
                "refreshable_in_place", "critical_path_flops", "rewrite"):
        assert a[key] == b[key], key
    assert a["layout"] == "scatter" and a["packed_bytes"] is None
    assert a["refreshable_in_place"] is False
    assert ours.packed_stats is None


def test_scatter_build_pair_and_build_cold():
    L = _lung2()
    Lt = to_port(L)
    fwd, bwd = SpTRSV.build_cold(Lt, transpose_too=True, layout="scatter",
                                 device="cpu")
    only, none = SpTRSV.build_cold(Lt, layout="scatter", device="cpu")
    assert none is None
    for s in (fwd, bwd, only):
        assert (s.strategy, s.layout) == ("serial", "scatter")
    with enable_x64():
        jf, jb = JaxSpTRSV.build_cold(L, transpose_too=True, layout="scatter")
        for rhs in _rhs(L.n, np.float64):
            for s, j in ((fwd, jf), (bwd, jb), (only, jf)):
                np.testing.assert_allclose(
                    s.solve(torch.from_numpy(rhs)).numpy(),
                    np.asarray(j.solve(jnp.asarray(rhs))), **TOL[np.float64])


def test_scatter_guard_and_sweep_fallbacks_build_scatter():
    """The guard's and the sweep's lazy exact fallbacks are built in the
    solver's layout."""
    L = _lung2()
    Lt = to_port(L)
    b = torch.from_numpy(_rhs(L.n, np.float64)[1])
    want = np.linalg.solve(L.to_dense(), b.numpy())
    sw = SpTRSV.build(Lt, strategy="sweep", layout="scatter", device="cpu",
                      sweep=SweepConfig(k=1, fallback="pallas_level"))
    np.testing.assert_allclose(sw.solve(b).numpy(), want, **TOL[np.float64])
    assert sw.sweep_stats.fallback_solves == 1
    seen = []
    orig = SpTRSV._build_system

    def spy(*args, **kw):
        seen.append(kw.get("layout"))
        return orig(*args, **kw)

    import repro_torch.core.solver as solver_mod
    solver_mod.SpTRSV._build_system = staticmethod(spy)
    try:
        g = SpTRSV.build(Lt, strategy="levelset", layout="scatter", device="cpu",
                         guard=GuardConfig(on_breakdown="fallback"))
        g.refresh(jsparse.inject_values(L, "zero_pivot", seed=7), validate=False)
        x = g.solve(b)
        sw2 = SpTRSV.build(Lt, strategy="sweep", layout="scatter", device="cpu",
                           sweep=SweepConfig(k=1))
        sw2.solve(b)
    finally:
        solver_mod.SpTRSV._build_system = staticmethod(orig)
    assert torch.isfinite(x).all()
    assert g.guard.stats.fallback_solves == 1
    assert seen and set(seen) == {"scatter"}


def test_scatter_executor_pieces():
    L = to_port(_lung2())
    levels = build_level_sets(L)
    # b' = E b is None when E is the identity, one SpMV otherwise
    res = rewrite_matrix(L, levels, RewriteConfig(thin_threshold=0))
    if res.stats.e_nnz_offdiag == 0:
        assert t_codegen.make_rhs_transform(res, device="cpu") is None
    res = rewrite_matrix(L, levels, RewriteConfig())
    fn = t_codegen.make_rhs_transform(res, device="cpu")
    b = torch.from_numpy(_rhs(L.n, np.float64)[1])
    E = res.E.to_dense()
    np.testing.assert_allclose(fn(b).numpy(), E @ b.numpy(), **TOL[np.float64])
    # the block apply of the scatter blocked solve is block_apply
    assert make_block_apply() is block_apply
    before = (dict(level_cuda.launches), dict(trsm_cuda.launches))
    for s in LOCAL_STRATEGIES:
        SpTRSV.build(L, strategy=s, layout="scatter", device="cpu").solve(b)
    assert (dict(level_cuda.launches), dict(trsm_cuda.launches)) == before


def test_level_scatter_ref_matches_the_jax_level_step():
    """One scatter step's plain version against the JAX package's TPU level
    kernel (interpret mode) on the same padded slab, then its row scatter
    and the scratch reset."""
    from repro.core.codegen import build_schedule as j_build_schedule
    from repro.core.levels import build_level_sets as j_build_levels
    from repro.kernels.sptrsv_level import lowering_tpu

    L = _lung2()
    sched = j_build_schedule(L, j_build_levels(L))
    fn = level_make_solver(t_codegen.build_schedule(to_port(L)), device="cpu")
    table = fn.table
    assert table.num_steps == sched.num_levels and table.n == L.n
    rng = np.random.default_rng(1)
    n_pad = -(-(L.n + 1) // 128) * 128
    for m in (None, 3):
        shape = (n_pad,) if m is None else (n_pad, m)
        x0 = rng.standard_normal(shape)
        b_ext = rng.standard_normal(shape[:1] if m is None else (L.n + 1, m))[: L.n + 1]
        b_ext[L.n] = 0
        slab = sched.slabs[5]
        K, R = slab.K, slab.R
        rows = np.full(128, L.n, np.int64)
        rows[:R] = slab.rows
        cols = np.zeros((K, 128), np.int64)
        cols[:, :R] = slab.cols
        vals = np.zeros((K, 128))
        vals[:, :R] = slab.vals
        diag = np.ones(128)
        diag[:R] = slab.diag
        one = type(table)(host=np.array([[K, 128, 0, 0]]), n=L.n,
                          need={"vals": K * 128, "diag": 128, "xl": 128})
        x = torch.from_numpy(x0.copy())
        level_scatter_ref(x, torch.from_numpy(b_ext), torch.from_numpy(rows),
                          torch.from_numpy(cols.ravel()),
                          torch.from_numpy(vals.ravel()), torch.from_numpy(diag),
                          one)
        with enable_x64():
            kern = (lowering_tpu.level_solve_blocks if m is None
                    else lowering_tpu.level_solve_blocks_batched)
            xl = np.asarray(kern(jnp.asarray(x0), jnp.asarray(b_ext[rows]),
                                 jnp.asarray(cols.astype(np.int32)),
                                 jnp.asarray(vals), jnp.asarray(diag),
                                 block_rows=128, interpret=True))
        want = x0.copy()
        want[rows] = xl
        want[L.n] = 0
        np.testing.assert_allclose(x.numpy(), want, **TOL[np.float64])
