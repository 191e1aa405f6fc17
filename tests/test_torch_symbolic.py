"""The port's host-side symbolic layer against the JAX package, array for
array: generators, CSR, levels, analysis, schedules, coarsening, packed and
fused layouts, forward and transpose, coarsened and not."""
import numpy as np
import pytest

import repro.core.analysis as j_analysis
import repro.core.codegen as j_codegen
import repro.core.coarsen as j_coarsen
import repro.core.csr as j_csr
import repro.core.levels as j_levels
import repro.core.packed as j_packed
import repro.sparse as jsparse
from repro.kernels.sptrsv_fused import ops as j_fused_ops
from repro.kernels.sptrsv_level import ops as j_level_ops

import repro_torch.core.analysis as t_analysis
import repro_torch.core.codegen as t_codegen
import repro_torch.core.coarsen as t_coarsen
import repro_torch.core.csr as t_csr
import repro_torch.core.levels as t_levels
import repro_torch.core.packed as t_packed
import repro_torch.sparse as tsparse
from repro_torch.kernels.sptrsv_fused import ops as t_fused_ops
from repro_torch.kernels.sptrsv_level import ops as t_level_ops

from _torch_parity import (MATRICES, assert_same, jax_matrix, port_matrix,
                           systems as _systems, to_port)

NAMES = sorted(MATRICES)


def _schedules(name, transpose, coarsen, bucket=0.0):
    sj, st, lj, lt = _systems(name, transpose)
    a = j_codegen.build_schedule(sj, lj, upper=transpose, bucket_pad_ratio=bucket)
    b = t_codegen.build_schedule(st, lt, upper=transpose, bucket_pad_ratio=bucket)
    if coarsen:
        a = j_coarsen.coarsen_schedule(a, j_coarsen.CoarsenConfig(), unroll_threshold=4)
        b = t_coarsen.coarsen_schedule(b, t_coarsen.CoarsenConfig(), unroll_threshold=4)
    return a, b


@pytest.mark.parametrize("gen,kw", [
    ("lung2_like", dict(scale=0.02, fat_levels=4)),
    ("lung2_like", dict(scale=0.01, fat_levels=3, thin_run=5, seed=2)),
    ("banded_lower", dict(n=300)),
    ("chain_matrix", dict(n=64)),
    ("random_lower", dict(n=200, seed=3)),
])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_generators_match(gen, kw, dtype):
    a = getattr(jsparse, gen)(dtype=dtype, **kw)
    b = getattr(tsparse, gen)(dtype=dtype, **kw)
    assert_same(b, a)
    np.testing.assert_array_equal(tsparse.refresh_values(b, seed=5),
                                  jsparse.refresh_values(a, seed=5))


def test_ic0_factor_matches():
    a = jsparse.ic0_factor(jsparse.poisson2d(6, 7))
    b = tsparse.ic0_factor(tsparse.poisson2d(6, 7))
    assert_same(b, a)


@pytest.mark.parametrize("name", NAMES)
def test_csr_ops_match(name):
    Lj = jax_matrix(name)
    Lt = port_matrix(name)
    assert Lt.pattern_hash() == Lj.pattern_hash()
    assert to_port(Lj).pattern_hash() == Lj.pattern_hash()
    Lt.validate()
    assert Lt.is_lower_triangular() and not Lt.transpose().is_lower_triangular()
    assert_same(Lt.transpose(), Lj.transpose())
    assert_same(Lt.csc_view(), Lj.csc_view())
    np.testing.assert_array_equal(Lt.to_dense(), Lj.to_dense())
    np.testing.assert_array_equal(Lt.row_nnz(), Lj.row_nnz())
    np.testing.assert_array_equal(Lt.diagonal(), Lj.diagonal())
    np.testing.assert_array_equal(Lt.transpose().diagonal(first=True),
                                  Lj.transpose().diagonal(first=True))
    dense = Lj.to_dense()
    assert_same(t_csr.from_dense(dense), j_csr.from_dense(dense))
    assert_same(t_csr.eye_csr(7), j_csr.eye_csr(7))


def test_validate_rejects_unsorted_row():
    L = t_csr.CSRMatrix.from_numpy([0, 1, 3], [0, 1, 0], [1.0, 2.0, 3.0], (2, 2))
    with pytest.raises(AssertionError):
        L.validate()


@pytest.mark.parametrize("name", NAMES)
def test_levels_match(name):
    Lj = jax_matrix(name)
    Lt = to_port(Lj)
    np.testing.assert_array_equal(t_levels.compute_levels(Lt),
                                  j_levels.compute_levels(Lj))
    fj, ft = j_levels.build_level_sets(Lj), t_levels.build_level_sets(Lt)
    assert_same(ft, fj)
    np.testing.assert_array_equal(t_levels.compute_reverse_levels(Lt),
                                  j_levels.compute_reverse_levels(Lj))
    np.testing.assert_array_equal(t_levels.compute_reverse_levels(Lt, ft),
                                  j_levels.compute_reverse_levels(Lj, fj))
    np.testing.assert_array_equal(t_levels.compute_upper_levels(Lt.transpose()),
                                  j_levels.compute_upper_levels(Lj.transpose()))
    assert_same(t_levels.build_reverse_level_sets(Lt, forward=ft),
                j_levels.build_reverse_level_sets(Lj, forward=fj))
    np.testing.assert_array_equal(ft.row_permutation(), fj.row_permutation())
    assert ft.histogram() == fj.histogram()


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("name", NAMES)
def test_analysis_matches(name, transpose):
    sj, st, lj, lt = _systems(name, transpose)
    a = j_analysis.analyze(sj, lj, upper=transpose)
    b = t_analysis.analyze(st, lt, upper=transpose)
    assert b.report() == a.report()
    assert_same(b, a)


@pytest.mark.parametrize("coarsen", [False, True])
@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("name", NAMES)
def test_schedule_matches(name, transpose, coarsen):
    a, b = _schedules(name, transpose, coarsen)
    assert_same(b, a)
    np.testing.assert_array_equal(b.perm(), a.perm())
    np.testing.assert_array_equal(b.row_offsets(), a.row_offsets())
    assert b.padded_flops() == a.padded_flops()
    assert b.padded_flops(4) == a.padded_flops(4)
    assert (b.num_segments, b.total_depth) == (a.num_segments, a.total_depth)


@pytest.mark.parametrize("transpose", [False, True])
def test_bucketed_schedule_and_coarsen_stats_match(transpose):
    a, b = _schedules("lung2", transpose, False, bucket=2.0)
    assert_same(b, a)
    cj = j_coarsen.coarsen_schedule(a)
    ct = t_coarsen.coarsen_schedule(b)
    assert_same(ct, cj)
    assert_same(t_coarsen.coarsen_stats(b, ct), j_coarsen.coarsen_stats(a, cj))
    assert t_coarsen.coarsen_stats(b, ct).summary() == \
        j_coarsen.coarsen_stats(a, cj).summary()


@pytest.mark.parametrize("coarsen", [False, True])
@pytest.mark.parametrize("name", ["lung2", "chain"])
def test_stack_sub_slabs_match(name, coarsen):
    a, b = _schedules(name, False, coarsen)
    for sa, sb in zip(a.slabs, b.slabs):
        assert_same(t_codegen.stack_sub_slabs(sb, b.n, with_src=True),
                    j_codegen.stack_sub_slabs(sa, a.n, with_src=True))


@pytest.mark.parametrize("coarsen", [False, True])
@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("name", NAMES)
def test_packed_layout_matches(name, transpose, coarsen):
    a, b = _schedules(name, transpose, coarsen)
    pa, pb = j_packed.build_packed_layout(a), t_packed.build_packed_layout(b)
    assert_same(pb, pa)
    assert_same(pb.stats(), pa.stats())
    # the level kernel's row padding (the segment geometry it launches on)
    _, _, _, la = j_level_ops.make_packed_solver(a, backend="interpret")
    _, _, _, lb = t_level_ops.make_packed_solver(b, device="cpu")
    assert_same(lb, la)
    # refresh re-pack
    sj, _, _, _ = _systems(name, transpose)
    data = np.random.default_rng(7).standard_normal(sj.nnz)
    assert_same(t_packed.pack_values(lb, data), j_packed.pack_values(la, data))


@pytest.mark.parametrize("coarsen", [False, True])
@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("name", NAMES)
def test_fused_layout_matches(name, transpose, coarsen):
    a, b = _schedules(name, transpose, coarsen)
    fa, fb = j_fused_ops.build_layout(a), t_fused_ops.build_layout(b)
    assert_same(fb, fa)
    assert fb.spans and fb.padded_flops == fa.padded_flops
    # spans tile the permuted space in order
    offs = np.array(fb.spans)
    np.testing.assert_array_equal(offs[1:, 0], np.cumsum(offs[:, 1])[:-1])
    assert offs[:, 1].sum() == fb.n_pad


@pytest.mark.parametrize("name", NAMES)
def test_build_ell_matches(name):
    Lj = jax_matrix(name)
    assert_same(t_codegen.build_ell(to_port(Lj)), j_codegen.build_ell(Lj))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("kind", sorted(jsparse.PATHOLOGICAL_PATTERNS))
def test_pathological_patterns_match(kind, dtype):
    """The pathological generators, and every symbolic artifact built on
    them (levels, analysis, schedules coarsened or not, packed layouts),
    both directions."""
    a = jsparse.pathological(kind, n=96, seed=4, dtype=dtype)
    b = tsparse.pathological(kind, n=96, seed=4, dtype=dtype)
    assert_same(b, a)
    assert tsparse.diag_condition(b) == jsparse.diag_condition(a)
    assert sorted(tsparse.PATHOLOGICAL_PATTERNS) == \
        sorted(jsparse.PATHOLOGICAL_PATTERNS)
    for transpose in (False, True):
        if transpose:
            sj, st = a.transpose(), b.transpose()
            lj, lt = (j_levels.build_reverse_level_sets(a),
                      t_levels.build_reverse_level_sets(b))
        else:
            sj, st = a, b
            lj, lt = j_levels.build_level_sets(a), t_levels.build_level_sets(b)
        assert_same(lt, lj)
        assert t_analysis.analyze(st, lt, upper=transpose).report() == \
            j_analysis.analyze(sj, lj, upper=transpose).report()
        sched_j = j_codegen.build_schedule(sj, lj, upper=transpose)
        sched_t = t_codegen.build_schedule(st, lt, upper=transpose)
        assert_same(sched_t, sched_j)
        co_j = j_coarsen.coarsen_schedule(sched_j, j_coarsen.CoarsenConfig())
        co_t = t_coarsen.coarsen_schedule(sched_t, t_coarsen.CoarsenConfig())
        assert_same(co_t, co_j)
        assert_same(t_packed.build_packed_layout(co_t),
                    j_packed.build_packed_layout(co_j))
