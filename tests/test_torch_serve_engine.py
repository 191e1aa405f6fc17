"""The port's ``SolveEngine`` (on ``device="cpu"``) against the JAX
package's: the reference's serving regressions (``tests/test_serve_
regressions.py``) — drain before refresh, a mixed-dtype request, failed
requests counted as failed, the ``ValueError`` checks, consistent batch
counts in the fallback — the same request stream through both engines
(answers and counters), and the port's own routing: a bucket of width 1
solves an ``(n,)`` vector, and a kernel fault is not isolated as a
request's failure."""
import numpy as np
import pytest
import torch

from repro.compat import enable_x64
from repro.core import GuardConfig as JaxGuardConfig
from repro.core import SpTRSV as JaxSpTRSV
from repro.serve import SolveEngine as JaxSolveEngine
import repro.sparse as jsparse

from repro_torch.core import (CSRMatrix, GuardBreakdownError, GuardConfig,
                              SpTRSV)
from repro_torch.kernels.cuda_common import KernelLaunchError
from repro_torch.serve import SolveEngine, SolveRequest
from repro_torch.sparse import chain_matrix, random_lower

from _torch_parity import to_port

# answers of the two engines on the same stream
ENGINE_TOL = {np.float64: dict(rtol=1e-12, atol=1e-12),
              np.float32: dict(rtol=1e-5, atol=1e-5)}


def _regen_values(L, seed):
    rng = np.random.default_rng(seed)
    data = rng.normal(size=L.nnz).astype(L.dtype)
    diag_mask = np.zeros(L.nnz, bool)
    for i in range(L.n):  # keep the factor well-conditioned
        diag_mask[L.indptr[i + 1] - 1] = True
    data[diag_mask] = np.abs(data[diag_mask]) + 1.0
    return data


def _solve(s, b):
    return s.solve(torch.from_numpy(np.asarray(b))).numpy()


def test_refresh_drains_queue_before_value_swap():
    L = chain_matrix(80, dtype=np.float64)
    eng = SolveEngine.from_matrix(L, strategy="levelset", transpose_too=False,
                                  max_batch=8, device="cpu")
    rng = np.random.default_rng(3)
    b = rng.normal(size=L.n)
    # submit against the ORIGINAL factor, then refresh without running
    inflight = eng.submit(b)
    data2 = _regen_values(L, seed=9)
    eng.refresh(data2)
    # the drain inside refresh answered the in-flight request against the
    # old values
    assert inflight.done
    old = SpTRSV.build(L, strategy="levelset", device="cpu")
    np.testing.assert_allclose(inflight.x, _solve(old, b), rtol=1e-12,
                               atol=1e-12)
    # a post-refresh submit is answered with the NEW values
    after = eng.submit(b)
    eng.run()
    new = SpTRSV.build(CSRMatrix(L.indptr, L.indices, data2, L.shape),
                       strategy="levelset", device="cpu")
    np.testing.assert_allclose(after.x, _solve(new, b), rtol=1e-12,
                               atol=1e-12)
    # and the two factors genuinely differ, or the test proves nothing
    assert not np.allclose(inflight.x, after.x)


def test_mixed_dtype_request_solved_at_solver_dtype():
    """A float64 request in an f32 engine's bucket is solved at the
    solver's dtype (the batch buffer is allocated at ``solver.dtype``)."""
    L = chain_matrix(64, dtype=np.float32)
    s = SpTRSV.build(L, strategy="levelset", device="cpu")
    eng = SolveEngine(s, max_batch=4)
    rng = np.random.default_rng(5)
    f32_reqs = [eng.submit(rng.normal(size=L.n).astype(np.float32))
                for _ in range(4)]
    assert eng.run() == 4
    dtypes = []
    inner = s.solve
    s.solve = lambda b: (dtypes.append(b.dtype), inner(b))[1]
    mixed = [eng.submit(rng.normal(size=L.n).astype(np.float64))
             for _ in range(4)]
    assert eng.run() == 4
    assert dtypes == [torch.float32]
    for r in f32_reqs + mixed:
        assert r.done
        assert r.x.dtype == np.float32
        np.testing.assert_allclose(r.x, _solve(s, r.b.astype(np.float32)),
                                   rtol=1e-6, atol=1e-6)


def _guarded_engine(n=48, seed=1, strategy="levelset", max_batch=8):
    L = random_lower(n, seed=seed)
    s = SpTRSV.build(L, strategy=strategy, device="cpu",
                     guard=GuardConfig(on_breakdown="raise"))
    return L, SolveEngine(s, max_batch=max_batch)


def test_failed_requests_counted_as_failed_not_solved():
    L, eng = _guarded_engine()
    rng = np.random.default_rng(2)
    good = [eng.submit(rng.standard_normal(L.n)) for _ in range(3)]
    bad_b = rng.standard_normal(L.n)
    bad_b[0] = np.nan
    bad = eng.submit(bad_b)
    assert eng.step() == 4
    assert (eng.solved, eng.failed) == (3, 1)
    st = eng.stats()
    assert (st["solved"], st["failed"]) == (3, 1)
    assert isinstance(bad.error, GuardBreakdownError) and bad.x is None
    for r in good:
        assert r.error is None and r.x is not None


def test_engine_validation_raises_value_errors():
    L = chain_matrix(16)
    s = SpTRSV.build(L, strategy="serial", device="cpu")
    other = SpTRSV.build(chain_matrix(8), strategy="serial", device="cpu")
    with pytest.raises(ValueError, match="max_batch"):
        SolveEngine(s, max_batch=0)
    with pytest.raises(ValueError, match="must share one factor"):
        SolveEngine(s, other)
    eng = SolveEngine(s)   # no transpose solver
    with pytest.raises(ValueError, match=r"\(16,\)"):
        eng.submit(np.zeros(17))
    with pytest.raises(ValueError, match=r"\(16,\)"):
        eng.submit(np.zeros((16, 1)))
    with pytest.raises(ValueError, match="transpose"):
        eng.submit(np.zeros(16), transpose=True)
    with pytest.raises(ValueError, match="promoted solver solves"):
        eng.swap_solvers(other)
    with pytest.raises(ValueError, match="no transpose solver"):
        SolveEngine(s, s).swap_solvers(s)


def test_fallback_counts_batches_consistently():
    """3 requests, one bad: 1 failed batched attempt + 3 width-1 re-solves
    = 4 executor dispatches, and exactly the culprit carries the error."""
    L, eng = _guarded_engine()
    rng = np.random.default_rng(3)
    reqs = [eng.submit(rng.standard_normal(L.n)) for _ in range(2)]
    bad_b = rng.standard_normal(L.n)
    bad_b[5] = np.inf
    bad = eng.submit(bad_b)
    assert eng.batches == 0
    assert eng.step() == 3
    assert eng.batches == 4
    assert (eng.solved, eng.failed) == (2, 1)
    assert isinstance(bad.error, GuardBreakdownError)
    for r in reqs:
        assert r.error is None and r.x is not None
    # a clean follow-up batch adds exactly one dispatch
    eng.submit(rng.standard_normal(L.n))
    eng.run()
    assert eng.batches == 5 and eng.solved == 3


def _record_shapes(solver):
    shapes = []
    inner = solver.solve

    def solve(b):
        shapes.append(tuple(b.shape))
        return inner(b)

    solver.solve = solve
    return shapes


def test_width1_bucket_solves_a_vector():
    """A lone request and every per-request re-solve of the fallback reach
    ``solver.solve`` as an ``(n,)`` vector at the solver's dtype — the
    shape that reaches the single-RHS kernels on the card; wider buckets
    as ``(n, m)``."""
    L, eng = _guarded_engine()
    shapes = _record_shapes(eng.solver)
    rng = np.random.default_rng(4)
    lone = eng.submit(rng.standard_normal(L.n).astype(np.float32))
    assert eng.run() == 1
    assert shapes == [(L.n,)]
    assert lone.x.shape == (L.n,) and lone.x.dtype == np.float64
    for _ in range(3):
        eng.submit(rng.standard_normal(L.n))
    assert eng.run() == 3
    assert shapes[1:] == [(L.n, 4)]
    # a failing 4-wide batch: one (n, 4) attempt, then 4 vector re-solves
    bad_b = rng.standard_normal(L.n)
    bad_b[0] = np.nan
    eng.submit(bad_b)
    for _ in range(3):
        eng.submit(rng.standard_normal(L.n))
    del shapes[:]
    assert eng.step() == 4
    assert shapes == [(L.n, 4)] + [(L.n,)] * 4
    assert (eng.solved, eng.failed) == (4 + 3, 1)


@pytest.mark.parametrize("where", ["batch", "fallback"])
def test_kernel_launch_error_propagates_out_of_step(where):
    """A kernel fault is the card's, not a request's: ``step`` re-raises
    it instead of storing it on the requests, whether the batched solve or
    a per-request re-solve of the fallback hit it."""
    L = chain_matrix(32)
    s = SpTRSV.build(L, strategy="levelset", device="cpu")
    eng = SolveEngine(s, max_batch=4)
    calls = []

    def faulty(b):
        calls.append(tuple(b.shape))
        if where == "fallback" and b.dim() == 2:
            raise ValueError("one bad column")
        raise KernelLaunchError("sptrsv_fused: CUDA launch failed with error 719")

    s.solve = faulty
    reqs = [eng.submit(np.ones(L.n)) for _ in range(2)]
    with pytest.raises(KernelLaunchError):
        eng.step()
    assert calls == ([(L.n, 2)] if where == "batch" else [(L.n, 2), (L.n,)])
    assert all(r.error is None and not r.done for r in reqs)
    assert issubclass(KernelLaunchError, RuntimeError)


def _stream(n, dtype, seed):
    """Requests of mixed direction and a batch structure that exercises
    every bucket width up to 8, one width-1 step and a failing RHS."""
    rng = np.random.default_rng(seed)
    widths = [1, 3, 8, 5, 2]
    batches = []
    for w in widths:
        batch = []
        for _ in range(w):
            b = rng.standard_normal(n).astype(dtype)
            batch.append((b, bool(rng.random() < 0.4)))
        batches.append(batch)
    bad = batches[2][4][0].copy()
    bad[n // 3] = np.nan
    batches[2][4] = (bad, batches[2][4][1])
    return batches


@pytest.mark.parametrize("dtype", [np.float64, np.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("strategy", ["levelset", "pallas_level",
                                      "pallas_fused", "serial"])
def test_engine_matches_jax_engine(strategy, dtype):
    """The same request stream through the JAX engine (``levelset``: the
    JAX fused build fails, ROADMAP C-ref 1) and the port's, guarded with
    ``on_breakdown="raise"``: equal ``solved`` / ``failed`` / ``batches``
    after each step, the same failed request, answers to 1e-12 (f64) /
    1e-5 (f32)."""
    Lj = jsparse.random_lower(n=96, seed=11, dtype=dtype)
    batches = _stream(Lj.n, dtype, seed=12)
    with enable_x64(dtype == np.float64):
        fj, bj = JaxSpTRSV.build_pair(
            Lj, strategy="serial" if strategy == "serial" else "levelset",
            guard=JaxGuardConfig(on_breakdown="raise"))
        ej = JaxSolveEngine(fj, bj, max_batch=8)
        et = SolveEngine.from_matrix(
            to_port(Lj), strategy=strategy, max_batch=8, device="cpu",
            guard=GuardConfig(on_breakdown="raise"))
        for batch in batches:
            rj = [ej.submit(b, transpose=t) for b, t in batch]
            rt = [et.submit(b, transpose=t) for b, t in batch]
            assert et.step() == ej.step() == len(batch)
            assert ((et.solved, et.failed, et.batches)
                    == (ej.solved, ej.failed, ej.batches))
            for a, b in zip(rt, rj):
                assert a.done and b.done
                assert (a.error is None) == (b.error is None)
                if b.error is None:
                    assert a.x.dtype == np.asarray(b.x).dtype
                    np.testing.assert_allclose(a.x, np.asarray(b.x),
                                               **ENGINE_TOL[dtype])
                else:
                    assert isinstance(a.error, GuardBreakdownError)
    assert et.failed == 1 and et.solved == sum(map(len, batches)) - 1
    st = et.stats()
    assert st["forward"]["strategy"] == strategy
    assert (st["solved"], st["failed"], st["batches"]) == (
        et.solved, et.failed, et.batches)


def test_solve_request_fields_match_reference():
    from repro.serve import SolveRequest as JaxSolveRequest
    import dataclasses
    assert ([f.name for f in dataclasses.fields(SolveRequest)]
            == [f.name for f in dataclasses.fields(JaxSolveRequest)])
