"""The port's ``SolveService`` (on ``device="cpu"``) against the JAX
package's: the reference's service tests (``tests/test_solve_service.
py``) — shared factors and batches across tenants, refresh visibility,
re-admission after eviction, per-tenant breakdown isolation, transpose
routing, the mixed traffic against a dense oracle, validation — the
``serve_traffic`` stream array for array, every counter of the two
services on the same stream with ``background=False`` and answers to
1e-12, and ``LatencyHistogram`` summaries on the same samples."""
import math

import numpy as np
import pytest

from repro.compat import enable_x64
from repro.core import GuardConfig as JaxGuardConfig
from repro.serve import LatencyHistogram as JaxLatencyHistogram
from repro.serve import SolveService as JaxSolveService
import repro.sparse as jsparse

from repro_torch.core import (CSRMatrix, GuardBreakdownError, GuardConfig)
from repro_torch.serve import LatencyHistogram, SolveService, SolverRegistry
from repro_torch.sparse import random_lower, refresh_values, serve_traffic

from _torch_parity import to_port


def _dense_solve(L, b, transpose=False):
    A = L.to_dense()
    return np.linalg.solve(A.T if transpose else A, b)


def _revalued(L, seed):
    return CSRMatrix(L.indptr, L.indices, refresh_values(L, seed=seed),
                     L.shape)


def _service(**kw):
    return SolveService(device="cpu", **kw)


def test_tenants_sharing_pattern_share_factor_and_batch():
    L = random_lower(64, seed=0)
    svc = _service(strategy="levelset", background=False)
    ka = svc.register("a", L)
    kb = svc.register("b", _revalued(L, seed=5))  # same pattern: hit
    assert ka == kb
    assert (svc.registry.misses, svc.registry.hits) == (1, 1)
    # b's registration refreshed the shared values — both tenants now
    # solve against b's factor (the documented sharing semantics)
    L_now = _revalued(L, seed=5)
    rng = np.random.default_rng(1)
    ba, bb = rng.standard_normal(L.n), rng.standard_normal(L.n)
    ra, rb = svc.submit("a", ba), svc.submit("b", bb)
    done = svc.step()          # ONE drained batch answers both tenants
    assert done == 2 and svc.batches_completed == 1
    np.testing.assert_allclose(ra.x, _dense_solve(L_now, ba), rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(rb.x, _dense_solve(L_now, bb), rtol=1e-10,
                               atol=1e-12)
    st = svc.stats()
    assert st["completed"] == 2 and st["failed"] == 0
    assert st["per_tenant"]["a"]["completed"] == 1


def test_refresh_visible_across_tenants_and_counted():
    L = random_lower(56, seed=2)
    svc = _service(strategy="levelset", background=False)
    svc.register("a", L)
    svc.register("b", L)
    new_vals = refresh_values(L, seed=9)
    svc.refresh("a", new_vals)
    b = np.random.default_rng(3).standard_normal(L.n)
    req = svc.submit("b", b)
    svc.run()
    L2 = CSRMatrix(L.indptr, L.indices, new_vals, L.shape)
    np.testing.assert_allclose(req.x, _dense_solve(L2, b), rtol=1e-10,
                               atol=1e-12)
    st = svc.stats()
    assert st["per_tenant"]["a"]["refreshes"] == 1
    assert st["per_tenant"]["b"]["refreshes"] == 0


def test_evicted_tenant_readmitted_on_submit():
    La, Lb = random_lower(48, seed=4), random_lower(48, seed=5)
    svc = _service(strategy="serial", background=False, max_entries=1)
    svc.register("a", La)
    svc.register("b", Lb)                 # evicts a's entry
    assert svc.registry.evictions == 1
    b = np.random.default_rng(6).standard_normal(La.n)
    req = svc.submit("a", b)              # transparent re-admission
    svc.run()
    assert svc.registry.misses == 3
    np.testing.assert_allclose(req.x, _dense_solve(La, b), rtol=1e-10,
                               atol=1e-12)


def test_breakdown_isolated_per_tenant():
    """One tenant's GuardBreakdownError must not poison a co-batched
    neighbour from another tenant."""
    L = random_lower(64, seed=7)
    svc = _service(strategy="levelset", background=False,
                   guard=GuardConfig(on_breakdown="raise"))
    svc.register("good", L)
    svc.register("bad", L)
    rng = np.random.default_rng(8)
    b_good = rng.standard_normal(L.n)
    b_bad = rng.standard_normal(L.n)
    b_bad[L.n // 2] = np.nan
    r_good = svc.submit("good", b_good)
    r_bad = svc.submit("bad", b_bad)
    done = svc.step()
    assert done == 2
    assert r_good.done and r_good.error is None
    np.testing.assert_allclose(r_good.x, _dense_solve(L, b_good), rtol=1e-10,
                               atol=1e-12)
    assert r_bad.done and isinstance(r_bad.error, GuardBreakdownError)
    assert r_bad.x is None
    st = svc.stats()
    assert st["per_tenant"]["good"] == dict(
        st["per_tenant"]["good"], completed=1, failed=0)
    assert st["per_tenant"]["bad"] == dict(
        st["per_tenant"]["bad"], completed=0, failed=1)
    assert st["completed"] == 1 and st["failed"] == 1


def test_transpose_requests_route_to_backward_solver():
    L = random_lower(56, seed=9)
    svc = _service(strategy="levelset", background=False)
    svc.register("t", L)
    b = np.random.default_rng(10).standard_normal(L.n)
    req = svc.submit("t", b, transpose=True)
    svc.run()
    np.testing.assert_allclose(req.x, _dense_solve(L, b, transpose=True),
                               rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("strategy", ["levelset", "pallas_level",
                                      "pallas_fused", "serial"])
def test_mixed_traffic_drains_with_oracle_answers(strategy):
    """The shared deterministic workload end to end (inline builds), every
    solve against the dense oracle for the values in effect when it was
    submitted — checked after the whole stream, so no answer may share
    memory with a later solve's."""
    patterns, events = serve_traffic(num_patterns=2, num_tenants=3,
                                     num_events=40, n=48, seed=13)
    svc = _service(strategy=strategy, background=False, max_batch=8)
    current = {}                     # tenant -> dense factor snapshot
    shared_key = {}                  # tenant -> registry key
    expected = []
    for ev in events:
        t = ev["tenant"]
        if ev["op"] == "register":
            key = svc.register(t, ev["matrix"])
            dense = ev["matrix"].to_dense()
            shared_key[t] = key
            for other, k in shared_key.items():
                if k == key:
                    current[other] = dense
        elif ev["op"] == "refresh":
            svc.refresh(t, ev["values"])
            dense = svc.registry.lookup(shared_key[t]).pattern.to_dense()
            for other, k in shared_key.items():
                if k == shared_key[t]:
                    current[other] = dense
        else:
            req = svc.submit(t, ev["b"], transpose=ev["transpose"])
            A = current[t].T if ev["transpose"] else current[t]
            expected.append((req, np.linalg.solve(A, ev["b"])))
            svc.step()
    svc.run()
    st = svc.stats()
    assert st["queue_depth"] == 0 and st["failed"] == 0
    assert st["completed"] == len(expected) > 0
    for req, x_ref in expected:
        np.testing.assert_allclose(req.x, x_ref, rtol=1e-9, atol=1e-11)
    assert st["solve_latency"]["count"] == svc.batches_completed > 0


def test_service_validates_tenancy_and_construction():
    svc = _service(strategy="serial", background=False)
    with pytest.raises(ValueError, match="no registered factor"):
        svc.submit("ghost", np.zeros(4))
    with pytest.raises(ValueError, match="no registered factor"):
        svc.refresh("ghost", np.zeros(4))
    with pytest.raises(ValueError, match="not both"):
        SolveService(registry=SolverRegistry(device="cpu"), strategy="serial")


# --------------------------------------------------------------------------
# parity with the JAX package
# --------------------------------------------------------------------------
TRAFFIC = [dict(num_patterns=3, num_tenants=4, num_events=60, n=40, seed=7),
           dict(num_patterns=2, num_tenants=3, num_events=40, n=48, seed=13,
                dtype=np.float32)]


@pytest.mark.parametrize("kw", TRAFFIC, ids=["f64", "f32"])
def test_serve_traffic_equals_jax(kw):
    pj, ej = jsparse.serve_traffic(**kw)
    pt, et = serve_traffic(**kw)
    assert len(pj) == len(pt) and len(ej) == len(et)
    for a, b in zip(pj, pt):
        for f in ("indptr", "indices", "data"):
            x, y = np.asarray(getattr(a, f)), getattr(b, f)
            assert x.dtype == y.dtype and np.array_equal(x, y)
    for a, b in zip(ej, et):
        assert sorted(a) == sorted(b)
        for k, v in a.items():
            w = b[k]
            if k == "matrix":
                for f in ("indptr", "indices", "data"):
                    assert np.array_equal(np.asarray(getattr(v, f)),
                                          getattr(w, f))
                assert v.dtype == w.dtype
            elif isinstance(v, np.ndarray):
                assert v.dtype == w.dtype and np.array_equal(v, w)
            else:
                assert v == w


def _drive(svc, events, port: bool):
    reqs = []
    for ev in events:
        if ev["op"] == "register":
            m = ev["matrix"]
            svc.register(ev["tenant"], to_port(m) if port else m)
        elif ev["op"] == "refresh":
            svc.refresh(ev["tenant"], ev["values"])
        else:
            reqs.append(svc.submit(ev["tenant"], ev["b"],
                                   transpose=ev["transpose"]))
        svc.step()
    svc.run()
    return reqs


def _counters(st):
    st = dict(st)
    st.pop("solve_latency")
    reg = dict(st.pop("registry"))
    for k in ("cold_build", "planned_build"):
        reg[k] = reg[k]["count"]
    reg["per_entry"] = {
        k: {f: v for f, v in e.items()
            if f not in ("cold_build_s", "planned_build_s", "packed_bytes")}
        for k, e in reg["per_entry"].items()}
    return st, reg


@pytest.mark.parametrize("strategy", ["levelset", "serial"])
def test_service_counters_and_answers_equal_jax(strategy):
    """The same ``serve_traffic`` stream (with a byte budget that evicts,
    and a guarded build so one poisoned RHS fails) through both services
    with ``background=False``: every per-tenant, service and registry
    counter equal, every answer to 1e-12."""
    kw = dict(num_patterns=3, num_tenants=4, num_events=60, n=40, seed=7)
    with enable_x64():
        pj, events = jsparse.serve_traffic(**kw)
        solves = [i for i, ev in enumerate(events) if ev["op"] == "solve"]
        bad = dict(events[solves[5]])
        bad["b"] = bad["b"].copy()
        bad["b"][3] = np.nan
        events[solves[5]] = bad
        common = dict(strategy=strategy, background=False, max_entries=2,
                      max_batch=8)
        ref = JaxSolveService(guard=JaxGuardConfig(on_breakdown="raise"),
                              **common)
        svc = _service(guard=GuardConfig(on_breakdown="raise"), **common)
        rj = _drive(ref, events, port=False)
        rt = _drive(svc, events, port=True)
        sj, st = ref.stats(), svc.stats()
    assert _counters(st) == _counters(sj)
    assert st["failed"] == 1 and st["registry"]["evictions"] >= 1
    assert st["solve_latency"]["count"] == sj["solve_latency"]["count"]
    for a, b in zip(rt, rj):
        assert (a.error is None) == (b.error is None)
        if b.error is None:
            np.testing.assert_allclose(a.x, np.asarray(b.x), rtol=1e-12,
                                       atol=1e-12)


def test_latency_histogram_summaries_equal_jax():
    rng = np.random.default_rng(0)
    samples = np.concatenate([rng.lognormal(-7, 2, 500), [0.0, 1e-9, 70.0]])
    for kw in ({}, dict(lo_exp=-10, hi_exp=2)):
        a, b = LatencyHistogram(**kw), JaxLatencyHistogram(**kw)
        assert a.summary() == b.summary()            # empty
        for s in samples:
            a.record(s)
            b.record(s)
        assert a.summary() == b.summary()
        assert a.counts == b.counts
        for q in (0.0, 0.25, 0.5, 0.9, 0.999, 1.0):
            assert a.quantile(q) == b.quantile(q)
    for bad in (-1.0, math.nan, math.inf):
        with pytest.raises(ValueError):
            LatencyHistogram().record(bad)
    with pytest.raises(ValueError):
        LatencyHistogram(lo_exp=3, hi_exp=3)
