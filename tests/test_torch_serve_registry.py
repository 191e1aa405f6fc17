"""The port's ``SolverRegistry`` (on ``device="cpu"``) against the JAX
package's: the reference's registry tests (``tests/test_serve_registry.
py``) — keying by pattern and dtype, a hit refreshes, LRU and byte-budget
eviction, a refresh during an in-flight build re-applied, a failed build
keeps serving cold, an evicted entry discards its build, the shape of
``stats()`` — equal ``pattern_key`` strings, equal hit / miss / promotion /
eviction counts on the same admissions, and the dtype of a pair built on
the background thread (the JAX registry re-applies ``enable_x64`` there;
torch has no such switch)."""
import threading

import numpy as np
import pytest
import torch

from repro.compat import enable_x64
from repro.core import CSRMatrix as JaxCSR
from repro.serve import SolverRegistry as JaxSolverRegistry
from repro.serve import pattern_key as jax_pattern_key
import repro.sparse as jsparse

from repro_torch.core import CSRMatrix
from repro_torch.serve import SolverRegistry, pattern_key
from repro_torch.sparse import random_lower, refresh_values

from _torch_parity import to_port

WAIT = 60   # seconds: every wait of this file fails instead of hanging


def _dense_solve(L, b):
    return np.linalg.solve(L.to_dense(), b)


def _revalued(L, seed):
    return CSRMatrix(L.indptr, L.indices, refresh_values(L, seed=seed),
                     L.shape)


def _registry(**kw):
    return SolverRegistry(device="cpu", **kw)


# --------------------------------------------------------------------------
# keying: pattern + dtype
# --------------------------------------------------------------------------
def test_pattern_key_ignores_values_but_not_dtype():
    L = random_lower(48, seed=0)
    same_pattern = _revalued(L, seed=9)
    other_pattern = random_lower(48, seed=1)
    f32 = CSRMatrix(L.indptr, L.indices, L.data.astype(np.float32), L.shape)
    assert pattern_key(L) == pattern_key(same_pattern)
    assert pattern_key(L) != pattern_key(other_pattern)
    assert pattern_key(L) != pattern_key(f32)


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pattern_key_equals_jax(seed, dtype):
    Lj = jsparse.random_lower(n=64, seed=seed, dtype=dtype)
    assert pattern_key(to_port(Lj)) == jax_pattern_key(Lj)


def test_hit_refreshes_values_onto_resident_pair():
    L = random_lower(64, seed=2)
    reg = _registry(strategy="levelset", background=False)
    e1 = reg.get(L)
    L2 = _revalued(L, seed=11)
    e2 = reg.get(L2)
    assert e2 is e1
    assert (reg.hits, reg.misses) == (1, 1)
    assert e1.value_refreshes == 1
    b = np.random.default_rng(3).standard_normal(L.n)
    req = e1.engine.submit(b)
    e1.engine.run()
    np.testing.assert_allclose(req.x, _dense_solve(L2, b), rtol=1e-10,
                               atol=1e-12)
    # bit-identical values → refresh skipped (cheap no-op hit)
    e3 = reg.get(L2)
    assert e3 is e1 and e1.value_refreshes == 1


# --------------------------------------------------------------------------
# LRU + byte-budget eviction
# --------------------------------------------------------------------------
def test_lru_eviction_order_and_touch_protection():
    mats = [random_lower(48, seed=s) for s in range(3)]
    reg = _registry(strategy="serial", background=False, max_entries=2)
    e0, e1 = reg.get(mats[0]), reg.get(mats[1])
    # touch mats[0] so mats[1] becomes LRU
    assert reg.get(mats[0]) is e0
    reg.get(mats[2])
    assert reg.evictions == 1
    assert e1.evicted and not e0.evicted
    assert reg.keys() == [pattern_key(mats[0]), pattern_key(mats[2])]
    # the evicted pattern re-admits as a fresh miss
    e1b = reg.get(mats[1])
    assert e1b is not e1 and reg.misses == 4


def test_byte_budget_enforced_on_admission():
    mats = [random_lower(64, seed=10 + s) for s in range(3)]
    probe = _registry(strategy="serial", background=False)
    entry_bytes = probe.get(mats[0]).packed_bytes
    assert entry_bytes > 0
    # room for two entries, not three
    reg = _registry(strategy="serial", background=False,
                    max_bytes=int(entry_bytes * 2.5))
    for m in mats:
        reg.get(m)
        assert reg.resident_bytes() <= reg.max_bytes
    assert reg.evictions == 1
    assert reg.keys() == [pattern_key(mats[1]), pattern_key(mats[2])]


def test_eviction_skips_entries_with_queued_requests():
    mats = [random_lower(48, seed=20 + s) for s in range(2)]
    reg = _registry(strategy="serial", background=False, max_entries=1)
    e0 = reg.get(mats[0])
    rng = np.random.default_rng(0)
    req = e0.engine.submit(rng.standard_normal(mats[0].n))
    # e0 is LRU but has queued work — admission must defer, not evict
    reg.get(mats[1])
    assert reg.evictions == 0 and len(reg.keys()) == 2
    e0.engine.run()
    assert req.done
    # once drained, the next admission evicts down to the budget
    m3 = random_lower(48, seed=30)
    reg.get(m3)
    assert reg.evictions == 2
    assert reg.keys() == [pattern_key(m3)]


# --------------------------------------------------------------------------
# cold serial pair vs promoted planned pair
# --------------------------------------------------------------------------
def test_cold_answers_match_promoted_vs_numpy_oracle():
    """The gate pins 'answered while cold' as a fact, not a race; the
    promoted pair must then agree with both the cold answer and the dense
    oracle at f64 tightness."""
    L = random_lower(96, seed=4)
    gate = threading.Event()
    reg = _registry(strategy="levelset", background=True, build_gate=gate)
    entry = reg.get(L)
    b = np.random.default_rng(7).standard_normal(L.n)
    req_cold = entry.engine.submit(b)
    entry.engine.run()
    assert req_cold.done and entry.state == "cold"
    assert entry.engine.solver.strategy == "serial"
    oracle = _dense_solve(L, b)
    np.testing.assert_allclose(req_cold.x, oracle, rtol=1e-10, atol=1e-12)
    gate.set()
    assert entry.wait_ready(timeout=WAIT)
    assert entry.state == "ready" and entry.build_error is None
    assert entry.engine.solver.strategy == "levelset"
    assert entry.cold_completed == 1
    req_warm = entry.engine.submit(b)
    entry.engine.run()
    np.testing.assert_allclose(req_warm.x, oracle, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(req_warm.x, req_cold.x, rtol=1e-12,
                               atol=1e-13)
    assert reg.wait_idle(timeout=WAIT)


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
def test_background_build_keeps_the_factor_dtype(dtype):
    """The regression the JAX registry's ``enable_x64`` hand-off guards: a
    pair built on the background worker packs the factor's dtype — f64
    stays f64 (answers at f64 tightness), f32 stays f32."""
    L = random_lower(80, seed=14, dtype=dtype)
    reg = _registry(strategy="levelset", background=True)
    entry = reg.get(L)
    assert entry.wait_ready(timeout=WAIT) and entry.build_error is None
    assert entry.state == "ready"
    for s in (entry.engine.solver, entry.engine.solver_t):
        assert s.strategy == "levelset" and s.dtype == dtype
        assert all(v.dtype == torch.from_numpy(np.zeros(1, dtype)).dtype
                   for v in s._values)
    b = np.random.default_rng(8).standard_normal(L.n)
    req = entry.engine.submit(b)
    entry.engine.run()
    assert req.x.dtype == dtype
    tol = dict(rtol=1e-10, atol=1e-12) if dtype == np.float64 else \
        dict(rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(req.x, _dense_solve(L.astype(np.float64), b),
                               **tol)
    assert reg.wait_idle(timeout=WAIT)


def test_refresh_during_inflight_build_reapplied_before_promotion():
    """Values refreshed while the planned build is in flight are
    re-applied to the built pair before the swap — promotion never
    resurrects the admission-time numerics."""
    L = random_lower(72, seed=5)
    reg = _registry(strategy="levelset", background=True)
    started, proceed = threading.Event(), threading.Event()
    inner = reg._build_planned

    def stalled(snapshot):
        started.set()
        assert proceed.wait(timeout=WAIT)
        return inner(snapshot)

    reg._build_planned = stalled
    entry = reg.get(L)
    assert started.wait(timeout=WAIT)
    # the build snapshotted L's values; move them while it runs
    L2 = _revalued(L, seed=41)
    assert reg.get(L2) is entry    # hit → refresh, version bump
    proceed.set()
    assert entry.wait_ready(timeout=WAIT)
    assert entry.state == "ready" and entry.build_error is None
    b = np.random.default_rng(9).standard_normal(L.n)
    req = entry.engine.submit(b)
    entry.engine.run()
    np.testing.assert_allclose(req.x, _dense_solve(L2, b), rtol=1e-10,
                               atol=1e-12)
    assert reg.wait_idle(timeout=WAIT)


def test_failed_planned_build_keeps_serving_cold():
    L = random_lower(48, seed=6)
    reg = _registry(strategy="levelset", background=True)

    def boom(snapshot):
        raise RuntimeError("planner exploded")

    reg._build_planned = boom
    entry = reg.get(L)
    assert entry.wait_ready(timeout=WAIT)      # fires on failure too
    assert entry.state == "cold"
    assert isinstance(entry.build_error, RuntimeError)
    assert reg.build_failures == 1 and reg.promotions == 0
    b = np.random.default_rng(1).standard_normal(L.n)
    req = entry.engine.submit(b)
    entry.engine.run()
    np.testing.assert_allclose(req.x, _dense_solve(L, b), rtol=1e-10,
                               atol=1e-12)
    assert entry.stats()["build_error"] is not None
    assert reg.wait_idle(timeout=WAIT)


def test_evicted_entry_discards_inflight_build():
    L = random_lower(48, seed=7)
    gate = threading.Event()
    reg = _registry(strategy="levelset", background=True, build_gate=gate,
                    max_entries=1)
    entry = reg.get(L)
    reg.get(random_lower(48, seed=8))      # evicts L (no queued work)
    assert entry.evicted
    gate.set()
    assert reg.wait_idle(timeout=WAIT)
    # the build completed but must not have promoted the evicted entry
    assert entry.state == "cold"
    assert reg.promotions <= 1             # only the survivor's build


def test_registry_stats_shape():
    reg = _registry(strategy="serial", background=False, max_entries=4)
    L = random_lower(32, seed=0)
    entry = reg.get(L)
    st = reg.stats()
    assert st["entries"] == 1 and st["misses"] == 1
    assert st["resident_packed_bytes"] == entry.packed_bytes > 0
    es = st["per_entry"][entry.key]
    assert es["state"] == "ready"          # serial: promoted in place
    assert es["strategy"] == "serial"
    assert es["cold_build_s"] > 0
    assert st["cold_build"]["count"] == 1


def test_registry_stats_keys_equal_jax():
    with enable_x64():
        Lj = jsparse.random_lower(n=32, seed=0)
        ref = JaxSolverRegistry(strategy="serial", background=False)
        ref.get(Lj)
        reg = _registry(strategy="serial", background=False)
        reg.get(to_port(Lj))
        a, b = reg.stats(), ref.stats()
    assert sorted(a) == sorted(b)
    assert list(a["per_entry"]) == list(b["per_entry"])
    ka, kb = (next(iter(s["per_entry"].values())) for s in (a, b))
    assert sorted(ka) == sorted(kb)


def test_registry_validates_bounds():
    with pytest.raises(ValueError, match="max_entries"):
        SolverRegistry(max_entries=0, device="cpu")
    with pytest.raises(ValueError, match="max_bytes"):
        SolverRegistry(max_bytes=-1, device="cpu")


COUNTERS = ("hits", "misses", "promotions", "evictions", "build_failures")


@pytest.mark.parametrize("strategy", ["serial", "levelset"])
def test_admission_counts_equal_jax(strategy):
    """The same admissions (new patterns, same-pattern refreshes, repeats
    and re-admissions after eviction) through both registries with
    ``background=False``: equal counters and resident keys after each."""
    n = 40
    with enable_x64():
        mats = [jsparse.random_lower(n=n, seed=30 + s) for s in range(4)]
        order = [0, 1, 0, 2, 3, 1, 1, 0, 2, 3, 3, 0]
        ref = JaxSolverRegistry(strategy=strategy, background=False,
                                max_entries=2)
        reg = _registry(strategy=strategy, background=False, max_entries=2)
        for i, p in enumerate(order):
            Lj = mats[p]
            if i % 3 == 2:   # a same-pattern refresh
                Lj = JaxCSR(Lj.indptr, Lj.indices,
                            jsparse.refresh_values(Lj, seed=i), Lj.shape)
            ej, et = ref.get(Lj), reg.get(to_port(Lj))
            assert et.key == ej.key
            assert ([getattr(reg, c) for c in COUNTERS]
                    == [getattr(ref, c) for c in COUNTERS]), i
            assert reg.keys() == ref.keys()
            assert et.value_refreshes == ej.value_refreshes
            assert et.state == ej.state == "ready"
