"""The port's guarded execution layer (``guard=``, on ``device="cpu"``)
against the JAX package's: each breakdown policy under each value fault
gives the same outcome and the same ``GuardStats``; clean solves, rewritten
and mixed-precision ones; the value scan, pivot repair and the fault
generators array for array."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

import repro.core.guard as j_guard
import repro.sparse as jsparse
from repro.compat import enable_x64
from repro.core import GuardBreakdownError as JaxBreakdown
from repro.core import GuardConfig as JaxGuardConfig
from repro.core import RewriteConfig as JaxRewriteConfig
from repro.core import SpTRSV as JaxSpTRSV

import repro_torch.core.guard as t_guard
import repro_torch.sparse as tsparse
from repro_torch.core import (GuardBreakdownError, GuardConfig, RewriteConfig,
                              SpTRSV)

from _torch_parity import TOL, assert_same, carry, to_port

# every executor family the JAX package's guard tests name
STRATEGIES = ["serial", "levelset", "sweep", "blocked"]
POLICIES = ["refine", "fallback", "raise"]


def _mk(n=96, seed=5, m=4):
    L = jsparse.random_lower(n=n, seed=seed)
    rng = np.random.default_rng(100 + seed)
    return L, rng.standard_normal((n, m))


def _build(L, strategy, cfg, transpose=False, **kw):
    ours = SpTRSV.build(to_port(L), strategy=strategy, guard=cfg,
                        transpose=transpose, device="cpu", **kw)
    jkw = {k: (carry(v, JaxRewriteConfig) if k == "rewrite" else v)
           for k, v in kw.items()}
    ref = JaxSpTRSV.build(L, strategy=strategy, backend="interpret",
                          transpose=transpose, guard=carry(cfg, JaxGuardConfig),
                          **jkw)
    return ours, ref


def _same_stats(ours, ref, dtype=np.float64):
    """Equal counts; the worst residual ratio on the same side of the
    tolerance (a rounding-level number when a solve verifies) and equal to
    1e-6 above it (or both non-finite)."""
    a, b = ours.stats.report(), ref.stats.report()
    ra, rb = a.pop("last_residual_ratio"), b.pop("last_residual_ratio")
    assert a == b
    tol = 128 * float(np.finfo(dtype).eps)
    assert (ra <= tol) == (rb <= tol), (ra, rb)
    if rb > tol:
        assert ra == pytest.approx(rb, rel=1e-6, nan_ok=True), (ra, rb)


def _outcome(fn):
    """``("ok", x)`` or ``("raise", columns)`` of a guarded call."""
    try:
        return "ok", fn()
    except (GuardBreakdownError, JaxBreakdown) as err:
        return "raise", err.columns


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_clean_input_verifies_like_jax(strategy, transpose):
    L, B = _mk()
    with enable_x64():
        ours, ref = _build(L, strategy, GuardConfig(), transpose=transpose)
        x = ours.solve(torch.from_numpy(B)).numpy()
        np.testing.assert_allclose(x, np.asarray(ref.solve(jnp.asarray(B))),
                                   **TOL[np.float64])
    _same_stats(ours.guard, ref.guard)
    assert ours.guard.stats.verified == 1
    assert ours.guard.stats.last_refine_steps == 0
    a, b = ours.stats(), ref.stats()
    for key in ("guard_precision", "guard_refine_steps", "guard_fallbacks",
                "guard_pivot_alarms"):
        assert a[key] == b[key], key


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("fault", list(tsparse.VALUE_FAULTS))
@pytest.mark.parametrize("strategy", ["levelset", "sweep"])
def test_fault_policy_matches_jax(strategy, fault, policy):
    """The fault pushed past refresh validation: the same outcome (raised
    at refresh, raised at solve, or an answer) and the same stats."""
    L, B = _mk()
    bad = jsparse.inject_values(L, fault, seed=3)
    cfg = GuardConfig(on_breakdown=policy,
                      pivot_tol=1e-12 if fault == "tiny_pivot" else 0.0)
    with enable_x64():
        ours, ref = _build(L, strategy, cfg)
        got = _outcome(lambda: ours.refresh(bad, validate=False))
        want = _outcome(lambda: ref.refresh(bad, validate=False))
        assert got[0] == want[0]
        if got[0] == "ok":
            got = _outcome(lambda: ours.solve(torch.from_numpy(B)).numpy())
            want = _outcome(lambda: np.asarray(ref.solve(jnp.asarray(B))))
            assert got[0] == want[0]
            if got[0] == "ok":
                np.testing.assert_allclose(got[1], want[1], equal_nan=True,
                                           **TOL[np.float64])
            else:
                np.testing.assert_array_equal(got[1], want[1])
    _same_stats(ours.guard, ref.guard)


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("fault", ["zero_pivot", "nan_slab"])
@pytest.mark.parametrize("strategy", ["serial", "blocked"])
def test_fault_policy_other_executors_match_jax(strategy, fault, policy):
    L, B = _mk()
    bad = jsparse.inject_values(L, fault, seed=1)
    cfg = GuardConfig(on_breakdown=policy, fallback="serial")
    with enable_x64():
        ours, ref = _build(L, strategy, cfg)
        got = _outcome(lambda: ours.refresh(bad, validate=False))
        want = _outcome(lambda: ref.refresh(bad, validate=False))
        assert got[0] == want[0]
        if got[0] == "ok":
            x = ours.solve(torch.from_numpy(B)).numpy()
            np.testing.assert_allclose(x, np.asarray(ref.solve(jnp.asarray(B))),
                                       equal_nan=True, **TOL[np.float64])
            if policy == "fallback":
                assert np.isfinite(x).all()
    _same_stats(ours.guard, ref.guard)


def test_fallback_repairs_a_zero_pivot_and_splices_columns():
    L, B = _mk()
    bad = jsparse.inject_values(L, "zero_pivot", seed=2)
    with enable_x64():
        ours, ref = _build(L, "levelset", GuardConfig(on_breakdown="fallback"))
        ours.refresh(bad, validate=False)
        ref.refresh(bad, validate=False)
        x = ours.solve(torch.from_numpy(B)).numpy()
        np.testing.assert_allclose(x, np.asarray(ref.solve(jnp.asarray(B))),
                                   **TOL[np.float64])
    assert np.isfinite(x).all()
    assert ours.guard.stats.fallback_solves == 1
    assert ours.guard.stats.pivot_alarms == 1
    # a singular system never verifies: the breakdown stays recorded
    assert ours.guard.stats.breakdown_columns == ref.guard.stats.breakdown_columns


@pytest.mark.parametrize("transpose", [False, True])
def test_rewritten_solve_is_verified_against_the_original(transpose):
    L = jsparse.lung2_like(scale=0.02, fat_levels=4)
    B = np.random.default_rng(7).standard_normal((L.n, 2))
    with enable_x64():
        ours, ref = _build(L, "levelset", GuardConfig(), transpose=transpose,
                           rewrite=RewriteConfig())
        x = ours.solve(torch.from_numpy(B)).numpy()
        np.testing.assert_allclose(x, np.asarray(ref.solve(jnp.asarray(B))),
                                   rtol=1e-8, atol=1e-8)
    A = L.to_dense()
    np.testing.assert_allclose(x, np.linalg.solve(A.T if transpose else A, B),
                               **TOL[np.float64])
    assert ours.guard.stats.verified == 1


@pytest.mark.parametrize("strategy", ["levelset", "pallas_fused", "blocked",
                                      "serial"])
def test_mixed_precision_recovers_f64_accuracy(strategy):
    L, B = _mk()
    cfg = GuardConfig(precision="mixed", refine_steps=4)
    fwd, bwd = SpTRSV.build_pair(to_port(L), strategy=strategy, guard=cfg,
                                 device="cpu")
    assert fwd._values[0].dtype == torch.bfloat16
    assert fwd._values[1].dtype == torch.float32
    y = fwd.solve(torch.from_numpy(B))
    z = bwd.solve(y).numpy()
    dense = L.to_dense()
    np.testing.assert_allclose(y.numpy(), np.linalg.solve(dense, B),
                               rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(z, np.linalg.solve(dense.T, y.numpy()),
                               rtol=1e-8, atol=1e-8)
    for s in (fwd, bwd):
        st = s.guard.stats
        assert st.verified == 1 and st.precision == "mixed"
        assert 1 <= st.last_refine_steps <= 4
        assert st.last_residual_ratio <= 128 * np.finfo(np.float64).eps
    if strategy == "levelset":
        with enable_x64():
            jf = JaxSpTRSV.build(L, strategy=strategy, backend="interpret",
                                 guard=carry(cfg, JaxGuardConfig))
            np.testing.assert_allclose(y.numpy(),
                                       np.asarray(jf.solve(jnp.asarray(B))),
                                       rtol=1e-9, atol=1e-9)
            assert jf.guard.stats.verified == 1
    # a refresh casts the new values into the mixed buffers in place
    new = jsparse.refresh_values(L, seed=4)
    ptrs = [v.data_ptr() for v in fwd._values]
    fwd.refresh(new)
    assert ptrs == [v.data_ptr() for v in fwd._values]
    assert fwd._values[0].dtype == torch.bfloat16
    Lnew = to_port(L)
    Lnew = type(Lnew).from_numpy(Lnew.indptr, Lnew.indices, new, Lnew.shape)
    np.testing.assert_allclose(fwd.solve(torch.from_numpy(B)).numpy(),
                               np.linalg.solve(Lnew.to_dense(), B),
                               rtol=1e-9, atol=1e-9)


def test_scan_and_repair_match_jax():
    L, _ = _mk()
    dpos = jsparse.diag_positions(L)
    for fault in tsparse.VALUE_FAULTS:
        bad = jsparse.inject_values(L, fault, seed=4)
        for tol in (0.0, 1e-12, 1e-3):
            assert t_guard.scan_values(bad, dpos, pivot_tol=tol) == \
                j_guard.scan_values(bad, dpos, pivot_tol=tol)
            a, na = t_guard.repair_pivots(bad, dpos, pivot_tol=tol)
            b, nb = j_guard.repair_pivots(bad, dpos, pivot_tol=tol)
            np.testing.assert_array_equal(a, b)
            assert na == nb


@pytest.mark.parametrize("seed", [0, 3])
def test_fault_generators_match_jax(seed):
    L = jsparse.lung2_like(scale=0.02, fat_levels=4)
    Lt = to_port(L)
    np.testing.assert_array_equal(tsparse.diag_positions(Lt),
                                  jsparse.diag_positions(L))
    for fault in tsparse.VALUE_FAULTS:
        for kw in (dict(), dict(count=5, slab=3, factor=1e-3)):
            np.testing.assert_array_equal(
                tsparse.inject_values(Lt, fault, seed=seed, **kw),
                jsparse.inject_values(L, fault, seed=seed, **kw))
    assert_same(tsparse.wrong_pattern(Lt, seed=seed),
                jsparse.wrong_pattern(L, seed=seed))
    assert tsparse.FAULT_KINDS == jsparse.FAULT_KINDS
    with pytest.raises(ValueError):
        tsparse.inject_values(Lt, "wrong_pattern")


def test_refresh_validation_and_wrong_pattern():
    L, B = _mk()
    s = SpTRSV.build(to_port(L), guard=True, device="cpu")
    bad = jsparse.inject_values(L, "nan_slab")
    with pytest.raises(ValueError, match="non-finite"):
        s.refresh(bad)
    with pytest.raises(ValueError, match="pattern"):
        s.refresh(tsparse.wrong_pattern(to_port(L)))
    s.refresh(jsparse.refresh_values(L, seed=1))
    assert s.guard.stats.pivot_alarms == 0


def test_guard_config_validation():
    for kw in (dict(refine_steps=-1), dict(on_breakdown="ignore"),
               dict(fallback="pallas_fused"), dict(precision="half"),
               dict(pivot_tol=-1e-3)):
        with pytest.raises(ValueError):
            GuardConfig(**kw)
    with pytest.raises(TypeError):
        SpTRSV.build(to_port(_mk()[0]), guard="yes", device="cpu")
