"""The port's transform planner against the JAX package's: the same
decision and modelled costs from :func:`plan_strategy` under each of the
JAX package's calibration rows (``cpu``, ``gpu``, ``tpu``, passed as
``calibration=``), ``SpTRSV.build(strategy="auto")`` on the ``"cpu"`` row,
and the calibration table's save / load / refresh."""
import dataclasses
import json

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import repro.core.analysis as j_analysis
import repro.core.calibrate as j_cal
import repro.core.coarsen as j_coarsen
import repro.core.codegen as j_codegen
import repro.core.rewrite as j_rewrite
import repro.core.sweep as j_sweep
from repro.compat import enable_x64
from repro.core import SpTRSV as JaxSpTRSV
from repro.core import SweepConfig as JaxSweepConfig

import repro_torch.core.analysis as t_analysis
import repro_torch.core.calibrate as t_cal
import repro_torch.core.coarsen as t_coarsen
import repro_torch.core.codegen as t_codegen
import repro_torch.core.rewrite as t_rewrite
import repro_torch.core.sweep as t_sweep
from repro_torch.core import SpTRSV, SweepConfig
from repro_torch.core.levels import detect_supernodes as t_detect

from _torch_parity import TOL, carry, jax_matrix, systems, to_port

ROWS = ("cpu", "gpu", "tpu")
# (name, transpose) systems the planner inputs are built from
CASES = [("lung2", False), ("lung2", True), ("chain", False),
         ("dense_band", False), ("random", True)]


def _inputs(pkg, system, levels, upper):
    """plan_strategy's positional inputs and candidate keywords, built by
    one package the way its ``SpTRSV`` builds them for ``auto``."""
    an_m, cg, co, rw, sw = pkg
    analysis = an_m.analyze(system, levels, upper=upper)
    sched = cg.build_schedule(system, levels, upper=upper)
    coarse = co.coarsen_schedule(sched, co.CoarsenConfig(), unroll_threshold=4)
    cands = {}
    if co.should_consider_rewrite(analysis):
        for policy in ("thin", "critical_path"):
            rr = rw.rewrite_matrix(system, levels,
                                   rw.RewriteConfig(policy=policy), upper=upper)
            if rr.stats.rows_rewritten == 0:
                continue
            s_r = cg.build_schedule(rr.L, rr.levels, upper=upper)
            cands[policy] = co.RewriteCandidate(
                schedule=s_r,
                coarsened=co.coarsen_schedule(s_r, co.CoarsenConfig(),
                                              unroll_threshold=4),
                rhs_cost=2.0 * int(np.diff(rr.E.indptr).max()) * system.n
                + co.SEGMENT_COST)
    q = sw.contraction_factor(system, upper=upper)
    k = sw.planned_sweeps(q, levels.num_levels,
                          sw.default_residual_tol(system.dtype), 32)
    sweep = None if k is None else co.SweepCandidate(
        k=k, ell_k=max(int((system.row_nnz() - 1).max()), 1), n=system.n,
        contraction=q)
    return analysis, sched, coarse, dict(rewritten=cands or None, sweep=sweep)


def _blocked(system, upper):
    """The blocked candidate of both packages, from the same supernodes."""
    import repro.core.levels as j_levels
    sj = j_levels.detect_supernodes(system[0], upper=upper)
    st = t_detect(system[1], upper=upper)
    return (j_coarsen.blocked_candidate(
                j_coarsen.build_block_schedule(system[0], sj, upper=upper)),
            t_coarsen.blocked_candidate(
                t_coarsen.build_block_schedule(system[1], st, upper=upper)))


def _same_decision(a, b):
    assert (a.strategy, a.coarsen, a.rewrite, a.sweep_k) == \
        (b.strategy, b.coarsen, b.rewrite, b.sweep_k)
    assert set(a.costs) == set(b.costs)
    for key, v in b.costs.items():
        assert a.costs[key] == pytest.approx(v, rel=1e-12), key


@pytest.mark.parametrize("precision", ["native", "mixed"])
@pytest.mark.parametrize("row", ROWS)
@pytest.mark.parametrize("name,transpose", CASES)
def test_plan_strategy_matches_jax(name, transpose, row, precision):
    sj, st, lj, lt = systems(name, transpose)
    j_in = _inputs((j_analysis, j_codegen, j_coarsen, j_rewrite, j_sweep),
                   sj, lj, transpose)
    t_in = _inputs((t_analysis, t_codegen, t_coarsen, t_rewrite, t_sweep),
                   st, lt, transpose)
    bj, bt = _blocked((sj, st), transpose)
    cal_j = j_cal.DEFAULT_CALIBRATIONS[row]
    cal_t = carry(cal_j, t_cal.BackendCalibration)
    # the JAX planner prices its compiled kernels on gpu/tpu and the
    # interpreter (no fused candidate) on cpu; the port's cpu row has
    # fused_max_rows=0, the others admit the fused solve
    want = j_coarsen.plan_strategy(*j_in[:3], backend=row, calibration=cal_j,
                                   blocked=bj, precision=precision,
                                   **j_in[3])
    got = t_coarsen.plan_strategy(*t_in[:3], device="cpu", calibration=cal_t,
                                  blocked=bt, precision=precision, **t_in[3])
    _same_decision(got, want)
    assert ("precision=mixed" in got.reason) == (precision == "mixed")


def test_plan_strategy_default_rows():
    sj, st, lj, lt = systems("lung2", False)
    t_in = _inputs((t_analysis, t_codegen, t_coarsen, t_rewrite, t_sweep),
                   st, lt, False)
    j_in = _inputs((j_analysis, j_codegen, j_coarsen, j_rewrite, j_sweep),
                   sj, lj, False)
    _same_decision(t_coarsen.plan_strategy(*t_in[:3], device="cpu"),
                   j_coarsen.plan_strategy(*j_in[:3], backend="cpu"))
    cuda = t_coarsen.plan_strategy(*t_in[:3], device="cuda", **t_in[3])
    assert "pallas_fused" in cuda.costs and "backend=cuda" in cuda.reason
    assert "pallas_level" not in cuda.costs
    with pytest.raises(ValueError, match="device"):
        t_coarsen.plan_strategy(*t_in[:3], device="meta")


# (options, rewrite left open) of the auto builds held against JAX
AUTO = {
    "open": dict(),
    "no-coarsen": dict(coarsen=False),
    "no-sweep": dict(sweep=False),
    "sweep-cap": dict(sweep=SweepConfig(k=8)),
    "no-blocked": dict(supernodes=False),
}


def _jax_opts(kw):
    return {k: (carry(v, JaxSweepConfig) if k == "sweep" and v is not False
                else v) for k, v in kw.items()}


@pytest.mark.parametrize("opts", sorted(AUTO))
@pytest.mark.parametrize("name", ["lung2", "chain", "dense_band"])
def test_auto_build_matches_jax_on_cpu_row(name, opts):
    L = jax_matrix(name)
    kw = AUTO[opts]
    fwd, bwd = SpTRSV.build_pair(to_port(L), strategy="auto", device="cpu",
                                 **kw)
    b = np.random.default_rng(3).standard_normal((L.n, 2))
    with enable_x64():
        jf, jb = JaxSpTRSV.build_pair(L, strategy="auto", backend="interpret",
                                      **_jax_opts(kw))
        for ours, ref in ((fwd, jf), (bwd, jb)):
            _same_decision(ours.plan, ref.plan)
            assert ours.strategy == ref.strategy
            assert ours.stats()["segments"] == ref.stats()["segments"]
            assert ours.stats()["planned_sweeps"] == ref.stats()["planned_sweeps"]
            assert ours.stats()["planned_transform"] == \
                ref.stats()["planned_transform"]
            got = ours.solve(torch.from_numpy(b)).numpy()
            want = np.asarray(ref.solve(jnp.asarray(b)))
            tol = TOL[np.float64] if ref.plan.rewrite is None \
                else dict(rtol=1e-8, atol=1e-8)
            np.testing.assert_allclose(got, want, **tol)


# matrices on which the "cpu" row picks each family: a rewritten level-set
# solve (forward) and a coarsened one (transpose), sweeps, the blocked solve
WINNERS = {
    "lung2_like(0.05)": (lambda pkg: pkg.lung2_like(scale=0.05, seed=0),
                         {"levelset", "levelset_unroll"}),
    "chain_matrix(4000)": (lambda pkg: pkg.chain_matrix(4000), {"sweep"}),
    "banded_lower(2048)": (lambda pkg: pkg.banded_lower(2048, bandwidth=24,
                                                        fill=1.0),
                           {"blocked"}),
}


@pytest.mark.parametrize("name", sorted(WINNERS))
def test_auto_picks_each_family_like_jax(name):
    import repro.sparse as jsparse
    make, picks = WINNERS[name]
    L = make(jsparse)
    fwd, bwd = SpTRSV.build_pair(to_port(L), strategy="auto", device="cpu")
    b = np.random.default_rng(4).standard_normal(L.n)
    with enable_x64():
        jf, jb = JaxSpTRSV.build_pair(L, strategy="auto", backend="interpret")
        for ours, ref in ((fwd, jf), (bwd, jb)):
            _same_decision(ours.plan, ref.plan)
            assert ours.strategy in picks
            got = ours.solve(torch.from_numpy(b)).numpy()
            want = np.asarray(ref.solve(jnp.asarray(b)))
            np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-8)
    if name.startswith("lung2"):
        assert fwd.plan.rewrite == "thin" and bwd.plan.coarsen
        assert fwd.rewrite_result is not None
    if name.startswith("chain"):
        assert fwd.plan.sweep_k == jf.plan.sweep_k
        assert fwd.sweep_stats.fallback_solves == 0


def test_auto_adopts_a_rewrite_like_jax():
    """A rewrite-friendly matrix under a row where rewriting wins: the
    planner adopts the candidate, and the built solver runs it."""
    from repro.sparse import lung2_like
    L = lung2_like(scale=0.05, fat_levels=4, thin_run=12, seed=1)
    cal_j = dataclasses.replace(j_cal.DEFAULT_CALIBRATIONS["cpu"],
                                launch_cost=1e6, serial_step_cost=1e6)
    sj, st = L, to_port(L)
    import repro.core.levels as j_levels
    import repro_torch.core.levels as t_levels
    lj, lt = j_levels.build_level_sets(sj), t_levels.build_level_sets(st)
    j_in = _inputs((j_analysis, j_codegen, j_coarsen, j_rewrite, j_sweep),
                   sj, lj, False)
    t_in = _inputs((t_analysis, t_codegen, t_coarsen, t_rewrite, t_sweep),
                   st, lt, False)
    want = j_coarsen.plan_strategy(*j_in[:3], backend="cpu",
                                   calibration=cal_j, **j_in[3])
    got = t_coarsen.plan_strategy(
        *t_in[:3], device="cpu",
        calibration=carry(cal_j, t_cal.BackendCalibration), **t_in[3])
    _same_decision(got, want)
    assert got.rewrite is not None


def test_calibration_table_roundtrips(tmp_path):
    rows = {k: carry(v, t_cal.BackendCalibration)
            for k, v in j_cal.DEFAULT_CALIBRATIONS.items()}
    rows["cuda"] = t_cal.DEFAULT_CALIBRATIONS["cuda"]
    path = tmp_path / "calibration.json"
    t_cal.save_calibrations(path, rows)
    assert t_cal.load_calibrations(path) == rows
    # a table the JAX package writes loads into the port, row for row
    jpath = tmp_path / "jax.json"
    j_cal.save_calibrations(jpath, j_cal.DEFAULT_CALIBRATIONS)
    assert json.loads(jpath.read_text()) == json.loads(
        json.dumps({k: dataclasses.asdict(v) for k, v in rows.items()
                    if k != "cuda"}))
    loaded = t_cal.load_calibrations(jpath)
    for key, row in j_cal.DEFAULT_CALIBRATIONS.items():
        assert dataclasses.asdict(loaded[key]) == dataclasses.asdict(row)
    # refresh overlays a measured row; a missing file is the defaults
    measured = dataclasses.replace(t_cal.DEFAULT_CALIBRATIONS["cpu"],
                                   launch_cost=123.0, source="measured")
    t_cal.save_calibrations(path, {"cpu": measured})
    table = t_cal.refresh(path)
    assert table["cpu"] == measured
    assert table["cuda"] == t_cal.DEFAULT_CALIBRATIONS["cuda"]
    assert t_cal.refresh(tmp_path / "missing.json") == t_cal.DEFAULT_CALIBRATIONS
    assert t_cal.get_calibration("cpu", {"cpu": measured}) == measured


def test_calibration_rows_and_errors(tmp_path):
    assert dataclasses.asdict(t_cal.DEFAULT_CALIBRATIONS["cpu"]) == \
        dict(dataclasses.asdict(j_cal.DEFAULT_CALIBRATIONS["cpu"]))
    assert set(t_cal.DEFAULT_CALIBRATIONS) == {"cpu", "cuda"}
    cuda = t_cal.DEFAULT_CALIBRATIONS["cuda"]
    assert cuda.source == "measured" and cuda.fused_num_launches == "one"
    assert cuda.lane_width == 32 and cuda.fused_max_rows > 110_258
    with pytest.raises(ValueError, match="tpu"):
        t_cal.get_calibration("tpu")
    with pytest.raises(ValueError):
        t_cal.BackendCalibration(backend="x", fused_num_launches="two")
    bad = tmp_path / "bad.json"
    for text in ("{", "[1, 2]", '{"cpu": 3}'):
        bad.write_text(text)
        with pytest.raises(ValueError, match="malformed"):
            t_cal.load_calibrations(bad)
    extra = tmp_path / "extra.json"
    extra.write_text(json.dumps({"cpu": {"launch_cost": 5.0, "future": 1}}))
    assert t_cal.load_calibrations(extra)["cpu"].launch_cost == 5.0


def test_calibration_micro_run_on_the_host():
    """The micro-run's code path at its smoke size on the plain versions:
    a row of the device's family, marked measured, with the port's facts
    kept (its numbers are the host's, not a card's)."""
    from repro_torch.bench.calibrate import measure
    row, raw = measure("cpu", smoke=True)
    assert row.backend == "cpu" and row.source == "measured"
    assert row.gather_cost == 1.0 and row.launch_cost > 0
    assert row.fused_max_rows == t_cal.DEFAULT_CALIBRATIONS["cpu"].fused_max_rows
    assert set(raw) >= {"gather_gflops", "launch_us"}
