"""The port's benchmark helpers and benches on the CPU: ``to_records`` and
``write_bench_json`` give the JAX package's shared schema
(``benchmarks/common.py``) record for record, and small runs of
``fig6_levels`` / ``exp1_codegen`` / ``exp2_rewrite`` (``full_scale=False``)
and ``serve_bench`` (``smoke=True``) produce their records, with the
references' assertions inside them; and the eight CI benches
(``refresh``, ``batch_solve``, ``coarsen``, ``blocked``, ``sweep``,
``guard``, ``preconditioner``, ``rewrite_planner``) and ``calibrate
--bench-json`` give the committed ``BENCH_*.json`` record names, with the
references' answer and structural gates held (their speed gates were set
on a CPU host and are computed, not held: ``refresh``'s ">= 10x over a
cold build" does not hold for the port, whose build compiles nothing);
and ``dist_solve`` on a world of one gives the JAX bench's record names and
its 8-way counts."""
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.bench import common, exp1_codegen, exp2_rewrite, fig6_levels
from repro_torch.bench import dist_solve, serve_bench
from repro_torch.bench import (batch_solve, blocked, calibrate, coarsen, guard,
                               preconditioner, refresh, rewrite_planner, sweep)
from repro_torch.sparse import lung2_like

ROOT = Path(__file__).resolve().parents[1]


def _reference_common():
    """``benchmarks/common.py`` loaded from its file (the directory is not
    a package)."""
    spec = importlib.util.spec_from_file_location(
        "_reference_bench_common", ROOT / "benchmarks" / "common.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


RESULTS = {"rows": 12, "nnz": np.int64(40),
           "warm": {"speedup": np.float32(3.5), "ok": True, "note": "x",
                    "none": None, "arr": np.zeros(3)},
           "deep": {"a": {"b": 1.25}}, "sched": [1, 2]}


def test_to_records_matches_reference():
    ref = _reference_common()
    assert common.BENCH_SCHEMA == ref.BENCH_SCHEMA
    got = common.to_records("serve", RESULTS, backend="cuda", n=12, nnz=40)
    want = ref.to_records("serve", RESULTS, backend="cuda", n=12, nnz=40)
    assert got == want
    assert {r["metric"] for r in got} == {"rows", "nnz", "speedup", "ok",
                                          "note", "none", "b"}
    assert common.to_records("p", {"x": 1})[0]["backend"] == (
        "cuda" if torch.cuda.is_available() else "cpu")


def test_write_bench_json_matches_reference(tmp_path):
    ref = _reference_common()
    common.write_bench_json(str(tmp_path / "a.json"), "exp1", RESULTS,
                            backend="cpu", n=3, nnz=4)
    ref.write_bench_json(str(tmp_path / "b.json"), "exp1", RESULTS,
                         backend="cpu", n=3, nnz=4)
    assert (tmp_path / "a.json").read_text() == (tmp_path / "b.json").read_text()


def test_timeit_and_emit(tmp_path):
    calls = []
    t = common.timeit(lambda x: calls.append(x), torch.zeros(2), iters=4,
                      warmup=3)
    assert t >= 0 and len(calls) == 1 + 1 + 2 + 4
    slow = []

    def long_call():
        slow.append(1)
        import time
        time.sleep(common.LONG_CALL_S)

    assert common.timeit(long_call, iters=5, warmup=3) >= common.LONG_CALL_S
    assert len(slow) == 2              # one warm-up, one timed call
    common.ROWS.clear()
    common.emit("x.y", 3, "ms", role="r")
    common.flush_csv(str(tmp_path / "rows.csv"))
    assert (tmp_path / "rows.csv").read_text().splitlines()[0] == \
        "name,role,unit,value"


def _records(path):
    payload = json.loads(Path(path).read_text())
    assert payload["schema"] == list(common.BENCH_SCHEMA)
    assert all(set(r) == set(common.BENCH_SCHEMA) for r in payload["records"])
    return {(r["name"], r["metric"]): r for r in payload["records"]}


def test_fig6_levels_small(tmp_path):
    res = fig6_levels.run(full_scale=False, json_path=str(tmp_path / "f.json"))
    st = res["lung2_like"]
    assert st.levels_before > 400 and st.level_reduction > 0.80
    recs = _records(tmp_path / "f.json")
    assert recs["fig6.lung2_like", "levels_after"]["value"] == st.levels_after
    assert recs["fig6.chain_4096", "levels_before"]["value"] == 4096


def test_exp1_codegen_small(tmp_path):
    res = exp1_codegen.run(full_scale=False, json_path=str(tmp_path / "e.json"),
                           device="cpu")
    assert set(res) == {"serial", "levelset", "unroll", "pallas_level",
                        "pallas_level_coarsen", "pallas_fused"}
    recs = _records(tmp_path / "e.json")
    assert all(r["backend"] == "cpu" for r in recs.values())
    assert recs["exp1.seconds", "serial"]["value"] == res["serial"] > 0
    assert recs["exp1.rel_err_vs_levelset", "pallas_fused"]["value"] <= \
        exp1_codegen.AGREE_TOL


def test_exp2_rewrite_small(tmp_path):
    res = exp2_rewrite.run(full_scale=False, json_path=str(tmp_path / "e.json"),
                           device="cpu")
    st = res["stats"]
    assert st.levels_after < st.levels_before
    for key in ("base", "rewritten", "bucketed", "pallas_level",
                "pallas_level_rewritten", "pallas_fused",
                "pallas_fused_rewritten"):
        assert res[key] > 0
    recs = _records(tmp_path / "e.json")
    assert recs["exp2", "levels_after"]["value"] == st.levels_after


def test_serve_bench_smoke(tmp_path):
    res = serve_bench.run(smoke=True, json_path=str(tmp_path / "s.json"),
                          device="cpu")
    mixed = res["mixed"]
    assert mixed["failed"] == 0 and mixed["evictions"] >= 1
    assert mixed["completed"] == mixed["solves"] == len(mixed["requests"])
    assert mixed["peak_resident_bytes"] <= mixed["budget_bytes"]
    # a sample of answers against a dense solve of the factor in effect
    for req, L in mixed["requests"][::10]:
        A = L.to_dense()
        np.testing.assert_allclose(
            req.x, np.linalg.solve(A.T if req.transpose else A, req.b),
            rtol=1e-10, atol=1e-12)
    recs = _records(tmp_path / "s.json")
    assert recs["serve.mixed", "failed"]["value"] == 0
    assert all(r["backend"] == "cpu" for r in recs.values())
    assert ("serve.mixed", "requests") not in recs


def test_serve_bench_requires_a_known_device():
    with pytest.raises(ValueError):
        serve_bench.run(smoke=True, device="tpu")


def _names(path):
    return {(r["name"], r["metric"])
            for r in json.loads(Path(path).read_text())["records"]}


def _held(gates, kinds=("answer", "structural", "plan")):
    """The gates' kinds are known, and the ones of ``kinds`` are met."""
    assert gates and all(g.kind in common.GATE_KINDS for g in gates)
    common.hold(gates, kinds)
    return {g.name: g for g in gates}


# bench -> (measure options of a quick CPU run, gate kinds held there): the
# smoke sizes where they take seconds; blocked and rewrite_planner smaller
# (their planner decisions depend on the size, so only answers and
# structure are held there)
BENCHES = {
    "refresh": (refresh, dict(smoke=True), ("answer", "structural")),
    "batch_solve": (batch_solve, dict(dry_run=True), ()),
    "coarsen": (coarsen, dict(smoke=True), ("answer", "structural", "plan")),
    "blocked": (blocked, dict(smoke=True, n=1024, lung2=lung2_like(
        scale=0.02, fat_levels=4, thin_run=6, dtype=np.float32)),
                ("answer", "structural")),
    "sweep": (sweep, dict(smoke=True), ("answer", "structural", "plan")),
    "guard": (guard, dict(smoke=True), ("answer", "structural", "plan")),
    "preconditioner": (preconditioner, dict(dry_run=True), ("answer",)),
    "rewrite_planner": (rewrite_planner, dict(
        smoke=True, lung2_scale=0.25,
        planner_sizes=dict(lung2=0.05, chain=500, random=500, banded=400)),
                        ("answer", "structural")),
}
REFERENCE_FILE = {"batch_solve": "BENCH_batch_solve.json"}


@pytest.mark.parametrize("name", sorted(BENCHES))
def test_ci_bench_records_and_gates(tmp_path, name):
    mod, kw, kinds = BENCHES[name]
    results = mod.measure(device="cpu", **kw)
    gates = mod.gates(results)
    if kinds:
        _held(gates, kinds)
    path = tmp_path / f"BENCH_{name}_cpu.json"
    mod.write_json(str(path), results, "cpu")
    recs = json.loads(path.read_text())["records"]
    assert all(r["backend"] == "cpu" for r in recs)
    ref = ROOT / REFERENCE_FILE.get(name, f"BENCH_{name}.json")
    if ref.exists():
        got, want = _names(path), _names(ref)
        if name == "rewrite_planner":
            # the planner's priced candidates depend on the (smaller) sizes
            got = {k for k in got if not k[0].endswith(".costs")}
            want = {k for k in want if not k[0].endswith(".costs")}
        assert got == want
    else:  # the reference writes no JSON: the emitted numbers, under precond
        assert {n.split(".")[0] for n, _ in _names(path)} == {"precond"}
        assert {"max_rel_diff", "shared_ms", "legacy_ms"} <= {m for _, m in _names(path)}


def test_refresh_gates_hold_the_scatter_twin_and_report_speed():
    res = refresh.measure(smoke=True, device="cpu", L=lung2_like(
        scale=0.02, fat_levels=4, thin_run=6, dtype=np.float32))
    assert set(res["strategies"]) == {"levelset", "levelset_unroll", "serial"}
    for row in res["strategies"].values():
        assert row["scatter"]["err"] < 1e-5 and row["permuted"]["err"] < 1e-5
    gates = {g.name: g for g in refresh.gates(res)}
    assert gates["serial.refresh_err"].kind == "answer"
    assert gates["levelset.refresh_speedup"].kind == "speed"
    assert gates["levelset.refresh_speedup"].threshold == ">= 10"
    broken = dict(res, strategies={"levelset": dict(
        res["strategies"]["levelset"], refresh_err=1.0)})
    with pytest.raises(AssertionError, match="levelset"):
        common.hold(refresh.gates(broken), ("answer",))


def test_bench_run_holds_the_reference_assertions(tmp_path):
    """``run(smoke=True)`` measures, then holds every gate as the
    reference's CLI does, and writes the JSON."""
    res = coarsen.run(smoke=True, device="cpu", json_path=str(tmp_path / "c.json"))
    assert res["segment_reduction"] >= 4.0
    assert _names(tmp_path / "c.json") == _names(ROOT / "BENCH_coarsen.json")
    bad = dict(res, segment_reduction=2.0)
    with pytest.raises(AssertionError, match="segment reduction 2.0x < 4x"):
        common.hold(coarsen.gates(bad))
    with pytest.raises(ValueError):
        common.Gate("x", "vibes", True, 1, "")


def test_calibrate_bench_json(tmp_path):
    """``calibrate --bench-json``: the measured row under its backend's name
    and the raw gather rate and launch time, as the JAX bench writes them
    (the JAX calibration row's fields; the committed file predates
    ``mixed_gather_discount``)."""
    from repro.core.calibrate import BackendCalibration as JaxRow
    import dataclasses

    path = tmp_path / "BENCH_calibrate.json"
    assert calibrate.main(["--device", "cpu", "--smoke", "--bench-json",
                           str(path)]) == 0
    want = {("calibrate.cpu", f.name) for f in dataclasses.fields(JaxRow)}
    want |= {("calibrate", "gather_gflops"), ("calibrate", "launch_us")}
    assert _names(path) == want
    assert _names(ROOT / "BENCH_calibrate.json") <= want
    recs = {(r["name"], r["metric"]): r for r in
            json.loads(path.read_text())["records"]}
    assert recs["calibrate.cpu", "source"]["value"] == "measured"
    assert recs["calibrate.cpu", "gather_cost"]["value"] == 1.0


def test_dist_solve_records_and_8way_counts(tmp_path):
    """``bench/dist_solve.py`` on a world of one (gloo): the JAX bench's
    record names, and its 8-way ``levels`` / ``bytes`` equal to
    ``repro.core.dist.shard_schedule`` on the same (rewritten) matrix."""
    import repro.core.codegen as j_codegen
    import repro.core.dist as j_dist
    import repro.sparse as jsparse
    from repro.core.levels import build_level_sets as j_build_level_sets
    from repro.core.rewrite import RewriteConfig as JaxRewriteConfig
    from repro.core.rewrite import rewrite_matrix as j_rewrite_matrix

    path = tmp_path / "BENCH_dist_solve_cpu.json"
    results = dist_solve.run(full_scale=False, json_path=str(path),
                             device="cpu")
    recs = json.loads(path.read_text())["records"]
    assert {f"{r['name']}.{r['metric']}" for r in recs} == {
        f"dist.{label}.{strat}.{metric}" for label in ("base", "rewrite")
        for strat in ("psum", "all_gather")
        for metric in ("levels", "bytes", "ms")}
    assert {r["backend"] for r in recs} == {"cpu"}
    L = jsparse.lung2_like(scale=0.05, dtype=np.float32)
    assert (results["_n"], results["_nnz"]) == (L.n, L.nnz)
    targets = {"base": L, "rewrite": j_rewrite_matrix(
        L, j_build_level_sets(L), JaxRewriteConfig(thin_threshold=2)).L}
    for label, target in targets.items():
        d = j_dist.shard_schedule(j_codegen.build_schedule(target), 8)
        for strat in ("psum", "all_gather"):
            got = results[label][strat]
            assert got["levels"] == d.num_levels
            assert got["bytes"] == d.collective_bytes(4, strat)
            assert got["ms"] > 0
            issued, planned = results["_collectives"][label, strat]
            assert issued == planned == d.num_collectives
    assert results["rewrite"]["all_gather"]["levels"] < \
        results["base"]["all_gather"]["levels"]
