"""Criticality-guided rewriting + transform planner benchmark — the port's
mirror of the JAX package's ``benchmarks/rewrite_planner.py``.

Measures, on a lung2-class f64 matrix:

* the rewrite engines: the batched elimination rounds
  (``engine="vectorized"``) against the per-row dict loop
  (``engine="loop"``, :func:`repro_torch.core.rewrite._rewrite_loop`), at
  the elimination phase (``engine``) and over the whole
  ``rewrite_matrix`` (``end_to_end``); both are host numpy;
* the policies: weighted critical path before/after for ``thin`` and
  ``critical_path``;
* a value-only replay of the batched engine's plan;
* ``strategy="auto"`` decisions on a lung2-class, a chain, a random and a
  banded matrix, each answer against the ``serial`` solve, on the device.

``--smoke`` gates the critical-path policy at >= 25% within the fill
budget, the engines at >= 10x (phase) and >= 2x (end to end), the planner
rewriting lung2 and leaving the chain to a sequential executor unrewritten,
and every planner answer to 1e-4.

    python -m repro_torch.bench.rewrite_planner [--smoke] [--json PATH] [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..core import RewriteConfig, SpTRSV, replay_rewrite_values, rewrite_matrix
from ..core.csr import CSRMatrix
from ..core.levels import build_level_sets
from ..core.rewrite import _participants, _rewrite_loop, _rewrite_vectorized
from ..kernels.backend import resolve_device
from ..sparse import banded_lower, chain_matrix, lung2_like, random_lower
from .common import (Gate, emit, flush_csv, hold,
                     write_bench_json)

__all__ = ["measure", "gates", "write_json", "run"]


def _best_of(f, reps, *args, **kwargs):
    best, out = float("inf"), None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = f(*args, **kwargs)
        best = min(best, time.perf_counter() - t0)
    return best, out


def measure(*, smoke: bool = False, device="cuda", lung2_scale: float = 1.0,
            planner_sizes=None) -> dict:
    """``lung2_scale`` and ``planner_sizes`` (``{name: size}`` of the
    planner's matrices) shrink the run."""
    dev = resolve_device(device)
    print(f"== rewrite_planner: criticality-guided rewriting + transform "
          f"planner ({dev.type}) ==")
    # the full lung2 in both modes: the engine margin grows with size
    L = lung2_like(scale=lung2_scale, dtype=np.float64)
    levels = build_level_sets(L)
    emit("rewrite_planner.rows", L.n)
    emit("rewrite_planner.nnz", L.nnz)
    results: dict = {"n": L.n, "nnz": L.nnz}

    # --- engine comparison: dict loop vs batched rounds ------------------
    cfg = RewriteConfig(thin_threshold=2)
    diag = L.diagonal()
    part = _participants(L, levels, cfg, upper=False)
    reps = 3 if smoke else 5
    t_vec_eng, _ = _best_of(_rewrite_vectorized, reps, L, levels, cfg,
                            upper=False, part=part, diag=diag)
    t_loop_eng, _ = _best_of(_rewrite_loop, 1, L, levels, cfg,
                             upper=False, part=part, diag=diag)
    t_vec_e2e, res_v = _best_of(
        rewrite_matrix, reps, L, levels, RewriteConfig(engine="vectorized"))
    t_loop_e2e, res_l = _best_of(
        rewrite_matrix, 1, L, levels, RewriteConfig(engine="loop"))
    assert res_v.stats.nnz_after == res_l.stats.nnz_after  # same decisions
    eng_ratio = t_loop_eng / t_vec_eng
    e2e_ratio = t_loop_e2e / t_vec_e2e
    emit("rewrite_planner.engine.loop_s", round(t_loop_eng, 4), "s")
    emit("rewrite_planner.engine.vectorized_s", round(t_vec_eng, 4), "s")
    emit("rewrite_planner.engine.speedup", round(eng_ratio, 1), "x")
    emit("rewrite_planner.end_to_end.loop_s", round(t_loop_e2e, 4), "s")
    emit("rewrite_planner.end_to_end.vectorized_s", round(t_vec_e2e, 4), "s")
    emit("rewrite_planner.end_to_end.speedup", round(e2e_ratio, 1), "x")
    results["engine"] = dict(loop_s=t_loop_eng, vectorized_s=t_vec_eng,
                             speedup=eng_ratio)
    results["end_to_end"] = dict(loop_s=t_loop_e2e, vectorized_s=t_vec_e2e,
                                 speedup=e2e_ratio)

    # --- policy comparison: thin vs critical_path ------------------------
    results["policies"] = {}
    for policy in ("thin", "critical_path"):
        t_build, res = _best_of(
            rewrite_matrix, reps, L, levels, RewriteConfig(policy=policy))
        s = res.stats
        cp_red = s.critical_path_reduction
        emit(f"rewrite_planner.{policy}.build_s", round(t_build, 4), "s")
        emit(f"rewrite_planner.{policy}.critical_path",
             f"{s.critical_path_before} -> {s.critical_path_after}",
             note=f"-{100*cp_red:.1f}%")
        emit(f"rewrite_planner.{policy}.rows_rewritten", s.rows_rewritten)
        emit(f"rewrite_planner.{policy}.fill_ratio",
             round(s.nnz_after / s.nnz_before, 3))
        results["policies"][policy] = dict(
            build_s=t_build,
            critical_path_before=s.critical_path_before,
            critical_path_after=s.critical_path_after,
            critical_path_reduction=cp_red,
            rows_rewritten=s.rows_rewritten,
            nnz_before=s.nnz_before, nnz_after=s.nnz_after,
            levels_before=s.levels_before, levels_after=s.levels_after,
            eliminations_skipped=s.eliminations_skipped)

    # --- value-only replay of the batched engine's plan ------------------
    rng = np.random.default_rng(1)
    d2 = L.data + 0.05 * rng.standard_normal(L.nnz)
    d2[L.indptr[1:] - 1] += 2.0
    L2 = CSRMatrix(L.indptr, L.indices, d2, L.shape)
    t_replay, _ = _best_of(replay_rewrite_values, reps, L2, res_v.plan,
                           res_v.L, res_v.E)
    emit("rewrite_planner.replay_s", round(t_replay, 4), "s",
         note=f"{t_vec_e2e/t_replay:.1f}x faster than a fresh rewrite")
    results["replay"] = dict(replay_s=t_replay,
                             vs_fresh_rewrite=t_vec_e2e / t_replay)

    # --- transform planner decisions across matrix classes ---------------
    sizes = {"lung2": 0.1 if smoke else 0.25, "chain": 2000, "random": 2000,
             "banded": 1500, **(planner_sizes or {})}
    mats = {
        "lung2": lung2_like(scale=sizes["lung2"], dtype=np.float32),
        "chain": chain_matrix(sizes["chain"], dtype=np.float32),
        "random": random_lower(sizes["random"], avg_offdiag=3.0, seed=0,
                               dtype=np.float32),
        "banded": banded_lower(sizes["banded"], bandwidth=8, seed=1,
                               dtype=np.float32),
    }
    results["planner"] = {}
    rng = np.random.default_rng(0)
    for name, M in mats.items():
        t0 = time.perf_counter()
        s = SpTRSV.build(M, strategy="auto", device=dev)
        build_s = time.perf_counter() - t0
        b = torch.from_numpy(rng.standard_normal(M.n).astype(np.float32)).to(dev)
        err = float((s.solve(b) - SpTRSV.build(M, strategy="serial",
                                               device=dev).solve(b)).abs().max())
        emit(f"rewrite_planner.auto.{name}",
             f"{s.strategy}"
             + (f"+rewrite:{s.plan.rewrite}" if s.plan.rewrite else "")
             + ("+coarsen" if s.plan.coarsen else ""),
             note=f"build {build_s:.2f}s, err {err:.1e}")
        results["planner"][name] = dict(
            strategy=s.strategy, rewrite=s.plan.rewrite,
            coarsen=s.plan.coarsen, build_s=build_s, err=err,
            costs={k: float(v) for k, v in s.plan.costs.items()})
    return results


def gates(results: dict) -> list:
    """The reference's ``--smoke`` assertions."""
    cp = results["policies"]["critical_path"]
    budget = RewriteConfig().max_fill_ratio
    eng, e2e = results["engine"]["speedup"], results["end_to_end"]["speedup"]
    pl = results["planner"]
    out = [
        Gate("critical_path.reduction", "structural",
             cp["critical_path_reduction"] >= 0.25,
             cp["critical_path_reduction"], ">= 0.25", repr(cp)),
        Gate("critical_path.fill", "structural",
             cp["nnz_after"] <= budget * cp["nnz_before"],
             cp["nnz_after"] / cp["nnz_before"], f"<= {budget}", repr(cp)),
        Gate("engine.speedup", "speed", eng >= 10.0, eng, ">= 10",
             f"vectorized engine only {eng:.1f}x faster than the dict loop "
             f"({results['engine']['vectorized_s']:.3f}s vs "
             f"{results['engine']['loop_s']:.3f}s)"),
        Gate("end_to_end.speedup", "speed", e2e >= 2.0, e2e, ">= 2",
             repr((results["end_to_end"]["loop_s"],
                   results["end_to_end"]["vectorized_s"]))),
        Gate("planner.lung2.rewrite", "plan", pl["lung2"]["rewrite"] is not None,
             pl["lung2"]["rewrite"], "not None", ""),
        Gate("planner.chain.strategy", "plan",
             pl["chain"]["strategy"] in ("serial", "sweep"),
             pl["chain"]["strategy"], "serial or sweep", ""),
        Gate("planner.chain.rewrite", "plan", pl["chain"]["rewrite"] is None,
             pl["chain"]["rewrite"], "None", ""),
    ]
    for name, row in pl.items():
        out.append(Gate(f"planner.{name}.err", "answer", row["err"] < 1e-4,
                        row["err"], "< 1e-4", repr((name, row["err"]))))
    return out


def write_json(path: str, results: dict, device="cuda") -> None:
    write_bench_json(path, "rewrite_planner", results,
                     backend=resolve_device(device).type, n=results["n"],
                     nnz=results["nnz"])


def run(*, smoke: bool = False, json_path: str = "", device="cuda") -> dict:
    results = measure(smoke=smoke, device=device)
    if smoke:
        hold(gates(results))
        cp = results["policies"]["critical_path"]
        print("  smoke assertions passed (critical path -"
              f"{100*cp['critical_path_reduction']:.0f}%, engine "
              f"{results['engine']['speedup']:.1f}x, planner transforms "
              "recorded)")
    if json_path:
        write_json(json_path, results, device)
    return results


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="smaller planner matrices + acceptance assertions")
    ap.add_argument("--json", default="", help="write results JSON here")
    ap.add_argument("--csv", default="")
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args()
    run(smoke=args.smoke, json_path=args.json, device=args.device)
    if args.csv:
        flush_csv(args.csv)
