"""Speculative sweep benchmark: sync points, solve time, residual quality —
the port's mirror of the JAX package's ``benchmarks/sweep.py``.

The level-set executor, even coarsened, pays one barrier per schedule
segment; ``strategy="sweep"`` replaces the schedule with ``k`` Jacobi
sweeps over all rows (one SpMV launch each), one residual readback per
solve and an exact fallback.  Reported: ``sync_points`` (segments; 1 for
the sweep, its readback), ``build_s``, ``solve_s``, ``max_err`` against the
``serial`` solve and the sweep's residual ratio against its tolerance, then
``auto``'s pick.  ``--smoke`` gates >= 5x fewer sync points than the
coarsened levelset, the residual within tolerance, no fallback, and the
answers to 1e-4.

    python -m repro_torch.bench.sweep [--smoke] [--json PATH] [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..core import SpTRSV
from ..core.sweep import default_residual_tol
from ..kernels.backend import resolve_device
from ..sparse import lung2_like
from .common import (Gate, emit, flush_csv, hold, ready, timeit,
                     write_bench_json)

__all__ = ["measure", "gates", "write_json", "run"]


def measure(*, smoke: bool = False, device="cuda", L=None) -> dict:
    dev = resolve_device(device)
    print(f"== sweep: speculative solve-then-correct vs level-set ({dev.type}) ==")
    if smoke:
        L = L or lung2_like(scale=0.05, fat_levels=6, thin_run=10,
                            dtype=np.float32)
        iters, warmup = 10, 2
    else:
        L = L or lung2_like(scale=1.0, dtype=np.float32)
        iters, warmup = 5, 2
    emit("sweep.rows", L.n)
    emit("sweep.nnz", L.nnz)

    rng = np.random.default_rng(0)
    b = torch.from_numpy(rng.standard_normal(L.n).astype(np.float32)).to(dev)
    oracle = SpTRSV.build(L, strategy="serial", device=dev).solve(b)
    results: dict = {"rows": L.n, "nnz": L.nnz}

    # coarsened level-set baseline: one barrier per schedule segment
    t0 = time.perf_counter()
    s_ls = SpTRSV.build(L, strategy="levelset", coarsen=True, device=dev)
    ready(s_ls.solve(b))
    ls_build = time.perf_counter() - t0
    ls_sync = s_ls.schedule.num_segments
    ls_solve = timeit(s_ls.solve, b, iters=iters, warmup=warmup)
    ls_err = float((s_ls.solve(b) - oracle).abs().max())
    emit("sweep.levelset.sync_points", ls_sync)
    emit("sweep.levelset.build_s", round(ls_build, 4), "s")
    emit("sweep.levelset.solve_s", f"{ls_solve:.3e}", "s")
    emit("sweep.levelset.max_err", f"{ls_err:.2e}")
    results["levelset"] = dict(sync_points=ls_sync, build_s=ls_build,
                               solve_s=ls_solve, err=ls_err)

    # speculative sweep: no intra-solve barrier, one verification readback
    t0 = time.perf_counter()
    s_sw = SpTRSV.build(L, strategy="sweep", device=dev)
    ready(s_sw.solve(b))
    sw_build = time.perf_counter() - t0
    sw_solve = timeit(s_sw.solve, b, iters=iters, warmup=warmup)
    sw_err = float((s_sw.solve(b) - oracle).abs().max())
    st = s_sw.sweep_stats
    tol = default_residual_tol(L.dtype)
    sw_sync = 1  # the verification readback
    emit("sweep.sweep.sync_points", sw_sync)
    emit("sweep.sweep.k", st.k)
    emit("sweep.sweep.build_s", round(sw_build, 4), "s")
    emit("sweep.sweep.solve_s", f"{sw_solve:.3e}", "s")
    emit("sweep.sweep.max_err", f"{sw_err:.2e}")
    emit("sweep.sweep.residual_ratio", f"{st.last_residual_ratio:.2e}",
         tol=f"{tol:.2e}")
    emit("sweep.sweep.fallback_solves", st.fallback_solves)
    results["sweep"] = dict(sync_points=sw_sync, k=st.k, build_s=sw_build,
                            solve_s=sw_solve, err=sw_err,
                            residual_ratio=st.last_residual_ratio,
                            residual_tol=tol,
                            fallback_solves=st.fallback_solves)

    ratio = ls_sync / sw_sync
    emit("sweep.sync_reduction", round(ratio, 1), "x")
    emit("sweep.solve_speedup", round(ls_solve / sw_solve, 3), "x")
    results["sync_reduction"] = ratio
    results["solve_speedup"] = ls_solve / sw_solve

    # auto planner on the same matrix: what it picked and why
    s_auto = SpTRSV.build(L, strategy="auto", device=dev)
    err_auto = float((s_auto.solve(b) - oracle).abs().max())
    emit("sweep.auto.strategy", s_auto.strategy,
         planned_sweeps=s_auto.plan.sweep_k)
    emit("sweep.auto.max_err", f"{err_auto:.2e}")
    results["auto"] = dict(strategy=s_auto.strategy,
                           planned_sweeps=s_auto.plan.sweep_k, err=err_auto)
    return results


def gates(results: dict) -> list:
    """The reference's ``--smoke`` assertions."""
    sw = results["sweep"]
    ratio, res, tol = (results["sync_reduction"], sw["residual_ratio"],
                       sw["residual_tol"])
    return [
        Gate("sync_reduction", "structural", ratio >= 5.0, ratio, ">= 5",
             f"sync reduction {ratio:.1f}x < 5x"),
        Gate("sweep.residual_ratio", "answer", res <= tol, res,
             f"<= {tol:.2e}", f"residual {res:.2e} > tol {tol:.2e}"),
        Gate("sweep.fallback_solves", "structural", sw["fallback_solves"] == 0,
             sw["fallback_solves"], "== 0", repr(sw)),
        Gate("sweep.err", "answer", sw["err"] < 1e-4, sw["err"], "< 1e-4",
             repr(sw["err"])),
        Gate("auto.err", "answer", results["auto"]["err"] < 1e-4,
             results["auto"]["err"], "< 1e-4", repr(results["auto"]["err"])),
    ]


def write_json(path: str, results: dict, device="cuda") -> None:
    write_bench_json(path, "sweep", results, backend=resolve_device(device).type,
                     n=results["rows"], nnz=results["nnz"])


def run(*, smoke: bool = False, json_path: str = "", device="cuda") -> dict:
    results = measure(smoke=smoke, device=device)
    if smoke:
        hold(gates(results))
        sw = results["sweep"]
        print("  smoke assertions passed "
              f"({results['sync_reduction']:.0f}x fewer sync points, residual "
              f"{sw['residual_ratio']:.1e} <= {sw['residual_tol']:.1e}, "
              "0 fallbacks)")
    if json_path:
        write_json(json_path, results, device)
    return results


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="small matrix + acceptance assertions")
    ap.add_argument("--json", default="", help="write results JSON here")
    ap.add_argument("--csv", default="")
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args()
    run(smoke=args.smoke, json_path=args.json, device=args.device)
    if args.csv:
        flush_csv(args.csv)
