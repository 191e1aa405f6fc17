"""Schedule-coarsening benchmark: sync points, build time, per-solve time —
the port's mirror of the JAX package's ``benchmarks/coarsen.py``.

Coarsening removes barriers by merging adjacent levels under a cost model:
on a lung2-class matrix the level-set schedule's segments become a few
super-level slabs whose intra-slab chains run back to back inside one
segment.  Reported per configuration (``levelset`` with and without
``coarsen=True``): ``segments`` (sync points), ``build_s`` (build and
first solve), ``solve_s`` (median per solve) and ``max_err`` against the
``serial`` solve; then ``auto`` on the same matrix.  ``--smoke`` gates
>= 4x fewer segments, the answers to 1e-5, and the coarsened solve within
2.5x of the uncoarsened one.

    python -m repro_torch.bench.coarsen [--smoke] [--json PATH] [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..core import SpTRSV
from ..core.coarsen import coarsen_stats
from ..kernels.backend import resolve_device
from ..sparse import lung2_like
from .common import (Gate, emit, flush_csv, hold, public, ready,
                     timeit, write_bench_json)

__all__ = ["measure", "gates", "write_json", "run"]


def measure(*, smoke: bool = False, device="cuda", L=None) -> dict:
    dev = resolve_device(device)
    print(f"== coarsen: synchronization-aware level merging ({dev.type}) ==")
    if smoke:
        L = L or lung2_like(scale=0.05, fat_levels=8, thin_run=12,
                            dtype=np.float32)
        iters, warmup = 10, 2
    else:
        L = L or lung2_like(scale=1.0, dtype=np.float32)
        iters, warmup = 5, 2
    emit("coarsen.rows", L.n)
    emit("coarsen.nnz", L.nnz)

    rng = np.random.default_rng(0)
    b = torch.from_numpy(rng.standard_normal(L.n).astype(np.float32)).to(dev)
    oracle = SpTRSV.build(L, strategy="serial", device=dev).solve(b)

    results = {}
    for coarsen, tag in ((None, "base"), (True, "coarsen")):
        t0 = time.perf_counter()
        s = SpTRSV.build(L, strategy="levelset", coarsen=coarsen, device=dev)
        ready(s.solve(b))
        build_s = time.perf_counter() - t0
        solve_s = timeit(s.solve, b, iters=iters, warmup=warmup)
        err = float((s.solve(b) - oracle).abs().max())
        segs = s.schedule.num_segments
        emit(f"coarsen.{tag}.segments", segs)
        emit(f"coarsen.{tag}.build_s", round(build_s, 4), "s")
        emit(f"coarsen.{tag}.solve_s", f"{solve_s:.3e}", "s")
        emit(f"coarsen.{tag}.max_err", f"{err:.2e}")
        results[tag] = dict(segments=segs, build_s=build_s, solve_s=solve_s,
                            err=err, schedule=s.schedule)

    st = coarsen_stats(results["base"]["schedule"],
                       results["coarsen"]["schedule"])
    print("  " + st.summary())
    ratio = results["base"]["segments"] / max(results["coarsen"]["segments"], 1)
    speedup = results["base"]["solve_s"] / results["coarsen"]["solve_s"]
    emit("coarsen.segment_reduction", round(ratio, 2), "x")
    emit("coarsen.solve_speedup", round(speedup, 3), "x")
    emit("coarsen.build_speedup",
         round(results["base"]["build_s"] / results["coarsen"]["build_s"], 3),
         "x")

    # auto planner on the same matrix: must build and match the oracle
    s_auto = SpTRSV.build(L, strategy="auto", device=dev)
    err_auto = float((s_auto.solve(b) - oracle).abs().max())
    emit("coarsen.auto.strategy", s_auto.strategy, coarsen=s_auto.plan.coarsen)
    emit("coarsen.auto.max_err", f"{err_auto:.2e}")
    results["segment_reduction"] = ratio
    results["solve_speedup"] = speedup
    results["auto"] = dict(strategy=s_auto.strategy,
                           coarsen=s_auto.plan.coarsen, err=err_auto)
    results["_n"], results["_nnz"] = L.n, L.nnz
    return results


def gates(results: dict) -> list:
    """The reference's ``--smoke`` assertions."""
    ratio = results["segment_reduction"]
    co, base = results["coarsen"], results["base"]
    err_auto = results["auto"]["err"]
    return [
        Gate("segment_reduction", "structural", ratio >= 4.0, ratio, ">= 4",
             f"segment reduction {ratio:.1f}x < 4x"),
        Gate("coarsen.err", "answer", co["err"] < 1e-5, co["err"], "< 1e-5",
             repr(co["err"])),
        Gate("auto.err", "answer", err_auto < 1e-5, err_auto, "< 1e-5",
             repr(err_auto)),
        Gate("coarsen_vs_base_solve", "speed",
             co["solve_s"] <= 2.5 * base["solve_s"],
             co["solve_s"] / base["solve_s"], "<= 2.5",
             f"coarsened solve {co['solve_s']:.3e}s vs baseline "
             f"{base['solve_s']:.3e}s"),
    ]


def write_json(path: str, results: dict, device="cuda") -> None:
    write_bench_json(path, "coarsen", public(results),
                     backend=resolve_device(device).type, n=results["_n"],
                     nnz=results["_nnz"])


def run(*, smoke: bool = False, json_path: str = "", device="cuda") -> dict:
    results = measure(smoke=smoke, device=device)
    if smoke:
        hold(gates(results))
        print(f"  smoke assertions passed ({results['segment_reduction']:.1f}x "
              f"fewer segments, err {results['coarsen']['err']:.1e})")
    if json_path:
        write_json(json_path, results, device)
    return results


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="small matrix + acceptance assertions")
    ap.add_argument("--json", default="", help="write shared-schema JSON here")
    ap.add_argument("--csv", default="")
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args()
    run(smoke=args.smoke, json_path=args.json, device=args.device)
    if args.csv:
        flush_csv(args.csv)
