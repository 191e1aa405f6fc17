"""Guarded execution benchmark: verification overhead, mixed-precision
refinement quality, and the breakdown machinery under an injected fault —
the port's mirror of the JAX package's ``benchmarks/guard.py``.

The guard (``SpTRSV.build(..., guard=...)``) adds one componentwise
residual pass (two SpMV launches) and one ratio readback per solve.
Reported on a deep lung2-class f64 factor (``levelset``): the unguarded
and guarded solve times and their ratio, the guarded residual and
refinement steps, the mixed-precision solver's (bf16 values, f32 inner
solves, f64 refinement), and an injected zero pivot under
``on_breakdown="fallback"``.  ``--smoke`` gates the guarded overhead at
<= 1.15x, the mixed residual within ``128·eps(f64)`` in <= 3 steps with
every solve verified, the guarded solve verified without a step, and the
fallback fired once with a finite answer.

    python -m repro_torch.bench.guard [--smoke] [--json PATH] [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..core import GuardConfig, SpTRSV
from ..core.sweep import default_residual_tol
from ..kernels.backend import resolve_device
from ..sparse import inject_values, lung2_like
from .common import (Gate, emit, flush_csv, hold, public, ready,
                     timeit, write_bench_json)

__all__ = ["measure", "gates", "write_json", "run", "MAX_OVERHEAD",
           "MAX_REFINE_STEPS"]

MAX_OVERHEAD = 1.15
MAX_REFINE_STEPS = 3


def measure(*, smoke: bool = False, device="cuda", L=None) -> dict:
    dev = resolve_device(device)
    print(f"== guard: verified execution overhead + mixed-precision refine "
          f"({dev.type}) ==")
    if smoke:
        # a deep level structure (~1.1k levels) like the real lung2
        L = L or lung2_like(scale=0.05, fat_levels=20, thin_run=60,
                            dtype=np.float64)
        iters, warmup = 10, 3
    else:
        L = L or lung2_like(scale=1.0, dtype=np.float64)
        iters, warmup = 5, 2
    emit("guard.rows", L.n)
    emit("guard.nnz", L.nnz)
    tol = default_residual_tol(np.float64)
    emit("guard.residual_tol", f"{tol:.2e}")
    results: dict = {"rows": L.n, "nnz": L.nnz, "residual_tol": tol}

    rng = np.random.default_rng(0)
    b = torch.from_numpy(rng.standard_normal(L.n)).to(dev)

    # -- unguarded f64 baseline ------------------------------------------
    t0 = time.perf_counter()
    s_plain = SpTRSV.build(L, strategy="levelset", device=dev)
    ready(s_plain.solve(b))
    plain_build = time.perf_counter() - t0
    plain_solve = timeit(s_plain.solve, b, iters=iters, warmup=warmup)
    emit("guard.unguarded.build_s", round(plain_build, 4), "s")
    emit("guard.unguarded.solve_s", f"{plain_solve:.3e}", "s")
    results["unguarded"] = dict(build_s=plain_build, solve_s=plain_solve)

    # -- guarded f64: one residual pass + one readback per solve ----------
    t0 = time.perf_counter()
    s_g = SpTRSV.build(L, strategy="levelset", guard=True, device=dev)
    ready(s_g.solve(b))
    g_build = time.perf_counter() - t0
    g_solve = timeit(s_g.solve, b, iters=iters, warmup=warmup)
    st = s_g.guard.stats
    overhead = g_solve / plain_solve
    emit("guard.guarded.build_s", round(g_build, 4), "s")
    emit("guard.guarded.solve_s", f"{g_solve:.3e}", "s")
    emit("guard.guarded.overhead", round(overhead, 3), "x")
    emit("guard.guarded.residual_ratio", f"{st.last_residual_ratio:.2e}",
         tol=f"{tol:.2e}")
    emit("guard.guarded.refine_steps", st.last_refine_steps)
    results["guarded"] = dict(
        build_s=g_build, solve_s=g_solve, overhead=overhead,
        residual_ratio=st.last_residual_ratio,
        refine_steps=st.last_refine_steps, verified=st.verified)
    results["_guarded_solves"] = st.solves

    # -- mixed precision: bf16 values + f32 inner solves + f64 refinement -
    t0 = time.perf_counter()
    s_mx = SpTRSV.build(
        L, strategy="levelset", device=dev,
        guard=GuardConfig(precision="mixed", refine_steps=MAX_REFINE_STEPS))
    ready(s_mx.solve(b))
    mx_build = time.perf_counter() - t0
    mx_solve = timeit(s_mx.solve, b, iters=iters, warmup=warmup)
    stm = s_mx.guard.stats
    emit("guard.mixed.build_s", round(mx_build, 4), "s")
    emit("guard.mixed.solve_s", f"{mx_solve:.3e}", "s")
    emit("guard.mixed.residual_ratio", f"{stm.last_residual_ratio:.2e}",
         tol=f"{tol:.2e}")
    emit("guard.mixed.refine_steps", stm.last_refine_steps,
         max=MAX_REFINE_STEPS)
    emit("guard.mixed.verified", stm.verified)
    results["mixed"] = dict(
        build_s=mx_build, solve_s=mx_solve,
        residual_ratio=stm.last_residual_ratio,
        refine_steps=stm.last_refine_steps, verified=stm.verified)
    results["_mixed_solves"] = stm.solves

    # -- breakdown machinery: an injected zero pivot must route through
    #    the pivot-repaired fallback and stay finite ----------------------
    s_fb = SpTRSV.build(L, strategy="levelset", device=dev,
                        guard=GuardConfig(on_breakdown="fallback",
                                          refine_steps=1))
    s_fb.refresh(inject_values(L, "zero_pivot", seed=7), validate=False)
    x_fb = s_fb.solve(b)
    stf = s_fb.guard.stats
    finite = bool(torch.isfinite(x_fb).all())
    emit("guard.fallback.fired", stf.fallback_solves)
    emit("guard.fallback.pivot_alarms", stf.pivot_alarms)
    emit("guard.fallback.finite", finite)
    results["fallback"] = dict(fired=stf.fallback_solves,
                               pivot_alarms=stf.pivot_alarms, finite=finite)
    return results


def gates(results: dict) -> list:
    """The reference's ``--smoke`` assertions."""
    g, mx, fb = results["guarded"], results["mixed"], results["fallback"]
    tol = results["residual_tol"]
    return [
        Gate("mixed.verified", "structural",
             mx["verified"] == results["_mixed_solves"], mx["verified"],
             f"== solves ({results['_mixed_solves']})", repr(mx)),
        Gate("mixed.residual_ratio", "answer", mx["residual_ratio"] <= tol,
             mx["residual_ratio"], f"<= {tol:.2e}",
             f"mixed residual {mx['residual_ratio']:.2e} > tol {tol:.2e}"),
        Gate("mixed.refine_steps", "structural",
             mx["refine_steps"] <= MAX_REFINE_STEPS, mx["refine_steps"],
             f"<= {MAX_REFINE_STEPS}", repr(mx)),
        Gate("guarded.overhead", "speed", g["overhead"] <= MAX_OVERHEAD,
             g["overhead"], f"<= {MAX_OVERHEAD}",
             f"guarded overhead {g['overhead']:.3f}x > {MAX_OVERHEAD}x"),
        Gate("guarded.verified", "structural",
             g["verified"] == results["_guarded_solves"], g["verified"],
             f"== solves ({results['_guarded_solves']})", repr(g)),
        Gate("guarded.refine_steps", "structural", g["refine_steps"] == 0,
             g["refine_steps"], "== 0", repr(g)),
        Gate("fallback.fired", "structural", fb["fired"] == 1, fb["fired"],
             "== 1", repr(fb)),
        Gate("fallback.pivot_alarms", "structural", fb["pivot_alarms"] >= 1,
             fb["pivot_alarms"], ">= 1", repr(fb)),
        Gate("fallback.finite", "answer", fb["finite"], fb["finite"], "True",
             repr(fb)),
    ]


def write_json(path: str, results: dict, device="cuda") -> None:
    write_bench_json(path, "guard", public(results),
                     backend=resolve_device(device).type, n=results["rows"],
                     nnz=results["nnz"])


def run(*, smoke: bool = False, json_path: str = "", device="cuda") -> dict:
    results = measure(smoke=smoke, device=device)
    if smoke:
        hold(gates(results))
        mx = results["mixed"]
        print("  smoke assertions passed "
              f"(overhead {results['guarded']['overhead']:.3f}x <= "
              f"{MAX_OVERHEAD}x, mixed residual {mx['residual_ratio']:.1e} <= "
              f"{results['residual_tol']:.1e} in {mx['refine_steps']} step(s), "
              "fallback fired)")
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
