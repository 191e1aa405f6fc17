"""Blocked (supernodal) SpTRSV benchmark: dense-band amalgamation against
the coarsened level-set executor — the port's mirror of the JAX package's
``benchmarks/blocked.py``.

On a dense band the blocked schedule collapses from one segment per
wavefront to one per super-level, and each segment's work turns into a
batched dense diagonal-block apply.  Reported per configuration
(``levelset`` + coarsening, ``blocked`` with ``relax=0.25, max_block=128``
supernodes): ``segments``, ``build_s``, ``solve_s`` (one RHS and a batch of
8) and ``max_err`` against the ``serial`` solve; then ``auto`` on a
lung2-class matrix with and without the blocked candidate.  ``--smoke``
gates blocked >= 1.3x over the coarsened levelset on the batch, >= 2x
fewer segments, the single-RHS solve at least 0.4x, the answers to 1e-4,
and the lung2 plan unchanged by the blocked candidate (and its solve within
2.5x).

    python -m repro_torch.bench.blocked [--smoke] [--json PATH] [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..core import SpTRSV, SupernodeConfig
from ..kernels.backend import resolve_device
from ..sparse import banded_lower, lung2_like
from .common import (Gate, emit, flush_csv, hold, public, ready,
                     timeit, write_bench_json)

__all__ = ["measure", "gates", "write_json", "run"]


def _build_and_time(L, b, oracle, tag, *, iters, warmup, device,
                    b_batch=None, **kw):
    t0 = time.perf_counter()
    s = SpTRSV.build(L, device=device, **kw)
    ready(s.solve(b))
    build_s = time.perf_counter() - t0
    solve_s = timeit(s.solve, b, iters=iters, warmup=warmup)
    err = float((s.solve(b) - oracle).abs().max())
    st = s.stats()
    emit(f"blocked.{tag}.segments", st["segments"])
    emit(f"blocked.{tag}.build_s", round(build_s, 4), "s")
    emit(f"blocked.{tag}.solve_s", f"{solve_s:.3e}", "s")
    emit(f"blocked.{tag}.max_err", f"{err:.2e}")
    res = dict(segments=st["segments"], build_s=build_s, solve_s=solve_s,
               err=err)
    if b_batch is not None:
        res["batch_solve_s"] = timeit(s.solve, b_batch, iters=iters,
                                      warmup=warmup)
        emit(f"blocked.{tag}.batch_solve_s", f"{res['batch_solve_s']:.3e}",
             "s", batch=b_batch.shape[1])
    return s, res


def measure(*, smoke: bool = False, device="cuda", n=None, lung2=None) -> dict:
    """``n`` and ``lung2`` replace the band's row count and the lung2-class
    matrix."""
    dev = resolve_device(device)
    print(f"== blocked: supernodal solves vs coarsened level sets ({dev.type}) ==")
    n_, bw, iters, warmup = (4096, 24, 10, 3) if smoke else (8192, 24, 10, 3)
    L = banded_lower(n or n_, bandwidth=bw, fill=1.0, seed=0, dtype=np.float32)
    emit("blocked.rows", L.n)
    emit("blocked.nnz", L.nnz)

    rng = np.random.default_rng(0)
    b = torch.from_numpy(rng.standard_normal(L.n).astype(np.float32)).to(dev)
    b8 = torch.from_numpy(rng.standard_normal((L.n, 8)).astype(np.float32)).to(dev)
    oracle = SpTRSV.build(L, strategy="serial", device=dev).solve(b)

    results = {}
    _, results["levelset"] = _build_and_time(
        L, b, oracle, "levelset", iters=iters, warmup=warmup, device=dev,
        b_batch=b8, strategy="levelset", coarsen=True)
    s_blk, results["blocked"] = _build_and_time(
        L, b, oracle, "blocked", iters=iters, warmup=warmup, device=dev,
        b_batch=b8, strategy="blocked", layout="permuted",
        supernodes=SupernodeConfig(relax=0.25, max_block=128))
    st = s_blk.stats()
    emit("blocked.mean_block_size", round(st["mean_block_size"], 2))
    emit("blocked.dense_block_fraction", round(st["dense_block_fraction"], 4))
    results["blocked"].update(mean_block_size=st["mean_block_size"],
                              dense_block_fraction=st["dense_block_fraction"])

    speedup = results["levelset"]["solve_s"] / results["blocked"]["solve_s"]
    batch_speedup = (results["levelset"]["batch_solve_s"]
                     / results["blocked"]["batch_solve_s"])
    seg_ratio = results["levelset"]["segments"] / max(
        results["blocked"]["segments"], 1)
    emit("blocked.solve_speedup", round(speedup, 3), "x")
    emit("blocked.batch_solve_speedup", round(batch_speedup, 3), "x")
    emit("blocked.segment_reduction", round(seg_ratio, 2), "x")
    results["solve_speedup"] = speedup
    results["batch_solve_speedup"] = batch_speedup
    results["segment_reduction"] = seg_ratio

    # lung2-class guard: amalgamation finds nothing there, so auto's pick
    # must be the one of a build with supernodes disabled
    Ll = lung2 or lung2_like(scale=0.05, fat_levels=8, thin_run=12,
                             dtype=np.float32)
    bl = torch.from_numpy(rng.standard_normal(Ll.n).astype(np.float32)).to(dev)
    oracle_l = SpTRSV.build(Ll, strategy="serial", device=dev).solve(bl)
    s_auto, auto_res = _build_and_time(
        Ll, bl, oracle_l, "lung2_auto", iters=iters, warmup=warmup, device=dev,
        strategy="auto")
    s_base, base_res = _build_and_time(
        Ll, bl, oracle_l, "lung2_prior", iters=iters, warmup=warmup,
        device=dev, strategy="auto", supernodes=False)
    emit("blocked.lung2.auto_strategy", s_auto.strategy)
    emit("blocked.lung2.mean_block_size",
         round(s_auto.stats()["mean_block_size"], 2))
    results["lung2"] = dict(auto=auto_res, prior=base_res,
                            strategy=s_auto.strategy,
                            strategy_unchanged=s_auto.strategy == s_base.strategy)
    results["_prior_strategy"] = s_base.strategy
    results["_reasons"] = (s_auto.plan.reason, s_base.plan.reason)
    results["_n"], results["_nnz"] = L.n, L.nnz
    return results


def gates(results: dict) -> list:
    """The reference's ``--smoke`` assertions."""
    bs, seg, sp = (results["batch_solve_speedup"], results["segment_reduction"],
                   results["solve_speedup"])
    err = results["blocked"]["err"]
    l2 = results["lung2"]
    auto_s, base_s = l2["auto"]["solve_s"], l2["prior"]["solve_s"]
    return [
        Gate("batch_solve_speedup", "speed", bs >= 1.3, bs, ">= 1.3",
             f"blocked batched speedup {bs:.2f}x < 1.3x"),
        Gate("segment_reduction", "structural", seg >= 2.0, seg, ">= 2",
             f"segment reduction {seg:.1f}x < 2x"),
        Gate("solve_speedup", "speed", sp >= 0.4, sp, ">= 0.4",
             f"single-RHS blocked {sp:.2f}x"),
        Gate("blocked.err", "answer", err < 1e-4, err, "< 1e-4", repr(err)),
        Gate("lung2.strategy_unchanged", "plan", l2["strategy_unchanged"],
             f"{l2['strategy']} / {results['_prior_strategy']}", "equal",
             f"blocked candidate changed the lung2 plan: {l2['strategy']} != "
             f"{results['_prior_strategy']}"),
        Gate("lung2.reason_unchanged", "plan",
             results["_reasons"][0] == results["_reasons"][1],
             results["_reasons"][0], "equal", ""),
        Gate("lung2.auto_vs_prior_solve", "speed", auto_s <= 2.5 * base_s,
             auto_s / base_s, "<= 2.5",
             f"auto with supernode gate {auto_s:.3e}s vs prior pick "
             f"{base_s:.3e}s"),
    ]


def write_json(path: str, results: dict, device="cuda") -> None:
    write_bench_json(path, "blocked", public(results),
                     backend=resolve_device(device).type, n=results["_n"],
                     nnz=results["_nnz"])


def run(*, smoke: bool = False, json_path: str = "", device="cuda") -> dict:
    results = measure(smoke=smoke, device=device)
    if smoke:
        hold(gates(results))
        print(f"  smoke assertions passed ({results['batch_solve_speedup']:.2f}x "
              f"over coarsened levelset at batch=8, lung2 plan unchanged: "
              f"{results['lung2']['strategy']})")
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
