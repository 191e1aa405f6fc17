"""Multi-RHS SpTRSV throughput sweep: per-solve time vs batch width — the
port's mirror of the JAX package's ``benchmarks/batch_solve.py``.

Batching amortises execution overhead the way the paper amortises
analysis: per-level launch cost and the underfilled thin levels are paid
once per level per batch, not once per level per RHS.  Sweeps ``m in {1,
8, 64, 256}`` over ``levelset`` and ``levelset_unroll`` (and the kernel
strategies ``pallas_level`` / ``pallas_fused`` with ``--pallas``), with and
without the rewrite, and reports seconds per *solve* (batch time / m),
which should fall, or at worst stay flat, as m grows.  The reference has
no assertion; the trend lines are its finding.

    python -m repro_torch.bench.batch_solve [--dry-run] [--pallas] [--json PATH] [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..core import RewriteConfig, SpTRSV
from ..kernels.backend import resolve_device
from ..sparse import lung2_like
from .common import emit, flush_csv, timeit, write_bench_json

__all__ = ["measure", "gates", "write_json", "run"]


def measure(*, dry_run: bool = False, pallas: bool = False, device="cuda",
            L=None) -> dict:
    """``{(strategy, tag, m): seconds per solve}``.  ``L`` replaces the
    matrix."""
    dev = resolve_device(device)
    print(f"== batch_solve: per-solve time vs batch width ({dev.type}) ==")
    if dry_run:
        L = L or lung2_like(scale=0.02, fat_levels=4, thin_run=6,
                            dtype=np.float32)
        widths = (1, 8)
        iters, warmup = 2, 1
    else:
        L = L or lung2_like(scale=1.0, dtype=np.float32)
        widths = (1, 8, 64, 256)
        iters, warmup = 5, 2
    emit("batch.rows", L.n)
    emit("batch.nnz", L.nnz)

    strategies = ["levelset", "levelset_unroll"]
    if pallas:
        strategies += ["pallas_level", "pallas_fused"]

    rng = np.random.default_rng(0)
    results = {}
    for strategy in strategies:
        for rewrite, tag in ((None, "base"),
                             (RewriteConfig(thin_threshold=2), "rewrite")):
            s = SpTRSV.build(L, strategy=strategy, rewrite=rewrite, device=dev)
            base_per_solve = None
            for m in widths:
                B = torch.from_numpy(
                    rng.normal(size=(L.n, m)).astype(np.float32)).to(dev)
                arg = B[:, 0].contiguous() if m == 1 else B
                per_solve = timeit(s.solve, arg, iters=iters, warmup=warmup) / m
                if base_per_solve is None:
                    base_per_solve = per_solve
                emit(f"batch.{strategy}.{tag}.m{m}.per_solve_ms",
                     f"{per_solve * 1e3:.3f}", "ms", batch=m,
                     speedup_vs_m1=f"{base_per_solve / per_solve:.2f}x")
                results[(strategy, tag, m)] = per_solve
    for strategy in strategies:
        for tag in ("base", "rewrite"):
            series = [results[(strategy, tag, m)] for m in widths]
            trend = "improving" if series[-1] <= series[0] else "REGRESSING"
            emit(f"batch.{strategy}.{tag}.trend", trend,
                 m1_ms=f"{series[0]*1e3:.3f}", mmax_ms=f"{series[-1]*1e3:.3f}")
    results["_n"], results["_nnz"] = L.n, L.nnz
    return results


def gates(results: dict) -> list:
    """The reference asserts nothing: no gate."""
    return []


def write_json(path: str, results: dict, device="cuda") -> None:
    flat = {f"{strategy}.{tag}.m{m}": {"per_solve_s": t}
            for key, t in results.items() if isinstance(key, tuple)
            for strategy, tag, m in [key]}
    write_bench_json(path, "batch", flat, backend=resolve_device(device).type,
                     n=results["_n"], nnz=results["_nnz"])


def run(*, dry_run: bool = False, pallas: bool = False, json_path: str = "",
        device="cuda") -> dict:
    results = measure(dry_run=dry_run, pallas=pallas, device=device)
    if json_path:
        write_json(json_path, results, device)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dry-run", action="store_true",
                    help="tiny matrix, 2 widths, 2 iters")
    ap.add_argument("--pallas", action="store_true",
                    help="include the kernel strategies")
    ap.add_argument("--json", default="", help="write shared-schema JSON here")
    ap.add_argument("--csv", default=None, help="write results CSV here")
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    run(dry_run=args.dry_run, pallas=args.pallas, json_path=args.json,
        device=args.device)
    if args.csv:
        flush_csv(args.csv)


if __name__ == "__main__":
    main()
