"""Permuted-space packed execution + value-only refresh benchmark — the
port's mirror of the JAX package's ``benchmarks/refresh.py``.

Measures the two claims of the permuted layout on a lung2-class matrix:

* ``refresh`` — re-solving the same sparsity pattern with new values reuses
  the cached symbolic schedule and the value buffers: ``SpTRSV.refresh``
  is one O(nnz) value re-pack, gated at **>= 10x** faster than a cold
  ``SpTRSV.build`` (analysis + packing + first solve);
* ``permuted vs scatter`` — per-solve time of the permuted executor
  against the per-segment scatter executor (``layout="scatter"``) for each
  strategy; permuted must be no slower.

Reported per configuration: ``build_s`` (cold build and first solve),
``refresh_s``, ``solve_s`` (median per solve, permuted / scatter), the
error against the ``serial`` solve, and the packed-buffer bytes.

    python -m repro_torch.bench.refresh [--smoke] [--json PATH] [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..core import SpTRSV
from ..core.csr import CSRMatrix
from ..kernels.backend import resolve_device
from ..sparse import lung2_like
from .common import (Gate, emit, flush_csv, hold, public, ready,
                     timeit, write_bench_json)

__all__ = ["measure", "gates", "write_json", "run"]


def _new_values(L: CSRMatrix, seed: int) -> np.ndarray:
    """Regenerated values on the same pattern, kept diagonally dominant."""
    rng = np.random.default_rng(seed)
    data = (L.data + 0.05 * rng.standard_normal(L.nnz)).astype(L.dtype)
    data[L.indptr[1:] - 1] += 2.0  # lower-triangular: diagonal last per row
    return data


def measure(*, smoke: bool = False, device="cuda", L=None) -> dict:
    """The bench's results (the reference's dict).  ``L`` replaces the
    matrix (a smaller one for a quick run)."""
    dev = resolve_device(device)
    print(f"== refresh: permuted-space packed execution + value-only refresh "
          f"({dev.type}) ==")
    if smoke:
        L = L or lung2_like(scale=0.05, fat_levels=8, thin_run=12,
                            dtype=np.float32)
        iters, warmup = 20, 3
        strategies = ("levelset", "levelset_unroll", "serial")
    else:
        L = L or lung2_like(scale=1.0, dtype=np.float32)
        iters, warmup = 5, 2
        strategies = ("levelset", "levelset_unroll")
    emit("refresh.rows", L.n)
    emit("refresh.nnz", L.nnz)

    rng = np.random.default_rng(0)
    b = torch.from_numpy(rng.standard_normal(L.n).astype(np.float32)).to(dev)
    oracle = SpTRSV.build(L, strategy="serial", device=dev).solve(b)
    new_data = _new_values(L, seed=1)
    results: dict = {"n": L.n, "nnz": L.nnz, "strategies": {}}

    for strategy in strategies:
        coarsen = None if strategy == "serial" else True
        row: dict = {}
        for layout in ("permuted", "scatter"):
            t0 = time.perf_counter()
            s = SpTRSV.build(L, strategy=strategy, coarsen=coarsen,
                             layout=layout, device=dev)
            ready(s.solve(b))  # first solve included
            build_s = time.perf_counter() - t0
            solve_s = timeit(s.solve, b, iters=iters, warmup=warmup)
            err = float((s.solve(b) - oracle).abs().max())
            emit(f"refresh.{strategy}.{layout}.build_s", round(build_s, 4), "s")
            emit(f"refresh.{strategy}.{layout}.solve_s", f"{solve_s:.3e}", "s")
            emit(f"refresh.{strategy}.{layout}.max_err", f"{err:.2e}")
            row[layout] = dict(build_s=build_s, solve_s=solve_s, err=err)
            if layout == "permuted":
                st = s.stats()
                emit(f"refresh.{strategy}.packed_value_bytes",
                     st["packed_value_bytes"], "B")
                emit(f"refresh.{strategy}.padded_value_bytes",
                     st["padded_value_bytes"], "B")
                row["stats"] = {k: st[k] for k in (
                    "packed_value_bytes", "packed_index_bytes",
                    "padded_value_bytes", "permutation_applied", "segments")}
                # value-only refresh: cached schedule, buffers in place
                t0 = time.perf_counter()
                s.refresh(new_data)
                ready(s.solve(b))
                refresh_s = time.perf_counter() - t0
                emit(f"refresh.{strategy}.refresh_s", round(refresh_s, 4), "s")
                row["refresh_s"] = refresh_s
                # the refreshed solver must match a cold build on the new values
                fresh = SpTRSV.build(
                    CSRMatrix(L.indptr, L.indices, new_data, L.shape),
                    strategy=strategy, coarsen=coarsen, device=dev)
                rerr = float((s.solve(b) - fresh.solve(b)).abs().max())
                emit(f"refresh.{strategy}.refresh_err", f"{rerr:.2e}")
                row["refresh_err"] = rerr
        speed = row["scatter"]["solve_s"] / row["permuted"]["solve_s"]
        ratio = row["permuted"]["build_s"] / row["refresh_s"]
        emit(f"refresh.{strategy}.permuted_speedup", round(speed, 3), "x")
        emit(f"refresh.{strategy}.refresh_speedup", round(ratio, 1), "x",
             note="cold build / refresh")
        results["strategies"][strategy] = row
    return results


def gates(results: dict) -> list:
    """The reference's ``--smoke`` assertions: refresh >= 10x faster than a
    cold build; refreshed and permuted answers to 1e-5; permuted per-solve
    time within 1.15x (serial 2x) of scatter."""
    out = []
    for strategy, row in results["strategies"].items():
        ratio = row["permuted"]["build_s"] / row["refresh_s"]
        out.append(Gate(f"{strategy}.refresh_speedup", "speed", ratio >= 10.0,
                        ratio, ">= 10",
                        f"{strategy}: refresh only {ratio:.1f}x faster than cold "
                        f"build ({row['refresh_s']:.3f}s vs "
                        f"{row['permuted']['build_s']:.3f}s)"))
        out.append(Gate(f"{strategy}.refresh_err", "answer",
                        row["refresh_err"] < 1e-5, row["refresh_err"], "< 1e-5",
                        repr((strategy, row["refresh_err"]))))
        out.append(Gate(f"{strategy}.permuted.err", "answer",
                        row["permuted"]["err"] < 1e-5, row["permuted"]["err"],
                        "< 1e-5", repr((strategy, row["permuted"]))))
        # serial has no permuted space (same scan, values as runtime
        # buffers): its gate only catches gross blowups
        slack = 2.0 if strategy == "serial" else 1.15
        per, sca = row["permuted"]["solve_s"], row["scatter"]["solve_s"]
        out.append(Gate(f"{strategy}.permuted_vs_scatter", "speed",
                        per <= slack * sca, per / sca, f"<= {slack}",
                        f"{strategy}: permuted solve {per:.3e}s slower than "
                        f"scatter {sca:.3e}s"))
    return out


def write_json(path: str, results: dict, device="cuda") -> None:
    write_bench_json(path, "refresh", public(results),
                     backend=resolve_device(device).type, n=results["n"],
                     nnz=results["nnz"])


def run(*, smoke: bool = False, json_path: str = "", device="cuda") -> dict:
    results = measure(smoke=smoke, device=device)
    if smoke:
        hold(gates(results))
        print("  smoke assertions passed (refresh >= 10x cold build, "
              "permuted <= scatter per-solve)")
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
