"""IC(0)/SpTRSV preconditioner: shared analysis against the reverse-permute
construction — the port's mirror of the JAX package's
``benchmarks/preconditioner.py``.

The preconditioner apply is two triangular solves, forward ``L y = r`` and
backward ``Lᵀ z = y``.  The legacy construction (kept here as
:func:`legacy_make_ic_preconditioner`) made the backward solve a *lower*
solve on the reverse-permuted transpose, with a second independent
``SpTRSV.build``; :func:`repro_torch.core.pcg.make_ic_preconditioner`
builds both from one analysis (``SpTRSV.build_pair``).  Reported: build
time of each, apply time of each, and PCG iterations on a Poisson IC(0)
system with each; the gates hold the two applies equal to 1e-4 and the
iteration counts within 5% (at least 1).  The reference writes no JSON;
``--json`` writes the emitted numbers under the prefix ``precond``.

    python -m repro_torch.bench.preconditioner [--dry-run] [--json PATH] [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..core import RewriteConfig, SpTRSV
from ..core.csr import from_coo
from ..core.pcg import make_ic_preconditioner, pcg
from ..kernels.backend import resolve_device
from ..sparse import ic0_factor, lung2_like, poisson2d
from .common import (Gate, emit, flush_csv, hold, public, ready,
                     timeit, write_bench_json)

__all__ = ["legacy_make_ic_preconditioner", "measure", "gates", "write_json",
           "run"]


def legacy_make_ic_preconditioner(L, *, strategy="levelset",
                                  rewrite=RewriteConfig(thin_threshold=2),
                                  device="cuda"):
    """The construction before transpose solves, kept as the baseline:
    transpose via ``from_coo``, reverse-permute to lower-triangular, and a
    second independent ``SpTRSV.build`` for the backward solve."""
    n = L.n
    rows = np.repeat(np.arange(n), L.row_nnz())
    Lt = from_coo(L.indices, rows, L.data, (n, n))
    rows_t = np.repeat(np.arange(n), Lt.row_nnz())
    Lt_rev = from_coo(n - 1 - rows_t, n - 1 - Lt.indices, Lt.data, (n, n))

    fwd = SpTRSV.build(L, strategy=strategy, rewrite=rewrite, device=device)
    bwd = SpTRSV.build(Lt_rev, strategy=strategy, rewrite=rewrite,
                       device=device)

    def apply(r):
        y = fwd.solve(r)
        return bwd.solve(y.flip(0)).flip(0)

    return apply


def _time_build(fn, iters: int) -> float:
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def measure(*, dry_run: bool = False, device="cuda") -> dict:
    dev = resolve_device(device)
    print(f"== preconditioner: shared-analysis vs reverse-permute baseline "
          f"({dev.type}) ==")
    if dry_run:
        L = lung2_like(scale=0.02, fat_levels=4, thin_run=6, dtype=np.float32)
        A = poisson2d(12, 12, dtype=np.float32)
        build_iters, tol, maxiter = 2, 1e-5, 200
    else:
        L = lung2_like(scale=0.25, dtype=np.float32)
        A = poisson2d(96, 96, dtype=np.float32)
        build_iters, tol, maxiter = 5, 1e-6, 1500
    emit("precond.rows", L.n)
    emit("precond.nnz", L.nnz)
    rewrite = RewriteConfig(thin_threshold=2)

    t_legacy = _time_build(lambda: legacy_make_ic_preconditioner(
        L, rewrite=rewrite, device=dev), build_iters)
    t_shared = _time_build(lambda: make_ic_preconditioner(
        L, rewrite=rewrite, device=dev), build_iters)
    emit("precond.build.legacy_ms", f"{t_legacy * 1e3:.2f}", "ms")
    emit("precond.build.shared_ms", f"{t_shared * 1e3:.2f}", "ms",
         speedup=f"{t_legacy / t_shared:.2f}x")

    M_legacy = legacy_make_ic_preconditioner(L, rewrite=rewrite, device=dev)
    M_shared = make_ic_preconditioner(L, rewrite=rewrite, device=dev)
    rng = np.random.default_rng(0)
    r = torch.from_numpy(rng.normal(size=L.n).astype(np.float32)).to(dev)
    z_legacy = ready(M_legacy(r))
    z_shared = M_shared(r)
    err = float((z_legacy - z_shared).abs().max()
                / max(float(z_legacy.abs().max()), 1e-30))
    emit("precond.apply.max_rel_diff", f"{err:.2e}")

    t_apply_legacy = timeit(M_legacy, r, iters=5, warmup=2)
    t_apply_shared = timeit(M_shared, r, iters=5, warmup=2)
    emit("precond.apply.legacy_ms", f"{t_apply_legacy * 1e3:.3f}", "ms")
    emit("precond.apply.shared_ms", f"{t_apply_shared * 1e3:.3f}", "ms",
         speedup=f"{t_apply_legacy / t_apply_shared:.2f}x")

    Lic = ic0_factor(A)
    b = torch.from_numpy(rng.normal(size=A.n).astype(np.float32)).to(dev)
    res_legacy = pcg(A, b, legacy_make_ic_preconditioner(
        Lic, rewrite=rewrite, device=dev), tol=tol, maxiter=maxiter)
    res_shared = pcg(A, b, make_ic_preconditioner(
        Lic, rewrite=rewrite, device=dev), tol=tol, maxiter=maxiter)
    emit("precond.pcg.iters.legacy", res_legacy.iters)
    emit("precond.pcg.iters.shared", res_shared.iters)
    if t_shared >= t_legacy:
        print("  !! build-time regression: shared-analysis slower than baseline")
    print(f"  build {t_legacy*1e3:.1f} -> {t_shared*1e3:.1f} ms "
          f"({t_legacy/t_shared:.2f}x), PCG iters {res_legacy.iters} -> "
          f"{res_shared.iters}")
    return {"rows": L.n, "nnz": L.nnz,
            "build": {"legacy_ms": t_legacy * 1e3, "shared_ms": t_shared * 1e3},
            "apply": {"max_rel_diff": err, "legacy_ms": t_apply_legacy * 1e3,
                      "shared_ms": t_apply_shared * 1e3},
            "pcg": {"iters": {"legacy": res_legacy.iters,
                              "shared": res_shared.iters}}}


def gates(results: dict) -> list:
    """The reference's assertions (run on every call, ``--dry-run`` or not),
    and its printed build-time check."""
    err = results["apply"]["max_rel_diff"]
    it = results["pcg"]["iters"]
    # the two constructions are one operator up to f32 rounding: a residual
    # at the tolerance may converge one iteration apart
    slack = max(1, it["legacy"] // 20)
    b = results["build"]
    return [
        Gate("apply.max_rel_diff", "answer", err < 1e-4, err, "< 1e-4",
             "shared-analysis apply diverged from the baseline"),
        Gate("pcg.iters", "answer", abs(it["shared"] - it["legacy"]) <= slack,
             f"{it['shared']} vs {it['legacy']}", f"within {slack}",
             "shared-analysis preconditioner changed PCG iteration count: "
             f"{it['shared']} vs {it['legacy']}"),
        Gate("build.shared_vs_legacy", "speed",
             b["shared_ms"] < b["legacy_ms"], b["shared_ms"] / b["legacy_ms"],
             "< 1 (printed, not asserted)", ""),
    ]


def write_json(path: str, results: dict, device="cuda") -> None:
    write_bench_json(path, "precond", public(results),
                     backend=resolve_device(device).type, n=results["rows"],
                     nnz=results["nnz"])


def run(*, dry_run: bool = False, json_path: str = "", device="cuda") -> dict:
    results = measure(dry_run=dry_run, device=device)
    hold(gates(results), kinds=("answer",))
    if json_path:
        write_json(json_path, results, device)
    return results


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dry-run", action="store_true")
    ap.add_argument("--json", default="", help="write results JSON here")
    ap.add_argument("--csv", default="")
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args()
    run(dry_run=args.dry_run, json_path=args.json, device=args.device)
    if args.csv:
        flush_csv(args.csv)


if __name__ == "__main__":
    main()
