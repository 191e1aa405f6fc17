"""Paper §V Experiment 1: specialized-codegen solver vs handwritten baseline
(serial execution, no rewriting) — the port's mirror of the JAX package's
``benchmarks/exp1_codegen.py``.

Paper (lung2, dual-socket Westmere, clang; CPU numbers): generated 1.98 ms
vs handwritten level-set 1.14 ms.  As in the JAX bench, the "generated"
solvers are the matrix-specialized level-set executors (``levelset`` and
``levelset_unroll``, torch ops here) and the "handwritten" baseline is the
row-serial Algorithm 1 (``serial``).  On the card the generated executors
are the kernel strategies, so the bench also times ``pallas_level``,
``pallas_level`` + coarsening and ``pallas_fused`` (one RHS, f32), each
held against ``levelset``.  A call of 0.2 s or more is timed once after
one warm-up, but ``serial`` (seconds on the full lung2, a host loop with
nothing to compile) is timed on its first call; each solver's agreement
is read from its last timed answer.

    python -m repro_torch.bench.exp1_codegen [--small] [--device cpu] [--json PATH]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..core import SpTRSV
from ..kernels.backend import resolve_device
from ..sparse import lung2_like
from .common import emit, timeit, write_bench_json

__all__ = ["run", "AGREE_TOL"]

# max |x - x_levelset| / max |x_levelset| in f32: the f32 tolerance of the
# port's solver tests against a dense solve
AGREE_TOL = 1e-4
# the generated executors on the card: (key, build options)
KERNEL_STRATEGIES = (("pallas_level", dict(strategy="pallas_level")),
                     ("pallas_level_coarsen", dict(strategy="pallas_level",
                                                   coarsen=True)),
                     ("pallas_fused", dict(strategy="pallas_fused")))


def run(full_scale: bool = True, json_path: str = "", device="cuda"):
    dev = resolve_device(device)
    print(f"== exp1_codegen: specialized executor vs serial baseline "
          f"({dev.type}) ==")
    L = lung2_like(scale=1.0 if full_scale else 0.1, dtype=np.float32)
    b = torch.from_numpy(
        np.random.default_rng(0).normal(size=L.n).astype(np.float32)).to(dev)

    serial = SpTRSV.build(L, strategy="serial", device=dev)      # Algorithm 1
    levelset = SpTRSV.build(L, strategy="levelset", device=dev)  # generated
    unrolled = SpTRSV.build(L, strategy="levelset_unroll", unroll_threshold=4,
                            device=dev)
    solvers = {"serial": serial, "levelset": levelset, "unroll": unrolled}
    for key, kw in KERNEL_STRATEGIES:
        solvers[key] = SpTRSV.build(L, device=dev, **kw)

    answers = {}

    def answering(key, s):
        def solve(v):
            answers[key] = s.solve(v)
        return solve

    times = {key: timeit(answering(key, s), b, iters=5,
                         warmup=0 if key == "serial" else 2)
             for key, s in solvers.items()}
    x0 = answers["levelset"]
    scale = float(x0.abs().max())
    agree = {key: float((x - x0).abs().max()) / scale
             for key, x in answers.items() if key != "levelset"}

    emit("exp1.rows", L.n)
    emit("exp1.serial_ms", f"{times['serial']*1e3:.2f}", "ms",
         role="handwritten Algorithm-1")
    emit("exp1.levelset_ms", f"{times['levelset']*1e3:.2f}", "ms",
         role="generated per-level")
    emit("exp1.levelset_unroll_ms", f"{times['unroll']*1e3:.2f}", "ms",
         role="generated + tiny-level constant unroll")
    for key, _ in KERNEL_STRATEGIES:
        emit(f"exp1.{key}_ms", f"{times[key]*1e3:.4f}", "ms",
             role="generated, kernel strategy")
    emit("exp1.paper_generated_ms", 1.98, "ms", role="paper lung2, CPU")
    emit("exp1.paper_handwritten_ms", 1.14, "ms", role="paper lung2, CPU")
    for key, err in agree.items():
        assert err <= AGREE_TOL, f"{key} differs from levelset by {err:.3e}"
    print(f"  [check] every strategy matches levelset (max rel "
          f"{max(agree.values()):.2e} <= {AGREE_TOL})")
    results = {"serial": times["serial"], "levelset": times["levelset"],
               "unroll": times["unroll"],
               **{key: times[key] for key, _ in KERNEL_STRATEGIES}}
    if json_path:
        write_bench_json(json_path, "exp1",
                         {"seconds": results, "rel_err_vs_levelset": agree},
                         backend=dev.type, n=L.n, nnz=L.nnz)
    return results


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true",
                    help="lung2_like(scale=0.1) instead of the full size")
    ap.add_argument("--json", default="", help="write results JSON here")
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args()
    run(full_scale=not args.small, json_path=args.json, device=args.device)
