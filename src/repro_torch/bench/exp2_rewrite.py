"""Paper §V Experiment 2: end-to-end solve with equation rewriting applied
(the port's mirror of the JAX package's ``benchmarks/exp2_rewrite.py``).

Paper (lung2, serial run of the rewritten generated code; CPU numbers):
2.06 ms vs 1.98 ms unrewritten — rewriting pays +10% FLOPs, the win
arrives with parallel hardware (fewer, fatter levels).  Reported: solve
time with and without rewriting, for ``levelset`` (plain and with
nnz-bucketed slabs) and, on the card's kernels, ``pallas_level`` and
``pallas_fused``; and the structural metrics that determine the parallel
win (levels = sequential segments; padded-FLOP waste = idle lanes).  The
rewrite's statistics are read from ``rewrite_result.stats`` (the JAX
bench reads ``SpTRSV.stats``, a method, as if it were that record).

    python -m repro_torch.bench.exp2_rewrite [--small] [--device cpu] [--json PATH]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..core import RewriteConfig, SpTRSV
from ..kernels.backend import resolve_device
from ..sparse import lung2_like
from .common import emit, timeit, write_bench_json

__all__ = ["run"]

# the kernel strategies timed with and without the rewrite
KERNEL_STRATEGIES = ("pallas_level", "pallas_fused")


def run(full_scale: bool = True, json_path: str = "", device="cuda"):
    dev = resolve_device(device)
    print(f"== exp2_rewrite: rewritten solver end-to-end ({dev.type}) ==")
    L = lung2_like(scale=1.0 if full_scale else 0.1, dtype=np.float32)
    b = torch.from_numpy(
        np.random.default_rng(0).normal(size=L.n).astype(np.float32)).to(dev)
    rw_cfg = RewriteConfig(thin_threshold=2)

    base = SpTRSV.build(L, strategy="levelset", device=dev)
    rw = SpTRSV.build(L, strategy="levelset", rewrite=rw_cfg, device=dev)
    # rewritten rows carry fill-in; one max-width slab per level pays their
    # K for every native row.  nnz-bucketed slabs (the paper's "multiple
    # functions per thick level") cap the padding.
    rw_bucket = SpTRSV.build(L, strategy="levelset", rewrite=rw_cfg,
                             bucket_pad_ratio=2.0, device=dev)
    kern = {}
    for strategy in KERNEL_STRATEGIES:
        kern[strategy] = (SpTRSV.build(L, strategy=strategy, device=dev),
                          SpTRSV.build(L, strategy=strategy, rewrite=rw_cfg,
                                       device=dev))

    t_base = timeit(base.solve, b, iters=5, warmup=2)
    t_rw = timeit(rw.solve, b, iters=5, warmup=2)
    t_rwb = timeit(rw_bucket.solve, b, iters=5, warmup=2)
    t_kern = {s: tuple(timeit(x.solve, b, iters=5, warmup=2) for x in pair)
              for s, pair in kern.items()}
    st = rw.rewrite_result.stats

    emit("exp2.levelset_ms", f"{t_base*1e3:.2f}", "ms")
    emit("exp2.rewritten_ms", f"{t_rw*1e3:.2f}", "ms")
    emit("exp2.rewritten_bucketed_ms", f"{t_rwb*1e3:.2f}", "ms",
         note="beyond-paper: nnz-bucketed slabs")
    for s, (t0, t1) in t_kern.items():
        emit(f"exp2.{s}_ms", f"{t0*1e3:.4f}", "ms")
        emit(f"exp2.{s}_rewritten_ms", f"{t1*1e3:.4f}", "ms")
        emit(f"exp2.{s}_speedup", f"{t0/t1:.2f}", "x")
    emit("exp2.padded_flops_plain", rw.schedule.padded_flops())
    emit("exp2.padded_flops_bucketed", rw_bucket.schedule.padded_flops())
    emit("exp2.slabs_plain", rw.schedule.num_levels)
    emit("exp2.slabs_bucketed", rw_bucket.schedule.num_levels)
    emit("exp2.speedup", f"{t_base/t_rw:.2f}", "x")
    emit("exp2.levels", f"{st.levels_before}->{st.levels_after}")
    emit("exp2.barriers_removed", f"{100*st.level_reduction:.1f}", "%")
    emit("exp2.flop_increase", f"{100*st.flop_increase:.1f}", "%")
    emit("exp2.paper_serial_rewritten_ms", 2.06, "ms", role="paper lung2, CPU")

    x0 = base.solve(b).cpu().numpy()
    for x in (rw, rw_bucket, *(s for pair in kern.values() for s in pair)):
        np.testing.assert_allclose(x0, x.solve(b).cpu().numpy(),
                                   rtol=2e-3, atol=2e-4)
    print("  [check] rewritten (+bucketed, + kernel strategies) solutions "
          "match unrewritten")
    results = {"base": t_base, "rewritten": t_rw, "bucketed": t_rwb,
               **{f"{s}{tag}": t for s, ts in t_kern.items()
                  for tag, t in zip(("", "_rewritten"), ts)},
               "stats": st}
    if json_path:
        write_bench_json(
            json_path, "exp2",
            {"seconds": {k: v for k, v in results.items() if k != "stats"},
             "levels_before": st.levels_before,
             "levels_after": st.levels_after,
             "level_reduction": st.level_reduction,
             "flop_increase": st.flop_increase,
             "padded_flops_plain": rw.schedule.padded_flops(),
             "padded_flops_bucketed": rw_bucket.schedule.padded_flops()},
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
