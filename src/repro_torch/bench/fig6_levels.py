"""Paper Fig. 6: #levels and #FLOPs before/after equation rewriting (the
port's mirror of the JAX package's ``benchmarks/fig6_levels.py``).

Paper (lung2, 109,460 rows / 492,564 nnz / 478 levels, 94% thin):
    levels 478 -> 66 (-86% synchronization barriers), FLOPs +10%.
Reproduced on the structural twin ``lung2_like`` (SuiteSparse is offline)
plus the chain / IC(0)-Poisson workloads, validating the same regime:
large barrier reduction at single-digit-% FLOP increase.  Host work (the
symbolic rewrite); no device is used.

    python -m repro_torch.bench.fig6_levels [--small] [--json PATH]
"""
from __future__ import annotations

import argparse

from ..core import RewriteConfig, rewrite_matrix
from ..core.levels import build_level_sets
from ..sparse import chain_matrix, ic0_factor, lung2_like, poisson2d
from .common import emit, write_bench_json

__all__ = ["run"]


def run(full_scale: bool = True, json_path: str = ""):
    print("== fig6_levels: equation rewriting level/FLOP transformation ==")
    mats = {
        "lung2_like": lung2_like(scale=1.0 if full_scale else 0.1),
        "chain_4096": chain_matrix(4096),
        "ic0_poisson_64x64": ic0_factor(poisson2d(64, 64)),
    }
    results, records = {}, {}
    for name, L in mats.items():
        lv = build_level_sets(L)
        res = rewrite_matrix(L, lv, RewriteConfig(thin_threshold=2))
        st = res.stats
        emit(f"{name}.rows", L.n)
        emit(f"{name}.nnz", L.nnz)
        emit(f"{name}.levels_before", st.levels_before)
        emit(f"{name}.levels_after", st.levels_after)
        emit(f"{name}.barrier_reduction", f"{100*st.level_reduction:.1f}", "%")
        emit(f"{name}.flops_before", st.flops_before)
        emit(f"{name}.flops_after", st.flops_after)
        emit(f"{name}.flop_increase", f"{100*st.flop_increase:.1f}", "%")
        emit(f"{name}.thin_fraction", f"{100*lv.thin_fraction(2):.1f}", "%")
        results[name] = st
        records[name] = dict(
            rows=L.n, nnz=L.nnz, levels_before=st.levels_before,
            levels_after=st.levels_after, level_reduction=st.level_reduction,
            flops_before=st.flops_before, flops_after=st.flops_after,
            flop_increase=st.flop_increase, thin_fraction=lv.thin_fraction(2))

    st = results["lung2_like"]
    # paper-claims validation (structural twin): 478->66 = -86%; +10% FLOPs.
    # FLOP overhead is scale-dependent (fill-in amortizes over fat levels),
    # so the +10% regime check applies at full scale only.
    assert st.levels_before > 400, st.levels_before
    assert st.level_reduction > 0.80, st.summary()
    if full_scale:
        assert st.flop_increase < 0.20, st.summary()
    print(f"  [paper check] lung2-like: {st.summary()}")
    print(f"  [paper claim] lung2     : levels 478 -> 66 (-86.2%), FLOPs +10%")
    if json_path:
        L = mats["lung2_like"]
        write_bench_json(json_path, "fig6", records, n=L.n, nnz=L.nnz)
    return results


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true",
                    help="lung2_like(scale=0.1) instead of the full size")
    ap.add_argument("--json", default="", help="write results JSON here")
    args = ap.parse_args()
    run(full_scale=not args.small, json_path=args.json)
