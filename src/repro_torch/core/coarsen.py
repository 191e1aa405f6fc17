"""Synchronization-aware schedule coarsening (Böhnlein et al.,
arXiv:2503.05408).

A run of (mostly thin) levels becomes one **super-level slab** carrying an
intra-slab dependency chain (``LevelSlab.sub_rows``): the sub-slabs execute
back-to-back inside a single segment, so a lung2-class schedule collapses
from ~493 segments to a few dozen while the floating-point work per row is
unchanged (same operands, same order; only zero padding is added).

Cost model: executing a slab costs ``segment_cost`` (launch + barrier, in
FLOP-equivalents) plus its padded FLOPs.  A merged group of ``d`` levels
executes ``d`` uniform sub-steps padded to the widest member but pays
``segment_cost`` once instead of ``d`` times; the greedy pass extends a
group while the waste stays below the segments saved.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .codegen import LevelSlab, Schedule, slab_padded_flops

__all__ = [
    "CoarsenConfig",
    "CoarsenStats",
    "coarsen_schedule",
    "coarsen_stats",
    "SEGMENT_COST",
    "SUBSTEP_COST",
]

# Cost of one barrier-separated segment, in FLOP-equivalents; only needs to
# separate "thin level" (work ~10 flops) from "fat level" (work >> cost).
SEGMENT_COST = 4096.0

# Cost of one intra-chain sub-step: cheaper than a full segment but not
# free, so a fat wavefront is not chained onto a thin run.
SUBSTEP_COST = SEGMENT_COST / 2


@dataclasses.dataclass(frozen=True)
class CoarsenConfig:
    """Knobs of the coarsening cost model.

    ``max_depth``       longest intra-slab chain
    ``max_chain_rows``  widest slab allowed inside a chain; wider slabs
                        always stand alone as plain parallel segments
    ``segment_cost``    launch/sync cost per segment, FLOP-equivalents
    ``step_cost``       per-sub-step chain overhead
    """

    max_depth: int = 32
    max_chain_rows: int = 128
    segment_cost: float = SEGMENT_COST
    step_cost: float = SUBSTEP_COST


@dataclasses.dataclass(frozen=True)
class CoarsenStats:
    segments_before: int
    segments_after: int
    padded_flops_before: int
    padded_flops_after: int

    @property
    def segment_reduction(self) -> float:
        return self.segments_before / max(self.segments_after, 1)

    def summary(self) -> str:
        return (
            f"segments {self.segments_before} -> {self.segments_after} "
            f"({self.segment_reduction:.1f}x fewer sync points), "
            f"padded FLOPs {self.padded_flops_before} -> "
            f"{self.padded_flops_after} "
            f"(+{100 * (self.padded_flops_after / max(self.padded_flops_before, 1) - 1):.1f}%)"
        )


def _slab_work(s: LevelSlab, unroll_threshold: int) -> float:
    """Executed FLOPs of one slab — the formula ``Schedule.padded_flops``
    sums, so merge decisions and costs never drift apart."""
    return float(slab_padded_flops(s, unroll_threshold))


def _merge_group(group: list) -> LevelSlab:
    """Concatenate a group of plain slabs into one super-slab.  Sub-slab t
    keeps its exact packing (row order, values); only zero padding up to the
    group-wide K is added."""
    if len(group) == 1:
        return group[0]
    K = max(s.K for s in group)
    R = sum(s.R for s in group)
    rows = np.concatenate([s.rows for s in group]).astype(np.int32)
    diag = np.concatenate([s.diag for s in group])
    cols = np.zeros((K, R), dtype=np.int32)
    vals = np.zeros((K, R), dtype=group[0].vals.dtype)
    with_src = all(s.val_src is not None for s in group)
    val_src = np.full((K, R), -1, dtype=np.int64) if with_src else None
    diag_src = (np.concatenate([s.diag_src for s in group])
                if with_src else None)
    off = 0
    for s in group:
        cols[: s.K, off : off + s.R] = s.cols
        vals[: s.K, off : off + s.R] = s.vals
        if with_src:
            val_src[: s.K, off : off + s.R] = s.val_src
        off += s.R
    return LevelSlab(rows=rows, cols=cols, vals=vals, diag=diag,
                     sub_rows=tuple(s.R for s in group),
                     val_src=val_src, diag_src=diag_src)


def coarsen_schedule(
    schedule: Schedule,
    config: CoarsenConfig = CoarsenConfig(),
    *,
    unroll_threshold: int = 0,
) -> Schedule:
    """Greedy synchronization-aware level merging.

    Walks the slab sequence in order (slab order is a topological order of
    the dependency DAG, so any prefix-respecting grouping is correct).  A
    slab joins the open group iff the group's merged execution cost —
    ``d * (2*Kmax*Rmax + Rmax)`` for ``d`` uniform chained sub-steps — does
    not exceed executing it separately plus the ``segment_cost`` the merge
    saves.  Already-coarsened slabs pass through untouched (idempotent).
    """
    slabs = schedule.slabs
    if len(slabs) <= 1 or config.max_depth <= 1:
        return schedule
    out: list = []
    group: list = []
    g_kmax = g_rmax = 0

    def flush():
        nonlocal group, g_kmax, g_rmax
        if group:
            out.append(_merge_group(group))
        group, g_kmax, g_rmax = [], 0, 0

    for s in slabs:
        # pre-coarsened input and fat wavefronts stay their own segments
        if s.depth > 1 or s.R > config.max_chain_rows:
            flush()
            out.append(s)
            continue
        if group:
            d2 = len(group) + 1
            k2 = max(g_kmax, s.K)
            r2 = max(g_rmax, s.R)
            merged = d2 * (2 * k2 * r2 + r2 + config.step_cost)
            prev_merged = len(group) * (
                2 * g_kmax * g_rmax + g_rmax + config.step_cost)
            separate = prev_merged + _slab_work(s, unroll_threshold) \
                + config.segment_cost
            if d2 <= config.max_depth and merged <= separate:
                group.append(s)
                g_kmax, g_rmax = k2, r2
                continue
            flush()
        group = [s]
        g_kmax, g_rmax = s.K, s.R
    flush()
    return Schedule(n=schedule.n, slabs=out,
                    level_of_row=schedule.level_of_row, nnz=schedule.nnz)


def coarsen_stats(before: Schedule, after: Schedule,
                  unroll_threshold: int = 0) -> CoarsenStats:
    return CoarsenStats(
        segments_before=before.num_segments,
        segments_after=after.num_segments,
        padded_flops_before=before.padded_flops(unroll_threshold),
        padded_flops_after=after.padded_flops(unroll_threshold),
    )
