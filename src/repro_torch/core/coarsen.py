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

The blocked (supernodal) schedule lives here too: :func:`build_block_schedule`
levels the block-granular DAG of a supernode partition and packs each
super-level into dense diagonal-block inverses plus an ELL panel.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .codegen import LevelSlab, Schedule, slab_padded_flops
from .csr import CSRMatrix
from .levels import Supernodes, _propagate_levels

__all__ = [
    "CoarsenConfig",
    "CoarsenStats",
    "coarsen_schedule",
    "coarsen_stats",
    "SEGMENT_COST",
    "SUBSTEP_COST",
    "BlockSlab",
    "BlockSchedule",
    "build_block_schedule",
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


# --------------------------------------------------------------------------
# Blocked (supernodal) schedule: the node-granular generalization
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class BlockSlab:
    """One super-level of the blocked schedule: ``B`` mutually independent
    supernodes executed as a batched dense diagonal-block apply plus a padded
    ELL panel update.

    Every block is padded to the level-wide ``T = max block size``; lanes are
    block-major (lane ``bi*T + t`` is row ``t`` of block ``bi``; padded lanes
    carry the sentinel row id ``n``).  The diagonal blocks are stored as
    *inverses* (``x_blk = D⁻¹ (b_blk − Panel · x_prev)``) so the solve is a
    batched GEMM rather than a per-block substitution; padded diagonal lanes
    hold an identity so the batched inverse is well-defined.

    ``blocks``    (B,) supernode ids
    ``rows``      (R,) original row ids, block-major, real rows only
    ``sizes``     (B,) rows per block
    ``dinv``      (B, T, T) float64 inverted diagonal blocks
    ``diag_src``  (B, T, T) int64 source position in ``L.data`` of each dense
                  in-block entry, −1 for structural zeros / padding — the
                  value-only ``refresh`` map for the dense blocks
    ``pad_eye``   (B, T, T) float64 identity on padded diagonal lanes (added
                  before every inversion, build and refresh alike)
    ``cols``      (K, B*T) int32 off-block dependency columns (0-padded)
    ``vals``      (K, B*T) off-block values
    ``val_src``   (K, B*T) int64 source positions in ``L.data``, −1 for pads
    ``lane_row``  (B*T,) int64 original row id per lane, ``n`` for padding
    """

    blocks: np.ndarray
    rows: np.ndarray
    sizes: np.ndarray
    dinv: np.ndarray
    diag_src: np.ndarray
    pad_eye: np.ndarray
    cols: np.ndarray
    vals: np.ndarray
    val_src: np.ndarray
    lane_row: np.ndarray

    @property
    def B(self) -> int:
        return self.dinv.shape[0]

    @property
    def T(self) -> int:
        return self.dinv.shape[1]

    @property
    def R(self) -> int:
        return len(self.rows)

    @property
    def K(self) -> int:
        return self.cols.shape[0]


@dataclasses.dataclass(frozen=True)
class BlockSchedule:
    """Supernodal (blocked) execution schedule: super-levels of dense
    diagonal blocks + off-diagonal panels.  The scalar-row level-set schedule
    is exactly this structure with every block of size 1 — node granularity
    is the only thing that changed."""

    n: int
    nnz: int
    slabs: tuple
    level_of_block: np.ndarray
    supernodes: Supernodes

    @property
    def num_segments(self) -> int:
        return len(self.slabs)

    @property
    def num_blocks(self) -> int:
        return sum(s.B for s in self.slabs)

    def perm(self) -> np.ndarray:
        """Original row id at each position of the blocked execution order
        (super-level by super-level, block-major)."""
        if not self.slabs:
            return np.zeros(0, dtype=np.int64)
        return np.concatenate([s.rows for s in self.slabs]).astype(np.int64)

    def panel_flops(self) -> int:
        """Padded FLOPs of the off-block panel updates (gather-sum over K
        ELL lanes + the RHS subtract)."""
        return sum(2 * s.K * s.B * s.T + s.B * s.T for s in self.slabs)

    def gemm_flops(self) -> int:
        """Dense FLOPs of the batched diagonal-block applies."""
        return sum(2 * s.T * s.T * s.B for s in self.slabs)


def build_block_schedule(
    M: CSRMatrix, supernodes: Supernodes, *, upper: bool = False
) -> BlockSchedule:
    """Build the blocked schedule of a triangular CSR from a supernode
    partition: level the *block-granular* dependency DAG (edge ``sb -> db``
    for any off-block entry coupling the two supernodes), then pack each
    super-level into a :class:`BlockSlab`.

    Correctness never depends on the partition — any contiguous run of rows
    is a valid block (its off-block dependencies are entirely outside the row
    span on the solved side) — so a degenerate all-singleton partition simply
    reproduces the scalar level-set structure with T=1 blocks."""
    n = M.n
    bp = supernodes.block_ptr
    block_of = supernodes.super_of_row
    nb = supernodes.num_supernodes
    indptr, indices, data = M.indptr, M.indices, M.data
    if nb == 0:
        return BlockSchedule(n=n, nnz=M.nnz, slabs=(),
                             level_of_block=np.zeros(0, np.int64),
                             supernodes=supernodes)
    row_of = np.repeat(np.arange(n, dtype=np.int64), M.row_nnz())
    strict = (indices > row_of) if upper else (indices < row_of)
    src_b = block_of[indices[strict]]
    dst_b = block_of[row_of[strict]]
    cross = src_b != dst_b
    edge_keys = np.unique(src_b[cross] * nb + dst_b[cross])
    blevel = _propagate_levels(nb, edge_keys // nb, edge_keys % nb)
    num_levels = int(blevel.max()) + 1 if nb else 0
    order = np.argsort(blevel, kind="stable")
    counts = np.bincount(blevel, minlength=num_levels)
    slabs = []
    off = 0
    for lv in range(num_levels):
        blocks = np.sort(order[off : off + int(counts[lv])])
        off += int(counts[lv])
        sizes = (bp[blocks + 1] - bp[blocks]).astype(np.int64)
        B = len(blocks)
        T = int(sizes.max())
        BT = B * T
        dense = np.zeros((B, T, T), np.float64)
        diag_src = np.full((B, T, T), -1, np.int64)
        pad_eye = np.zeros((B, T, T), np.float64)
        lane_row = np.full(BT, n, np.int64)
        offs = []           # (lane, off-block cols, off-block data positions)
        K = 1
        for bi, k in enumerate(blocks):
            r0, r1 = int(bp[k]), int(bp[k + 1])
            for t, r in enumerate(range(r0, r1)):
                lo, hi = int(indptr[r]), int(indptr[r + 1])
                c = indices[lo:hi]
                pos = np.arange(lo, hi, dtype=np.int64)
                inb = (c >= r0) & (c < r1)
                ci = c[inb] - r0
                dense[bi, t, ci] = data[lo:hi][inb]
                diag_src[bi, t, ci] = pos[inb]
                lane = bi * T + t
                lane_row[lane] = r
                cofs = c[~inb]
                offs.append((lane, cofs, pos[~inb]))
                K = max(K, len(cofs))
            for t in range(r1 - r0, T):
                pad_eye[bi, t, t] = 1.0
        # batched inversion in float64 — padded lanes are identity, so the
        # inverse exists whenever the diagonal does
        dinv = np.linalg.inv(dense + pad_eye)
        cols = np.zeros((K, BT), np.int32)
        vals = np.zeros((K, BT), dtype=M.data.dtype)
        val_src = np.full((K, BT), -1, np.int64)
        for lane, cofs, pofs in offs:
            kk = len(cofs)
            cols[:kk, lane] = cofs
            vals[:kk, lane] = data[pofs]
            val_src[:kk, lane] = pofs
        rows = np.concatenate(
            [np.arange(bp[k], bp[k + 1], dtype=np.int64) for k in blocks])
        slabs.append(BlockSlab(
            blocks=blocks, rows=rows, sizes=sizes, dinv=dinv,
            diag_src=diag_src, pad_eye=pad_eye, cols=cols, vals=vals,
            val_src=val_src, lane_row=lane_row))
    return BlockSchedule(n=n, nnz=M.nnz, slabs=tuple(slabs),
                         level_of_block=blevel, supernodes=supernodes)
