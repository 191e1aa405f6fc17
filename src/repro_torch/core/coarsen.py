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

Strategy planner: :func:`plan_strategy` picks ``serial`` / ``levelset`` /
``levelset_unroll`` / ``pallas_fused`` / ``sweep`` / ``blocked`` and the
matrix transform (rewrite policy × coarsening) for
``SpTRSV.build(..., strategy="auto")`` from one cost model whose
coefficients come from the device's calibration row
(:mod:`repro_torch.core.calibrate`).  Like the JAX planner it never prices
``pallas_level``, and it prices the fused solve as the JAX package's fused
layout executes: ``kmax`` ELL slots for every (lane-padded) row, though the
port's single-RHS walk reads only each row's real entries.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from .analysis import MatrixAnalysis
from .calibrate import BackendCalibration, get_calibration
from .codegen import LevelSlab, Schedule, _runs, slab_padded_flops
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
    "schedule_cost",
    "PlanDecision",
    "RewriteCandidate",
    "SweepCandidate",
    "BlockedCandidate",
    "blocked_candidate",
    "plan_strategy",
    "should_consider_rewrite",
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
        ar = np.arange(T)
        pad_eye[:, ar, ar] = ar[None, :] >= sizes[:, None]
        lane_row = np.full(BT, n, np.int64)
        # the level's rows block-major, each with its block, its offset in
        # the block and its lane
        r0 = bp[blocks].astype(np.int64)
        rows, bi, t = _runs(r0, sizes)
        lane_row[bi * T + t] = rows
        # their entries in CSR order: in-block ones fill the dense blocks,
        # the rest each row's off-block panel slots in order
        lo = indptr[rows].astype(np.int64)
        pos, er, _ = _runs(lo, indptr[rows + 1].astype(np.int64) - lo)
        c = indices[pos]
        inb = (c >= r0[bi[er]]) & (c < r0[bi[er]] + sizes[bi[er]])
        e = er[inb]
        ci = c[inb] - r0[bi[e]]
        dense[bi[e], t[e], ci] = data[pos[inb]]
        diag_src[bi[e], t[e], ci] = pos[inb]
        out = er[~inb]
        per_row = np.bincount(out, minlength=rows.size)
        K = max(int(per_row.max()) if rows.size else 0, 1)
        slot = np.arange(out.size) - np.repeat(np.cumsum(per_row) - per_row, per_row)
        lane = bi[out] * T + t[out]
        # batched inversion in float64 — padded lanes are identity, so the
        # inverse exists whenever the diagonal does
        dinv = np.linalg.inv(dense + pad_eye)
        cols = np.zeros((K, BT), np.int32)
        vals = np.zeros((K, BT), dtype=M.data.dtype)
        val_src = np.full((K, BT), -1, np.int64)
        cols[slot, lane] = c[~inb]
        vals[slot, lane] = data[pos[~inb]]
        val_src[slot, lane] = pos[~inb]
        slabs.append(BlockSlab(
            blocks=blocks, rows=rows, sizes=sizes, dinv=dinv,
            diag_src=diag_src, pad_eye=pad_eye, cols=cols, vals=vals,
            val_src=val_src, lane_row=lane_row))
    return BlockSchedule(n=n, nnz=M.nnz, slabs=tuple(slabs),
                         level_of_block=blevel, supernodes=supernodes)


# --------------------------------------------------------------------------
# Transform planner
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class PlanDecision:
    """Outcome of :func:`plan_strategy`, recorded on the built solver.

    ``strategy``  executor picked (serial / levelset / levelset_unroll /
                  pallas_fused / sweep / blocked)
    ``coarsen``   whether schedule coarsening is applied to the winner
    ``rewrite``   rewrite-policy tag ("thin" / "critical_path") when the
                  planner chose to transform the matrix first, else None
    ``costs``     every candidate's modelled per-solve cost; transform
                  combinations are keyed ``<strategy>+rewrite:<tag>+coarsen``
    ``sweep_k``   planned sweep count when ``strategy == "sweep"``, else None
    """

    strategy: str
    coarsen: bool
    reason: str
    costs: Dict[str, float]
    rewrite: Optional[str] = None
    sweep_k: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class RewriteCandidate:
    """A priced rewrite alternative: the schedule of the rewritten system
    L', its coarsened counterpart, and the per-solve cost of the RHS
    transform ``b' = E b`` (one padded ELL SpMV plus one launch)."""

    schedule: Schedule
    coarsened: Optional[Schedule]
    rhs_cost: float


@dataclasses.dataclass(frozen=True)
class SweepCandidate:
    """A priced sweep alternative: the certified sweep count ``k``
    (:func:`repro_torch.core.sweep.planned_sweeps`), the off-diagonal ELL
    width ``ell_k`` of the ``D + N`` split, ``n``, and the contraction
    factor ``q = ‖D⁻¹N‖_∞``."""

    k: int
    ell_k: int
    n: int
    contraction: float


@dataclasses.dataclass(frozen=True)
class BlockedCandidate:
    """A priced blocked alternative summarizing a :class:`BlockSchedule`:
    one barrier per super-level, panel FLOPs at ``gather_cost``, dense
    diagonal-block FLOPs at ``gemm_cost``, ``trsm_cost`` per block."""

    segments: int
    panel_flops: int
    gemm_flops: int
    num_blocks: int
    supernode_count: int
    mean_block_size: float


def blocked_candidate(bsched: BlockSchedule) -> BlockedCandidate:
    """Pricing summary of a built blocked schedule."""
    sn = bsched.supernodes
    return BlockedCandidate(
        segments=bsched.num_segments,
        panel_flops=bsched.panel_flops(),
        gemm_flops=bsched.gemm_flops(),
        num_blocks=bsched.num_blocks,
        supernode_count=sn.num_supernodes,
        mean_block_size=sn.mean_block_size,
    )


def schedule_cost(schedule: Schedule, *, unroll_threshold: int = 0,
                  segment_cost: float = SEGMENT_COST,
                  step_cost: float = SUBSTEP_COST,
                  flop_cost: float = 1.0) -> float:
    """Modelled per-solve cost of a level-set schedule: executed (padded)
    FLOPs scaled by ``flop_cost``, ``segment_cost`` per segment, and
    ``step_cost`` per coarsened chain sub-step."""
    return (flop_cost * schedule.padded_flops(unroll_threshold)
            + segment_cost * schedule.num_segments
            + step_cost * (schedule.total_depth - schedule.num_segments))


def _plan_target(device) -> str:
    """The calibration key of a solver's device: ``cuda`` or ``cpu``."""
    key = torch.device(device).type
    if key not in ("cpu", "cuda"):
        raise ValueError(f"no planner calibration for device {device!r}; "
                         "expected 'cuda' or 'cpu'")
    return key


def should_consider_rewrite(analysis: MatrixAnalysis) -> bool:
    """Gate for pricing rewrite candidates inside ``strategy="auto"``:
    barrier-dominated schedules with substantial thin-level content, not
    chain-like matrices (levels ~ n) and not shallow ones."""
    return (analysis.num_levels >= 8
            and analysis.num_levels <= 0.6 * analysis.n
            and analysis.thin_fraction_2 >= 0.25)


def plan_strategy(
    analysis: MatrixAnalysis,
    schedule: Schedule,
    coarsened: Optional[Schedule] = None,
    *,
    unroll_threshold: int = 4,
    segment_cost: Optional[float] = None,
    device="cuda",
    calibration: Optional[BackendCalibration] = None,
    rewritten: Optional[Dict[str, RewriteCandidate]] = None,
    sweep: Optional[SweepCandidate] = None,
    blocked: Optional[BlockedCandidate] = None,
    precision: str = "native",
) -> PlanDecision:
    """Pick an execution strategy and matrix transformation from the
    analysis and schedule cost model — the JAX package's planner, priced
    with the row of ``device`` (``"cuda"`` or ``"cpu"``).

    ``schedule`` is the uncoarsened schedule of the untransformed system,
    ``coarsened`` its coarsened counterpart when coarsening is on the table;
    ``rewritten`` maps rewrite-policy tags to :class:`RewriteCandidate`s,
    ``sweep`` and ``blocked`` price those executors.  Every combination is
    priced by one model, so the choice is one ``min()`` over ``costs``.
    ``calibration`` overrides the device's row and ``segment_cost`` just
    its launch cost.  The fused solve is a candidate only where
    ``fused_max_rows`` admits n (never on the ``cpu`` row).
    ``pallas_level`` is not priced (nor is it by the JAX planner).
    ``precision="mixed"`` scales every gather-bound term by
    ``mixed_gather_discount`` (bf16 value storage under the guard)."""
    label = _plan_target(device)
    cal = calibration if calibration is not None else get_calibration(label)
    if precision == "mixed":
        cal = dataclasses.replace(
            cal, gather_cost=cal.gather_cost * cal.mixed_gather_discount)
    seg_cost = cal.launch_cost if segment_cost is None else segment_cost

    costs: Dict[str, float] = {}
    # serial: every row a latency-bound step; transforms never help it, so
    # it is priced on the untransformed system only
    costs["serial"] = analysis.solve_flops + analysis.n * (
        cal.serial_step_cost + cal.serial_step_cost_scale * analysis.n)

    def _levelset_costs(suffix: str, sched: Schedule,
                        co: Optional[Schedule], extra: float) -> None:
        for tag, s in (("", sched), ("+coarsen", co)):
            if s is None:
                continue
            for strat, ut in (("levelset", 0),
                              ("levelset_unroll", unroll_threshold)):
                costs[f"{strat}{suffix}{tag}"] = extra + schedule_cost(
                    s, unroll_threshold=ut, segment_cost=seg_cost,
                    step_cost=cal.substep_cost, flop_cost=cal.gather_cost)

    def _fused_cost(suffix: str, sched: Schedule, extra: float) -> None:
        if analysis.n > cal.fused_max_rows:
            return
        kmax = max((s.K for s in sched.slabs), default=1)
        lane = max(cal.lane_width, 1)
        n_pad = -(-analysis.n // lane) * lane
        launches = (sched.total_depth
                    if cal.fused_num_launches == "per_level" else 1)
        costs[f"pallas_fused{suffix}"] = (
            extra + cal.gather_cost * (2 * kmax * n_pad + analysis.n)
            + seg_cost * launches)

    _levelset_costs("", schedule, coarsened, 0.0)
    _fused_cost("", schedule, 0.0)
    for tag, cand in (rewritten or {}).items():
        _levelset_costs(f"+rewrite:{tag}", cand.schedule, cand.coarsened,
                        cand.rhs_cost)
        _fused_cost(f"+rewrite:{tag}", cand.schedule, cand.rhs_cost)
    if sweep is not None:
        # k sweeps + 1 verification pass, each a gather-sum over all rows
        costs["sweep"] = cal.gather_cost * (sweep.k + 1) * (
            2 * sweep.ell_k * sweep.n + sweep.n) + seg_cost
    if blocked is not None:
        costs["blocked"] = (
            seg_cost * blocked.segments
            + cal.gather_cost * blocked.panel_flops
            + cal.gemm_cost * blocked.gemm_flops
            + cal.trsm_cost * blocked.num_blocks)

    best = min(costs, key=costs.get)
    parts = best.split("+")
    strategy = parts[0]
    rewrite_tag = next((p[len("rewrite:"):] for p in parts
                        if p.startswith("rewrite:")), None)
    return PlanDecision(
        strategy=strategy,
        coarsen="coarsen" in parts,
        rewrite=rewrite_tag,
        sweep_k=sweep.k if (sweep is not None and strategy == "sweep")
        else None,
        reason=(
            f"min modelled cost {costs[best]:.0f} among "
            + ", ".join(f"{k}={v:.0f}" for k, v in sorted(costs.items()))
            + f" (n={analysis.n}, levels={analysis.num_levels}, "
            f"thin_fraction={analysis.thin_fraction_2:.2f}, backend={label}"
            + (f", precision=mixed(gather x{cal.mixed_gather_discount:g})"
               if precision == "mixed" else "")
            + ")"
        ),
        costs=costs,
    )
