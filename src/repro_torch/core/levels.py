"""Dependency-DAG level-set construction (paper §II, refs [2,18,19]).

The dependency graph ``DAG_L`` has a node per row and an edge ``j -> i`` for
every off-diagonal nonzero ``L[i, j]``.  ``level(i) = 1 + max(level(deps))``
(0 if none).  Rows of a level are mutually independent — the parallel
wavefront; levels execute serially with a barrier between them.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from .csr import CSRMatrix

__all__ = [
    "LevelSets",
    "Criticality",
    "SupernodeConfig",
    "Supernodes",
    "compute_levels",
    "compute_reverse_levels",
    "compute_upper_levels",
    "build_level_sets",
    "build_reverse_level_sets",
    "detect_supernodes",
    "solve_weights",
    "compute_critical_path",
    "compute_criticality",
]


def _propagate_levels(n: int, src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Longest-path layering of the DAG with edges ``src -> dst``, fully
    vectorized per wavefront (one ``maximum.at`` scatter per level).

    Each edge is touched exactly once across all wavefronts, so the total
    work is O(nnz + n) numpy ops — the analysis phase stops being bound by a
    per-row Python loop (arXiv:1710.04985's point: analysis must be cheap for
    specialization economics to hold).  The number of Python iterations
    equals the number of levels, but each is a handful of array ops.
    """
    level = np.zeros(n, dtype=np.int64)
    if src.size == 0:
        return level
    indeg = np.bincount(dst, minlength=n)
    # group edges by source (CSR-of-the-edge-list): out-edges of one node
    # are contiguous in dst_sorted
    cnt_src = np.bincount(src, minlength=n)
    outptr = np.concatenate([[0], np.cumsum(cnt_src)])
    dst_sorted = dst[np.argsort(src, kind="stable")]
    frontier = np.nonzero(indeg == 0)[0]
    while frontier.size:
        starts = outptr[frontier]
        cnt = outptr[frontier + 1] - starts
        total = int(cnt.sum())
        if total == 0:
            break
        off = np.cumsum(cnt) - cnt
        pos = np.repeat(starts - off, cnt) + np.arange(total)
        targets = dst_sorted[pos]
        np.maximum.at(level, targets, np.repeat(level[frontier] + 1, cnt))
        np.subtract.at(indeg, targets, 1)
        # a target may appear several times in this wavefront's edge list —
        # dedupe before it becomes a frontier node
        frontier = np.unique(targets[indeg[targets] == 0])
    return level


def _propagate_weighted(
    n: int, src: np.ndarray, dst: np.ndarray, w: np.ndarray
) -> np.ndarray:
    """Weighted longest-path accumulation over the DAG with edges
    ``src -> dst``: ``cp[i] = w[i] + max(cp[deps(i)], default 0)``.

    Same per-wavefront vectorization as :func:`_propagate_levels` (each edge
    touched once, O(nnz + n) total); with unit weights this reduces to
    ``level + 1``.  This is the quantity Böhnlein et al. show actually bounds
    parallel solve time — the *weighted critical path* — as opposed to the
    raw level count."""
    w = np.asarray(w, dtype=np.int64)
    cp = w.copy()
    if src.size == 0:
        return cp
    indeg = np.bincount(dst, minlength=n)
    cnt_src = np.bincount(src, minlength=n)
    outptr = np.concatenate([[0], np.cumsum(cnt_src)])
    dst_sorted = dst[np.argsort(src, kind="stable")]
    frontier = np.nonzero(indeg == 0)[0]
    while frontier.size:
        starts = outptr[frontier]
        cnt = outptr[frontier + 1] - starts
        total = int(cnt.sum())
        if total == 0:
            break
        off = np.cumsum(cnt) - cnt
        pos = np.repeat(starts - off, cnt) + np.arange(total)
        targets = dst_sorted[pos]
        np.maximum.at(cp, targets,
                      np.repeat(cp[frontier], cnt) + w[targets])
        np.subtract.at(indeg, targets, 1)
        frontier = np.unique(targets[indeg[targets] == 0])
    return cp


def solve_weights(M: CSRMatrix) -> np.ndarray:
    """Per-row substitution cost in FLOPs (mul+sub per off-diagonal nonzero,
    one divide) — the default weights of the weighted critical path."""
    return (2 * (M.row_nnz() - 1) + 1).astype(np.int64)


def _edge_arrays(M: CSRMatrix, *, upper: bool) -> tuple[np.ndarray, np.ndarray]:
    """Dependency edges ``src -> dst`` of the substitution DAG: for a lower
    matrix row ``i`` depends on cols ``j < i`` (edge j -> i); for an upper
    matrix on cols ``j > i``."""
    row_of = np.repeat(np.arange(M.n, dtype=np.int64), M.row_nnz())
    mask = (M.indices > row_of) if upper else (M.indices < row_of)
    return M.indices[mask], row_of[mask]


def compute_levels(L: CSRMatrix) -> np.ndarray:
    """Level of each row of a lower-triangular matrix: ``1 + max`` over
    off-diagonal dependencies.  Vectorized per wavefront — O(nnz) total, no
    per-row Python loop (see :func:`_propagate_levels`)."""
    src, dst = _edge_arrays(L, upper=False)
    return _propagate_levels(L.n, src, dst)


def compute_reverse_levels(
    L: CSRMatrix, forward: "LevelSets | None" = None
) -> np.ndarray:
    """Level of each row in the *transpose* solve ``Lᵀ x = b``, derived from
    the forward CSR.

    ``DAG_{Lᵀ}`` is ``DAG_L`` with every edge reversed (transpose row ``j``
    depends on ``x[i]`` for each nonzero ``L[i, j]``, ``i > j``), so the
    backward level sets come out of the *same* symbolic analysis as the
    forward ones, scattering ``rlevel[j] = max(rlevel[j], rlevel[i] + 1)``
    over ``L``'s own CSR arrays — no transpose matrix, no
    reverse-permutation, no second DAG traversal.

    When the forward :class:`LevelSets` are passed, the scatter runs as one
    vectorized ``maximum.at`` per forward wavefront, highest level first
    (every edge ``j -> i`` has ``level(j) < level(i)``, so by the time level
    ``lv`` is swept all consumers of its rows are settled).  This is the
    shared-analysis fast path; without a forward analysis the same
    vectorized wavefront propagation runs on the reversed edge list.
    """
    n = L.n
    if forward is not None:
        rlevel = np.zeros(n, dtype=np.int64)
        indptr, indices = L.indptr, L.indices
        for rows in reversed(forward.rows):
            starts = indptr[rows]
            cnt = indptr[rows + 1] - starts
            total = int(cnt.sum())
            if total == 0:
                continue
            off = np.cumsum(cnt) - cnt
            pos = np.repeat(starts - off, cnt) + np.arange(total)
            cols = indices[pos]
            mask = cols < np.repeat(rows, cnt)  # off-diagonal entries only
            np.maximum.at(
                rlevel, cols[mask], np.repeat(rlevel[rows] + 1, cnt)[mask])
        return rlevel
    # no forward analysis: the reversed DAG has edges i -> j for every
    # off-diagonal L[i, j] — same vectorized wavefront propagation
    src, dst = _edge_arrays(L, upper=False)
    return _propagate_levels(n, dst, src)


def compute_upper_levels(U: CSRMatrix) -> np.ndarray:
    """Levels of the backward-substitution DAG of an *upper*-triangular CSR
    (row ``i`` depends on columns ``j > i``).  ``compute_upper_levels(L.transpose())``
    equals :func:`compute_reverse_levels(L)`; this form exists for matrices
    that are only available in upper form (e.g. a rewritten Lᵀ).  Vectorized
    per wavefront like :func:`compute_levels`."""
    src, dst = _edge_arrays(U, upper=True)
    return _propagate_levels(U.n, src, dst)


@dataclasses.dataclass(frozen=True)
class LevelSets:
    """Rows grouped by level.

    ``level``       (n,) level id per row
    ``rows``        list over levels of row-id arrays (sorted)
    ``counts``      (num_levels,) rows per level
    """

    level: np.ndarray
    rows: List[np.ndarray]
    counts: np.ndarray

    @property
    def num_levels(self) -> int:
        return len(self.rows)

    def thin_levels(self, threshold: int) -> np.ndarray:
        """Level ids whose row count is <= threshold (the paper's thin levels;
        94% of lung2's 478 levels have only 2 rows)."""
        return np.nonzero(self.counts <= threshold)[0]

    def thin_fraction(self, threshold: int) -> float:
        return float((self.counts <= threshold).mean()) if self.num_levels else 0.0

    def histogram(self) -> dict:
        uniq, cnt = np.unique(self.counts, return_counts=True)
        return {int(u): int(c) for u, c in zip(uniq, cnt)}

    def row_permutation(self) -> np.ndarray:
        """Level-order row permutation: original row id at each position when
        rows are laid out level by level.  This is the *analysis-side* view
        of the permuted execution space; the executed permutation comes from
        :meth:`repro_torch.core.codegen.Schedule.perm` (which additionally reflects
        in-slab nnz sorting and bucket splits) — both place every level's
        rows in one contiguous span."""
        if not self.rows:
            return np.zeros(0, dtype=np.int64)
        return np.concatenate(self.rows).astype(np.int64)


def build_level_sets(L: CSRMatrix, level: np.ndarray | None = None) -> LevelSets:
    if level is None:
        level = compute_levels(L)
    num_levels = int(level.max()) + 1 if level.size else 0
    order = np.argsort(level, kind="stable")
    counts = np.bincount(level, minlength=num_levels)
    rows: List[np.ndarray] = []
    off = 0
    for lv in range(num_levels):
        c = int(counts[lv])
        rows.append(np.sort(order[off : off + c]))
        off += c
    return LevelSets(level=level, rows=rows, counts=counts)


@dataclasses.dataclass(frozen=True)
class Criticality:
    """Weighted longest-chain membership of every row (Böhnlein et al.:
    the *weighted critical path* of DAG_L bounds parallel solve time, not
    the level count).

    ``cp_in``   (n,) weight of the heaviest dependency chain ENDING at each
                row (row's own weight included)
    ``cp_out``  (n,) weight of the heaviest chain STARTING at each row
    ``weights`` (n,) per-row weights used (default: row solve FLOPs)

    ``through(i) = cp_in[i] + cp_out[i] - weights[i]`` is the heaviest
    complete chain passing through row ``i``; rows with
    ``critical_path - through(i) <= slack`` lie on (near-)critical chains —
    exactly the rows whose equation rewriting shortens the bound.
    """

    cp_in: np.ndarray
    cp_out: np.ndarray
    weights: np.ndarray

    @property
    def critical_path(self) -> int:
        return int(self.cp_in.max()) if self.cp_in.size else 0

    def through(self) -> np.ndarray:
        return self.cp_in + self.cp_out - self.weights

    def slack(self) -> np.ndarray:
        return self.critical_path - self.through()

    def near_critical(self, slack_fraction: float = 0.05) -> np.ndarray:
        """Rows whose heaviest through-chain is within ``slack_fraction`` of
        the critical path — the rewrite targets of ``policy="critical_path"``."""
        if not self.cp_in.size:
            return np.zeros(0, dtype=bool)
        return self.slack() <= slack_fraction * self.critical_path


def _offdiag_entries(M: CSRMatrix, rows: np.ndarray, upper: bool):
    """Positions of the off-diagonal (dependency) entries of ``rows`` plus
    per-row counts — the diagonal is stored last (lower) or first (upper),
    so the dependency span of every row is one contiguous slice.  Rows
    without a stored diagonal (degenerate inputs) count as dependency-free
    rather than producing negative spans."""
    lo = M.indptr[rows] + (1 if upper else 0)
    ln = np.maximum((M.indptr[rows + 1] - M.indptr[rows]) - 1, 0)
    total = int(ln.sum())
    off = np.cumsum(ln) - ln
    pos = np.repeat(lo - off, ln) + np.arange(total)
    return pos, ln


def _cp_in_from_levels(
    M: CSRMatrix, levels: "LevelSets", w: np.ndarray, *, upper: bool = False
) -> np.ndarray:
    """``cp_in`` computed one level set at a time: one gather +
    ``maximum.reduceat`` per wavefront — no edge-list sort, no in-degree
    bookkeeping.  The fast path when level sets already exist (they always
    do inside the rewrite/planner)."""
    cp = np.asarray(w, np.int64).copy()
    for rows in levels.rows[1:]:
        pos, ln = _offdiag_entries(M, rows, upper)
        has = ln > 0
        if not has.any():
            continue
        starts = (np.cumsum(ln) - ln)[has]
        best = np.maximum.reduceat(cp[M.indices[pos]], starts)
        r = rows[has]
        cp[r] = w[r] + best
    return cp


def _cp_out_from_levels(
    M: CSRMatrix, levels: "LevelSets", w: np.ndarray, *, upper: bool = False
) -> np.ndarray:
    """``cp_out`` by sweeping level sets highest-first and scattering each
    row's settled chain weight onto its dependencies (every consumer of a
    row lives in a strictly higher level, so it is settled first)."""
    cp = np.asarray(w, np.int64).copy()
    for rows in reversed(levels.rows[1:]):
        pos, ln = _offdiag_entries(M, rows, upper)
        cols = M.indices[pos]
        np.maximum.at(cp, cols, np.repeat(cp[rows], ln) + w[cols])
    return cp


def compute_criticality(
    M: CSRMatrix,
    levels: "LevelSets | None" = None,
    *,
    upper: bool = False,
    weights: np.ndarray | None = None,
) -> Criticality:
    """Weighted criticality of every row of a triangular system.  With
    ``levels`` given, both directions run as per-level-set reductions (the
    fast path); otherwise two generic wavefront propagations."""
    w = solve_weights(M) if weights is None else np.asarray(weights, np.int64)
    if levels is not None:
        return Criticality(
            cp_in=_cp_in_from_levels(M, levels, w, upper=upper),
            cp_out=_cp_out_from_levels(M, levels, w, upper=upper),
            weights=w,
        )
    src, dst = _edge_arrays(M, upper=upper)
    return Criticality(
        cp_in=_propagate_weighted(M.n, src, dst, w),
        cp_out=_propagate_weighted(M.n, dst, src, w),
        weights=w,
    )


def compute_critical_path(
    M: CSRMatrix,
    levels: "LevelSets | None" = None,
    *,
    upper: bool = False,
    weights: np.ndarray | None = None,
) -> int:
    """Weighted critical path of the substitution DAG (one forward
    propagation — cheaper than :func:`compute_criticality` when only the
    scalar bound is needed, e.g. by :func:`repro_torch.core.analysis.analyze`)."""
    if M.n == 0:
        return 0
    w = solve_weights(M) if weights is None else np.asarray(weights, np.int64)
    if levels is not None:
        return int(_cp_in_from_levels(M, levels, w, upper=upper).max())
    src, dst = _edge_arrays(M, upper=upper)
    return int(_propagate_weighted(M.n, src, dst, w).max())


def build_reverse_level_sets(
    L: CSRMatrix,
    rlevel: np.ndarray | None = None,
    *,
    forward: "LevelSets | None" = None,
) -> LevelSets:
    """Backward (``Lᵀ x = b``) level sets of a lower-triangular ``L``,
    sharing the forward analysis (see :func:`compute_reverse_levels`; pass
    ``forward`` to hit the vectorized per-wavefront derivation)."""
    if rlevel is None:
        rlevel = compute_reverse_levels(L, forward)
    return build_level_sets(L, level=rlevel)


# ---------------------------------------------------------------------------
# Supernode detection (node-granular schedules)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class SupernodeConfig:
    """Amalgamation policy for supernode detection.

    ``relax``      relative structural-mismatch budget per row pair: rows
                   ``i-1`` and ``i`` amalgamate when
                   ``|pattern(i-1) Δ pattern(i)\\{i-1}| <= relax * max(|..|)``.
                   ``0.0`` demands exact column-structure match (classic
                   supernodes); larger values admit *padded* amalgamation —
                   mismatched positions become explicit zeros in the dense
                   diagonal block (Tacho-style relaxed supernodes).  A banded
                   factor of bandwidth ``bw`` needs ``relax >= 1/(bw+1)`` for
                   interior rows to merge.
    ``max_block``  hard cap on rows per supernode — bounds the ``T x T``
                   dense diagonal block the executor inverts and applies.
    """

    relax: float = 0.25
    max_block: int = 64

    def __post_init__(self) -> None:
        if not self.relax >= 0.0:
            raise ValueError(f"relax must be non-negative, got {self.relax!r}")
        if self.max_block < 1:
            raise ValueError(f"max_block must be >= 1, got {self.max_block!r}")


@dataclasses.dataclass(frozen=True)
class Supernodes:
    """Partition of the rows into contiguous supernodes (dense blocks).

    Any contiguous run of rows of a triangular matrix is a *valid* block —
    for a lower block ``r0 .. r0+s-1`` every off-block dependency is a column
    ``< r0`` (already solved when the block runs), so detection is purely a
    profitability heuristic, never a correctness condition.  The scalar-row
    schedule is the all-singleton special case of this partition.

    ``super_of_row``  (n,) supernode id of each row
    ``block_ptr``     (num_supernodes+1,) row span of block ``k`` is
                      ``block_ptr[k] : block_ptr[k+1]``
    """

    n: int
    super_of_row: np.ndarray
    block_ptr: np.ndarray
    config: SupernodeConfig

    @property
    def num_supernodes(self) -> int:
        return len(self.block_ptr) - 1

    def sizes(self) -> np.ndarray:
        return np.diff(self.block_ptr)

    @property
    def max_block_size(self) -> int:
        return int(self.sizes().max()) if self.num_supernodes else 0

    @property
    def mean_block_size(self) -> float:
        return self.n / max(self.num_supernodes, 1)

    @property
    def dense_block_fraction(self) -> float:
        """Fraction of rows living in blocks of >= 2 rows — 0.0 when the
        blocked schedule degenerates to scalar rows."""
        if self.n == 0:
            return 0.0
        sz = self.sizes()
        return float(sz[sz >= 2].sum()) / self.n


def _pair_mismatch(M: CSRMatrix, *, upper: bool) -> np.ndarray:
    """Structural mismatch of every adjacent row pair, vectorized.

    For pair ``p`` (rows ``p-1`` and ``p``, ``p in [1, n)``) compare the sets

    * lower: A = all stored cols of row ``p-1`` (diag col ``p-1`` included),
      B = strict-lower cols of row ``p`` — equal sets mean row ``p``'s
      off-diagonal pattern is row ``p-1``'s pattern plus the in-block column,
      the classic supernode criterion;
    * upper: A = strict-upper cols of row ``p-1``, B = all stored cols of
      row ``p`` (diag col ``p`` included).

    ``mismatch[p] = |A| + |B| - 2 |A ∩ B|`` (symmetric difference).  All
    pairs at once: each (pair, col) entry keys to ``p * n + col``; both key
    arrays are duplicate-free, so one ``intersect1d(assume_unique=True)``
    plus a ``bincount`` of ``common // n`` yields every intersection size in
    O(nnz log nnz).
    """
    n = M.n
    mismatch = np.zeros(n, dtype=np.int64)
    if n <= 1:
        return mismatch
    row_nnz = M.row_nnz()
    row_of = np.repeat(np.arange(n, dtype=np.int64), row_nnz)
    strict = (M.indices > row_of) if upper else (M.indices < row_of)
    if upper:
        a_mask = strict & (row_of < n - 1)          # offdiag cols of row p-1
        b_mask = row_of >= 1                        # full cols of row p
        pair_a, pair_b = row_of + 1, row_of
        len_a = np.maximum(row_nnz[:-1] - 1, 0)
        len_b = row_nnz[1:]
    else:
        a_mask = row_of < n - 1                     # full cols of row p-1
        b_mask = strict & (row_of >= 1)             # offdiag cols of row p
        pair_a, pair_b = row_of + 1, row_of
        len_a = row_nnz[:-1]
        len_b = np.maximum(row_nnz[1:] - 1, 0)
    a_keys = pair_a[a_mask] * n + M.indices[a_mask]
    b_keys = pair_b[b_mask] * n + M.indices[b_mask]
    common = np.intersect1d(a_keys, b_keys, assume_unique=True)
    inter = np.bincount(common // n, minlength=n)[1:]
    mismatch[1:] = len_a + len_b - 2 * inter
    return mismatch


def detect_supernodes(
    M: CSRMatrix,
    *,
    upper: bool = False,
    config: SupernodeConfig | None = None,
) -> Supernodes:
    """Amalgamate contiguous runs of rows with identical (``relax=0``) or
    near-identical column structure into supernodes, fully vectorized.

    A pair merges when its structural mismatch stays within the relaxation
    budget (see :class:`SupernodeConfig`); runs are then cut every
    ``max_block`` rows.  Matrices with no amalgamatable rows degrade to the
    all-singleton partition — the scalar-row schedule."""
    cfg = config if config is not None else SupernodeConfig()
    n = M.n
    if n == 0:
        return Supernodes(n=0, super_of_row=np.zeros(0, np.int64),
                          block_ptr=np.zeros(1, np.int64), config=cfg)
    mismatch = _pair_mismatch(M, upper=upper)
    row_nnz = M.row_nnz()
    if upper:
        len_a = np.maximum(row_nnz[:-1] - 1, 0)
        len_b = row_nnz[1:]
    else:
        len_a = row_nnz[:-1]
        len_b = np.maximum(row_nnz[1:] - 1, 0)
    budget = cfg.relax * np.maximum(np.maximum(len_a, len_b), 1)
    breaks = np.ones(n, dtype=bool)
    breaks[1:] = mismatch[1:] > budget
    # cut merge runs every max_block rows: offset of each row inside its run
    run_starts = np.nonzero(breaks)[0]
    run_id = np.cumsum(breaks) - 1
    offset_in_run = np.arange(n) - run_starts[run_id]
    breaks |= (offset_in_run % cfg.max_block) == 0
    super_of_row = np.cumsum(breaks) - 1
    block_ptr = np.concatenate([np.nonzero(breaks)[0], [n]]).astype(np.int64)
    return Supernodes(n=n, super_of_row=super_of_row.astype(np.int64),
                      block_ptr=block_ptr, config=cfg)
