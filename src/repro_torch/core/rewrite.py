"""Equation rewriting — the paper's graph transformation (§III).

Rewriting row ``i`` using its dependency ``j`` substitutes row ``j``'s equation
into row ``i``.  Rearranged back into ``L x = b`` form (paper Fig. 3) this is
the elementary elimination

    row_i <- row_i - (L[i,j]/L[j,j]) * row_j
    b_i   <- b_i   - (L[i,j]/L[j,j]) * b_j

which breaks edge ``j -> i`` in DAG_L (adding fill-in at ``cols(row_j)``) and
lifts row ``i`` to an earlier level.  Applied to rows of *thin* levels it
empties those levels, removing their synchronization barriers (paper: lung2
478 -> 66 levels, +10% FLOPs).

Because ``b`` changes between solves, the RHS update must be replayed per
solve.  We track, for every rewritten row, its expression in the *original*
equations:  ``E`` (unit-lower-triangular, sparse) with ``b' = E b`` applied as
one fully-parallel SpMV.  Solution invariance:  ``L' x = E b  <=>  L x = b``.

Policies
--------
``policy="thin"`` (paper §V) rewrites every row of a thin level.
``policy="critical_path"`` rewrites only rows on (near-)maximal *weighted*
dependency chains (:func:`repro_torch.core.levels.compute_criticality`) — Böhnlein
et al. show the weighted critical path, not the level count, is what bounds
parallel solve time, so this policy buys the same chain-shortening for a
fraction of the fill when off-chain thin levels exist.

Engines
-------
The default engine runs *batched elimination rounds*: all rows whose
eliminations have settled sources are rewritten together with vectorized
NumPy/CSR kernels (gather original rows, substitute source rows, accumulate
by (row, col), zero-filter, materialize) — a lung2-scale rewrite builds in
milliseconds.  ``engine="loop"`` keeps the seed-era per-row dict loop as the
semantics baseline (and as the fixed-point engine for
``use_original_rows=True``, whose substitutions can reintroduce eliminable
dependencies mid-row).  Both engines make identical elimination decisions
when the fill budgets do not bind; when a budget binds, the batched engine
applies it per elimination round (conservatively, with upper-bound fill
projections) while the loop engine applies it per elimination — both respect
``max_fill_ratio``/``max_row_nnz``, partial rewrites stay exact either way.

The batched engine records its elimination rounds in array form
(:class:`RewritePlan.rounds`), so :func:`replay_rewrite_values` replays the
numeric transformation on new values of the same pattern with O(nnz)
vectorized passes — no dicts, no policy re-decisions.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from .csr import CSRMatrix, from_coo
from .levels import (
    LevelSets,
    _cp_in_from_levels,
    _propagate_levels,
    build_level_sets,
    compute_criticality,
    compute_upper_levels,
    solve_weights,
)

__all__ = [
    "RewriteConfig",
    "RewriteStats",
    "RewriteResult",
    "RewritePlan",
    "ReplayRound",
    "RewriteReplayError",
    "rewrite_matrix",
    "replay_rewrite_values",
    "POLICIES",
    "ENGINES",
]

POLICIES = ("thin", "critical_path")
ENGINES = ("auto", "vectorized", "loop")


@dataclasses.dataclass(frozen=True)
class RewriteConfig:
    """Policy for which rows to rewrite.

    ``policy="thin"``            rewrite every row of a thin level (§V)
    ``policy="critical_path"``   rewrite only rows on (near-)maximal weighted
                                 dependency chains; ``crit_slack`` is the
                                 near-criticality tolerance as a fraction of
                                 the weighted critical path
    ``engine``                   "vectorized" (batched NumPy rounds),
                                 "loop" (seed-era per-row dict loop), or
                                 "auto" (vectorized unless
                                 ``use_original_rows`` needs the loop's
                                 fixed-point semantics)
    """

    thin_threshold: int = 2         # level is thin if rows <= threshold
    max_row_nnz: int = 512          # stop rewriting a row that grows past this
    max_fill_ratio: float = 2.0     # global budget: nnz(L') <= ratio * nnz(L)
    use_original_rows: bool = False  # paper Fig.2 substitutes original
    # equations (may need chains of eliminations); False substitutes the
    # current (already-rewritten) row — one elimination per offending dep.
    pivot_tol: float = 0.0          # skip eliminations with |L_jj| <= tol
    policy: str = "thin"            # "thin" | "critical_path"
    crit_slack: float = 0.05        # near-critical slack fraction of the CP
    crit_max_level_rows: int = 32   # critical rows in wider levels stay put:
    # a wide wavefront executes for its sibling rows regardless, so
    # eliminating its critical member buys no schedule shortening — only
    # fill (and each fat->fat elimination compounds: substituting a wide
    # ancestor row grows the dependent's own weight faster than it shortens
    # the chain, measured +318% FLOPs and a *longer* weighted critical path
    # on the lung2 twin without this cap)
    engine: str = "auto"            # "auto" | "vectorized" | "loop"


@dataclasses.dataclass(frozen=True)
class RewriteStats:
    levels_before: int
    levels_after: int
    nnz_before: int
    nnz_after: int
    e_nnz_offdiag: int
    flops_before: int
    flops_after: int            # solve(L') + spmv(E) per paper-style counting
    rows_rewritten: int
    eliminations: int
    eliminations_skipped: int = 0   # pivot-skipped opportunities (|diag|<=tol)
    policy: str = "thin"
    critical_path_before: int = 0   # weighted critical path of L (FLOPs)
    critical_path_after: int = 0    # ... of L' (E's one parallel SpMV excluded)
    rewritten_rows: Optional[np.ndarray] = None  # (r,) row ids
    row_fill: Optional[np.ndarray] = None        # (r,) nnz added per row (cost)
    row_benefit: Optional[np.ndarray] = None     # (r,) weighted cp_in shortening

    @property
    def level_reduction(self) -> float:
        return 1.0 - self.levels_after / max(self.levels_before, 1)

    @property
    def flop_increase(self) -> float:
        return self.flops_after / max(self.flops_before, 1) - 1.0

    @property
    def critical_path_reduction(self) -> float:
        return 1.0 - self.critical_path_after / max(self.critical_path_before, 1)

    def summary(self) -> str:
        return (
            f"levels {self.levels_before} -> {self.levels_after} "
            f"(-{100*self.level_reduction:.1f}% barriers), "
            f"FLOPs {self.flops_before} -> {self.flops_after} "
            f"(+{100*self.flop_increase:.1f}%), "
            f"critical path {self.critical_path_before} -> "
            f"{self.critical_path_after} "
            f"(-{100*self.critical_path_reduction:.1f}%), "
            f"rows rewritten {self.rows_rewritten}, "
            f"eliminations {self.eliminations}"
            + (f" ({self.eliminations_skipped} pivot-skipped)"
               if self.eliminations_skipped else "")
        )


@dataclasses.dataclass(frozen=True)
class ReplayRound:
    """One batched elimination round in replayable array form: the rows
    rewritten this round (ascending (level, row) order — the m-store order),
    and per approved elimination its target row, pivot row, and the CSR
    position of the coefficient ``L[i, j]`` in the *original* pattern.
    Coefficients of approved eliminations are original values by
    construction (settled sources contain no eliminable columns), so a
    replay on new values recomputes every ``t = data[coef] / diag[piv]``
    without re-running the policy."""

    rows: np.ndarray        # (r,) int64 rewritten row ids
    elim_row: np.ndarray    # (e,) int64 target row per elimination
    elim_piv: np.ndarray    # (e,) int64 pivot (eliminated dependency) row
    coef_pos: np.ndarray    # (e,) int64 position of L[i, j] in original data


@dataclasses.dataclass(frozen=True)
class RewritePlan:
    """Symbolic record of the eliminations a :func:`rewrite_matrix` run
    performed.  ``rounds`` (batched engine) holds the array-form elimination
    program replayed by :func:`replay_rewrite_values` in O(nnz) vectorized
    passes; ``rows`` keeps the per-row ``(i, (j0, j1, ...))`` summary (and is
    the replay source for legacy loop-engine plans, which replay through the
    per-row dict path)."""

    rows: tuple              # ((i, (j0, j1, ...)), ...) in processing order
    use_original_rows: bool
    upper: bool
    rounds: Optional[tuple] = None   # tuple[ReplayRound, ...] — array form


class RewriteReplayError(ValueError):
    """The recorded plan does not numerically transfer to the new values
    (zero pivot, or fill produced outside the cached L' pattern — e.g. an
    exact cancellation in the original values that no longer cancels).
    Callers should fall back to a cold rebuild."""


@dataclasses.dataclass(frozen=True)
class RewriteResult:
    L: CSRMatrix            # transformed matrix L'
    E: CSRMatrix            # RHS operator, b' = E b (unit lower triangular)
    levels: LevelSets       # level sets of L'
    stats: RewriteStats
    plan: Optional[RewritePlan] = None   # replayable elimination record


# --------------------------------------------------------------------------
# policy: which rows participate in the rewrite
# --------------------------------------------------------------------------
def _participants(
    L: CSRMatrix, levels: LevelSets, config: RewriteConfig, *, upper: bool
) -> np.ndarray:
    """Boolean row mask of the rewrite participant set S.  Rows in S are
    rewritten by eliminating their dependencies in S — a row-set formulation
    that guarantees settled (already-rewritten) rows contain no eliminable
    columns, which is what lets the batched engine run one round per row
    and freeze all elimination coefficients at their original values."""
    if config.policy == "thin":
        removed = levels.counts <= config.thin_threshold
        if removed.size:
            removed[0] = False      # level 0 is always a valid destination
        return removed[levels.level]
    if config.policy == "critical_path":
        crit = compute_criticality(L, levels, upper=upper)
        narrow = levels.counts[levels.level] <= config.crit_max_level_rows
        return (crit.near_critical(config.crit_slack) & narrow
                & (levels.level > 0))
    raise ValueError(f"unknown rewrite policy {config.policy!r}; "
                     f"expected one of {POLICIES}")


# --------------------------------------------------------------------------
# shared helpers
# --------------------------------------------------------------------------
def _expand_pos(starts: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Vectorized ``concat(arange(s, s+l))`` — positions only."""
    lens = lens.astype(np.int64)
    total = int(lens.sum())
    off = np.cumsum(lens) - lens
    return np.repeat(starts.astype(np.int64) - off, lens) + np.arange(total)


def _expand_ranges(starts: np.ndarray, lens: np.ndarray):
    """Vectorized ``concat(arange(s, s+l))``: positions plus the owning
    range index per position."""
    lens = lens.astype(np.int64)
    pos = _expand_pos(starts, lens)
    owner = np.repeat(np.arange(lens.size, dtype=np.int64), lens)
    return pos, owner


def _row_dict(L: CSRMatrix, i: int) -> Dict[int, float]:
    cols, vals = L.row(i)
    return dict(zip(cols.tolist(), vals.tolist()))


def _count_pivot_skips(L: CSRMatrix, part: np.ndarray, diag: np.ndarray,
                       pivot_tol: float) -> int:
    """Pivot-skipped elimination opportunities in the original system:
    entries (i, j) with both rows in the participant set whose pivot is too
    small to divide by.  Skipping leaves the dependency in place — the row
    stays exactly solvable, it just is not lifted (regression-tested)."""
    row_of = np.repeat(np.arange(L.n, dtype=np.int64), L.row_nnz())
    m = (part[row_of] & part[L.indices] & (L.indices != row_of)
         & (np.abs(diag[L.indices]) <= pivot_tol))
    return int(np.count_nonzero(m))


# --------------------------------------------------------------------------
# batched vectorized engine
# --------------------------------------------------------------------------
def _rewrite_vectorized(
    L: CSRMatrix,
    levels: LevelSets,
    config: RewriteConfig,
    *,
    upper: bool,
    part: np.ndarray,
    diag: np.ndarray,
):
    """Batched elimination rounds (see module docstring).  Returns
    ``(Lp, E, rounds, eliminations, rows_rewritten)``."""
    n = L.n
    indptr, indices, data = L.indptr, L.indices, L.data
    level = levels.level
    elim_dep = part & (np.abs(diag) > config.pivot_tol)
    row_of = np.repeat(np.arange(n, dtype=np.int64), L.row_nnz())
    cand = part[row_of] & elim_dep[indices] & (indices != row_of)

    nnz_budget = int(config.max_fill_ratio * L.nnz)
    fill_added = 0
    eliminations = 0

    # round assignment: a row substitutes only settled sources, so its round
    # is its longest elimination-chain depth (lung2: the depth of its thin
    # run, ~16 — NOT the global level count)
    depth = _propagate_levels(n, indices[cand], row_of[cand])

    # growing store of modified rows (and their RHS/E rows)
    tainted = np.zeros(n, dtype=bool)   # rewrite truncated by a budget
    excl = np.zeros(L.nnz, dtype=bool)  # scratch: approved-elimination marks
    mpos = np.full(n, -1, dtype=np.int64)
    m_start_l, m_len_l = [], []
    m_cols = np.zeros(0, np.int64)
    m_vals = np.zeros(0, data.dtype)
    e_start_l, e_len_l = [], []
    e_cols = np.zeros(0, np.int64)
    e_vals = np.zeros(0, data.dtype)
    m_total = e_total = 0
    rounds = []

    dmax = int(depth[part].max()) if part.any() else 0
    for d in range(1, dmax + 1):
        I = np.nonzero(part & (depth == d))[0]
        if I.size == 0:
            continue
        # processing order (level asc, row asc) — the budget scan order
        I = I[np.lexsort((I, level[I]))]
        lo, hi = indptr[I], indptr[I + 1]
        cnt = (hi - lo).astype(np.int64)
        pos, erow = _expand_ranges(lo, cnt)
        ecol = indices[pos].astype(np.int64)
        is_cand = cand[pos]

        g = np.nonzero(is_cand)[0]
        el_row, el_j, el_pos = erow[g], ecol[g], pos[g]
        # per-row elimination order: dependency level desc, column asc — the
        # loop engine's "highest-level offending dep first"
        o = np.lexsort((el_j, -level[el_j], el_row))
        el_row, el_j, el_pos = el_row[o], el_j[o], el_pos[o]
        all_rows = el_row

        # A budget-truncated (tainted) source still carries eliminable
        # columns; substituting it would break this engine's invariant that
        # every approved coefficient is an original value.  Drop those
        # eliminations (the row stays exact, merely less lifted) and mark
        # the dependents tainted in turn.
        okT = ~tainted[el_j]
        el_row, el_j, el_pos = el_row[okT], el_j[okT], el_pos[okT]

        # source row length (diagonal excluded) — settled row if modified
        mp = mpos[el_j]
        src_len = ((indptr[el_j + 1] - indptr[el_j]) - 1).astype(np.int64)
        if m_len_l:
            sm0 = mp >= 0
            src_len[sm0] = _take_list(m_len_l, mp[sm0]) - 1

        # --- budgets ---------------------------------------------------
        # per-row width: emulate the loop's break-on-first-violation with an
        # upper-bound current-length projection (each elimination removes the
        # pivot entry and adds at most the source width)
        if el_row.size:
            delta = src_len - 1
            csum = np.cumsum(delta) - delta            # exclusive prefix
            row_start = np.concatenate([[True], el_row[1:] != el_row[:-1]])
            grp = np.cumsum(row_start) - 1
            base = csum[np.nonzero(row_start)[0]][grp]
            cur_len_ub = cnt[el_row] + (csum - base)
            ok = cur_len_ub <= config.max_row_nnz
            badc = np.cumsum(~ok) - (~ok)
            ok = ok & ((badc - badc[np.nonzero(row_start)[0]][grp]) == 0)
            # loose global guard only (4x the remaining fill budget, on the
            # no-cancellation upper bound) — it bounds round assembly memory;
            # the REAL global budget is applied post-assembly on exact
            # per-row fill, so overlap/cancellation credit is not lost and
            # decisions stay aligned with the loop engine near the budget
            gdelta = np.where(ok, np.maximum(delta, 0), 0)
            gcs = np.cumsum(gdelta) - gdelta
            ok &= (fill_added + gcs) <= 4 * max(nnz_budget - L.nnz, 0) + 64
            el_row, el_j, el_pos = el_row[ok], el_j[ok], el_pos[ok]
        # rows with any dropped elimination keep eliminable columns: tainted
        approved_per_row = np.bincount(el_row, minlength=I.size)
        cand_per_row = np.bincount(all_rows, minlength=I.size)
        tainted[I[approved_per_row < cand_per_row]] = True
        if el_row.size == 0:
            continue

        mp = mpos[el_j]
        t = data[el_pos] / diag[el_j]
        rew = np.zeros(I.size, dtype=bool)
        rew[el_row] = True
        rew_local = np.nonzero(rew)[0]

        # --- gather substitution sources -------------------------------
        d_off = 1 if upper else 0           # diagonal-first vs diagonal-last
        om = mp < 0
        crows, ccols, cvals = [], [], []
        erows_c, ecols_c, evals_c = [], [], []
        if om.any():
            oj = el_j[om]
            ostart = indptr[oj] + d_off
            olen = (indptr[oj + 1] - indptr[oj]) - 1
            spos, owner = _expand_ranges(ostart, olen)
            ot = t[om][owner]
            crows.append(el_row[om][owner])
            ccols.append(indices[spos].astype(np.int64))
            cvals.append(-ot * data[spos])
            # E source of an unmodified row is the unit vector δ_j
            erows_c.append(el_row[om])
            ecols_c.append(oj)
            evals_c.append(-t[om])
        mm = ~om
        if mm.any():
            mpi = mp[mm]
            mstart = _take_list(m_start_l, mpi) + d_off
            mlen = _take_list(m_len_l, mpi) - 1
            spos, owner = _expand_ranges(mstart, mlen)
            mt = t[mm][owner]
            crows.append(el_row[mm][owner])
            ccols.append(m_cols[spos])
            cvals.append(-mt * m_vals[spos])
            estart = _take_list(e_start_l, mpi)
            elen = _take_list(e_len_l, mpi)
            spos_e, owner_e = _expand_ranges(estart, elen)
            et = t[mm][owner_e]
            erows_c.append(el_row[mm][owner_e])
            ecols_c.append(e_cols[spos_e])
            evals_c.append(-et * e_vals[spos_e])

        # --- base entries: original rows minus approved eliminations ---
        excl[el_pos] = True
        drop = excl[pos]
        excl[el_pos] = False
        base_keep = rew[erow] & ~drop
        arow = np.concatenate([erow[base_keep]] + crows)
        acol = np.concatenate([ecol[base_keep]] + ccols)
        aval = np.concatenate([data[pos[base_keep]]] + cvals)

        new_cols, new_vals, new_len = _accumulate_rows(
            arow, acol, aval, I, rew_local, n)

        # --- exact global fill budget (post-assembly) -------------------
        # per-row fill is now exact (duplicates merged, zeros cancelled);
        # cut whole rows past the budget point in processing order, exactly
        # like the loop engine's pre-elimination check
        fill_r = new_len - cnt[rew_local]
        cumfill = np.cumsum(fill_r)
        row_ok = (L.nnz + fill_added + cumfill - fill_r) <= nnz_budget
        if not row_ok.all():
            tainted[I[rew_local[~row_ok]]] = True
            keep_entry = np.repeat(row_ok, new_len)
            new_cols, new_vals = new_cols[keep_entry], new_vals[keep_entry]
            el_keep = row_ok[np.searchsorted(rew_local, el_row)]
            el_row, el_j, el_pos = (el_row[el_keep], el_j[el_keep],
                                    el_pos[el_keep])
            rew_local, new_len = rew_local[row_ok], new_len[row_ok]
            rew = np.zeros(I.size, dtype=bool)
            rew[rew_local] = True
            if rew_local.size == 0:
                continue

        # E rows: base δ_i plus contributions (dropped rows filtered the
        # same way — their E row stays the unit diagonal)
        e_arow = np.concatenate([rew_local] + erows_c)
        e_acol = np.concatenate([I[rew_local]] + ecols_c)
        e_aval = np.concatenate(
            [np.ones(rew_local.size, data.dtype)] + evals_c)
        e_keep = rew[e_arow]
        e_ncols, e_nvals, e_nlen = _accumulate_rows(
            e_arow[e_keep], e_acol[e_keep], e_aval[e_keep], I, rew_local, n)

        # --- append to the modified-row store ---------------------------
        rew_rows = I[rew_local]
        starts = m_total + np.concatenate([[0], np.cumsum(new_len[:-1])]) \
            if new_len.size else np.zeros(0, np.int64)
        mpos[rew_rows] = len(m_start_l) + np.arange(rew_rows.size)
        m_start_l.extend(starts.tolist())
        m_len_l.extend(new_len.tolist())
        m_cols = np.concatenate([m_cols, new_cols])
        m_vals = np.concatenate([m_vals, new_vals])
        m_total += int(new_len.sum())
        e_starts = e_total + np.concatenate([[0], np.cumsum(e_nlen[:-1])]) \
            if e_nlen.size else np.zeros(0, np.int64)
        e_start_l.extend(e_starts.tolist())
        e_len_l.extend(e_nlen.tolist())
        e_cols = np.concatenate([e_cols, e_ncols])
        e_vals = np.concatenate([e_vals, e_nvals])
        e_total += int(e_nlen.sum())

        fill_added += int(new_len.sum() - cnt[rew_local].sum())
        eliminations += int(el_row.size)
        rounds.append(ReplayRound(
            rows=rew_rows.astype(np.int64),
            elim_row=I[el_row].astype(np.int64),
            elim_piv=el_j.astype(np.int64),
            coef_pos=el_pos.astype(np.int64),
        ))

    # --- materialize L' and E (vectorized) ------------------------------
    m_start = np.asarray(m_start_l, dtype=np.int64)
    m_len = np.asarray(m_len_l, dtype=np.int64)
    e_start = np.asarray(e_start_l, dtype=np.int64)
    e_len = np.asarray(e_len_l, dtype=np.int64)
    Lp = _materialize(L, mpos, m_start, m_len, m_cols, m_vals)
    E = _materialize_e(L, mpos, e_start, e_len, e_cols, e_vals)
    rows_rewritten = int((mpos >= 0).sum())
    return Lp, E, tuple(rounds), eliminations, rows_rewritten


def _take_list(lst, idx: np.ndarray) -> np.ndarray:
    """Fancy-index a growing python list of ints (the modified-row store
    geometry) without re-materializing it on every round."""
    if not lst:
        return np.zeros(idx.shape, dtype=np.int64)
    return np.asarray(lst, dtype=np.int64)[idx]


def _accumulate_rows(arow, acol, aval, I, rew_local, n):
    """Accumulate (local row, col, val) triplets: sum duplicates, sort by
    (row, col), drop exact zeros (diagonal exempt — the loop engine's
    ``del row[c]`` semantics).  Returns flattened cols/vals plus per-
    rewritten-row lengths aligned with ``rew_local``."""
    key = arow.astype(np.int64) * n + acol
    o = np.argsort(key, kind="stable")
    key_s, val_s = key[o], aval[o]
    first = np.concatenate([[True], key_s[1:] != key_s[:-1]]) \
        if key_s.size else np.zeros(0, bool)
    starts = np.nonzero(first)[0]
    sums = np.add.reduceat(val_s, starts) if starts.size else val_s[:0]
    ukey = key_s[starts]
    urow = ukey // n
    ucol = ukey % n
    keep = (sums != 0.0) | (ucol == I[urow])
    urow, ucol, sums = urow[keep], ucol[keep], sums[keep]
    # per rewritten-row lengths, in rew_local order
    cnt = np.bincount(urow, minlength=I.size)[rew_local].astype(np.int64)
    return ucol, sums, cnt


def _materialize(L, mpos, m_start, m_len, m_cols, m_vals) -> CSRMatrix:
    """Assemble L' from the original CSR plus the modified-row store.
    Unmodified rows are contiguous runs between (few) modified rows, so the
    bulk of the matrix moves as one slice copy per run instead of a
    per-entry gather — O(nnz(L')) with memcpy constants."""
    n = L.n
    row_len = L.row_nnz().astype(np.int64)
    mod = np.nonzero(mpos >= 0)[0]
    row_len[mod] = m_len[mpos[mod]]
    indptr = np.concatenate([[0], np.cumsum(row_len)]).astype(np.int64)
    nnz = int(indptr[-1])
    out_cols = np.empty(nnz, dtype=np.int64)
    out_vals = np.empty(nnz, dtype=L.dtype)
    if mod.size <= max(n // 16, 64):
        run_lo = np.concatenate([[0], mod + 1])
        run_hi = np.concatenate([mod, [n]])
        for a, b in zip(run_lo, run_hi):
            if a >= b:
                continue
            s0, s1 = int(L.indptr[a]), int(L.indptr[b])
            d0 = int(indptr[a])
            out_cols[d0:d0 + (s1 - s0)] = L.indices[s0:s1]
            out_vals[d0:d0 + (s1 - s0)] = L.data[s0:s1]
    else:
        # densely rewritten: per-run slicing would mean ~n tiny Python
        # copies; the vectorized gather wins
        um = np.nonzero(mpos < 0)[0]
        dpos = _expand_pos(indptr[um], row_len[um])
        spos = _expand_pos(L.indptr[um], row_len[um])
        out_cols[dpos] = L.indices[spos]
        out_vals[dpos] = L.data[spos]
    if mod.size:
        dpos = _expand_pos(indptr[mod], row_len[mod])
        spos = _expand_pos(m_start[mpos[mod]], m_len[mpos[mod]])
        out_cols[dpos] = m_cols[spos]
        out_vals[dpos] = m_vals[spos]
    return CSRMatrix(indptr, out_cols, out_vals, L.shape)


def _materialize_e(L, mpos, e_start, e_len, e_cols, e_vals) -> CSRMatrix:
    """Assemble E: unit diagonal for untouched rows, stored RHS rows for
    rewritten ones."""
    n = L.n
    row_len = np.ones(n, dtype=np.int64)
    mod = np.nonzero(mpos >= 0)[0]
    row_len[mod] = e_len[mpos[mod]]
    indptr = np.concatenate([[0], np.cumsum(row_len)]).astype(np.int64)
    nnz = int(indptr[-1])
    out_cols = np.empty(nnz, dtype=np.int64)
    out_vals = np.empty(nnz, dtype=L.dtype)
    um = np.nonzero(mpos < 0)[0]
    out_cols[indptr[um]] = um
    out_vals[indptr[um]] = 1.0
    if mod.size:
        dpos = _expand_pos(indptr[mod], row_len[mod])
        spos = _expand_pos(e_start[mpos[mod]], e_len[mpos[mod]])
        out_cols[dpos] = e_cols[spos]
        out_vals[dpos] = e_vals[spos]
    return CSRMatrix(indptr, out_cols, out_vals, L.shape)


# --------------------------------------------------------------------------
# loop engine (seed-era semantics baseline; fixed-point for original-rows)
# --------------------------------------------------------------------------
def _rewrite_loop(
    L: CSRMatrix,
    levels: LevelSets,
    config: RewriteConfig,
    *,
    upper: bool,
    part: np.ndarray,
    diag: np.ndarray,
):
    """Per-row dict elimination loop (the seed implementation, generalized
    from thin levels to an arbitrary participant set).  Kept as the
    benchmark baseline and as the engine for ``use_original_rows=True``."""
    n = L.n
    orig_level = levels.level
    nnz_budget = int(config.max_fill_ratio * L.nnz)

    mod_rows: Dict[int, Dict[int, float]] = {}
    mod_rhs: Dict[int, Dict[int, float]] = {}

    def current_row(j: int) -> Dict[int, float]:
        return mod_rows[j] if j in mod_rows else _row_dict(L, j)

    def current_rhs(j: int) -> Dict[int, float]:
        return mod_rhs[j] if j in mod_rhs else {j: 1.0}

    def source_row(j: int) -> Dict[int, float]:
        if config.use_original_rows:
            return _row_dict(L, j)
        return current_row(j)

    def source_rhs(j: int) -> Dict[int, float]:
        if config.use_original_rows:
            return {j: 1.0}
        return current_rhs(j)

    fill_added = 0
    eliminations = 0
    rows_rewritten = 0
    plan_rows: list = []   # (i, tuple(js)) — the replayable elimination log

    targets = np.nonzero(part)[0]
    targets = targets[np.lexsort((targets, orig_level[targets]))]
    # Level-ascending order: every dependency j of a participant row lives
    # in a strictly lower level, so its final (possibly rewritten) equation
    # is already settled when we reach it.
    for i in targets:
        i = int(i)
        row = _row_dict(L, i)
        rhs = {i: 1.0}
        changed = False
        js: list = []
        # Deps needing elimination: rows in the participant set.  With
        # use_original_rows=True an elimination can reintroduce such deps,
        # so loop to a fixed point; otherwise one pass suffices.
        guard = 0
        while True:
            guard += 1
            bad = [
                j
                for j in row
                if j != i
                and part[j]
                and abs(diag[j]) > config.pivot_tol
            ]
            if not bad or guard > n:
                break
            if len(row) > config.max_row_nnz or fill_added + L.nnz > nnz_budget:
                break  # budget hit: keep the partially rewritten row (still exact)
            # eliminate the highest-level offending dep first
            j = max(bad, key=lambda c: orig_level[c])
            t = row[j] / diag[j]
            before = len(row)
            for c, v in source_row(j).items():
                row[c] = row.get(c, 0.0) - t * v
                if row[c] == 0.0 and c != i:
                    del row[c]
            row.pop(j, None)  # exact cancellation of the eliminated entry
            for c, v in source_rhs(j).items():
                rhs[c] = rhs.get(c, 0.0) - t * v
                if rhs[c] == 0.0 and c != i:
                    del rhs[c]
            fill_added += len(row) - before
            eliminations += 1
            js.append(j)
            changed = True
            if not config.use_original_rows:
                # current-row elimination never reintroduces participant
                # deps (row_j was already settled); loop continues for any
                # remaining original participant deps of row i.
                continue
        if changed:
            mod_rows[i] = row
            mod_rhs[i] = rhs
            rows_rewritten += 1
            plan_rows.append((i, tuple(js)))

    # ---- materialize L' and E as CSR --------------------------------------
    r_rows, r_cols, r_vals = [], [], []
    e_rows, e_cols, e_vals = [], [], []
    for i in range(n):
        if i in mod_rows:
            items = sorted(mod_rows[i].items())
        else:
            cols, vals = L.row(i)
            items = list(zip(cols.tolist(), vals.tolist()))
        for c, v in items:
            r_rows.append(i)
            r_cols.append(c)
            r_vals.append(v)
        for c, v in sorted(current_rhs(i).items()):
            e_rows.append(i)
            e_cols.append(c)
            e_vals.append(v)

    Lp = from_coo(r_rows, r_cols, np.asarray(r_vals, dtype=L.dtype), L.shape)
    E = from_coo(e_rows, e_cols, np.asarray(e_vals, dtype=L.dtype), L.shape)
    return Lp, E, tuple(plan_rows), eliminations, rows_rewritten


# --------------------------------------------------------------------------
# public entry point
# --------------------------------------------------------------------------
def rewrite_matrix(
    L: CSRMatrix,
    levels: Optional[LevelSets] = None,
    config: RewriteConfig = RewriteConfig(),
    *,
    upper: bool = False,
) -> RewriteResult:
    """Apply the equation-rewriting transformation.

    ``upper=True`` rewrites an upper-triangular system (e.g. the transpose
    factor ``L.transpose()`` of the backward sweep, whose diagonal is stored
    first per row) over its backward-substitution levels.  The elimination
    machinery is direction-agnostic — the only invariant it needs is that a
    dependency always lives in a strictly lower level than its dependent row,
    which holds for both DAG orientations — so the transposed system reuses
    this function wholesale instead of a reverse-permuted copy of itself.
    """
    if levels is None:
        level = compute_upper_levels(L) if upper else None
        levels = build_level_sets(L, level=level)
    if config.engine not in ENGINES:
        raise ValueError(f"unknown rewrite engine {config.engine!r}; "
                         f"expected one of {ENGINES}")
    diag = L.diagonal(first=upper)
    part = _participants(L, levels, config, upper=upper)
    skipped = _count_pivot_skips(L, part, diag, config.pivot_tol)

    use_loop = (config.engine == "loop"
                or (config.engine == "auto" and config.use_original_rows))
    if use_loop:
        Lp, E, plan_rows, eliminations, rows_rewritten = _rewrite_loop(
            L, levels, config, upper=upper, part=part, diag=diag)
        plan = RewritePlan(rows=plan_rows,
                           use_original_rows=config.use_original_rows,
                           upper=upper)
    else:
        if config.use_original_rows:
            raise ValueError(
                "engine='vectorized' does not implement use_original_rows "
                "fixed-point substitution; use engine='loop' (or 'auto')")
        Lp, E, rounds, eliminations, rows_rewritten = _rewrite_vectorized(
            L, levels, config, upper=upper, part=part, diag=diag)
        plan_rows = _rounds_to_rows(rounds)
        plan = RewritePlan(rows=plan_rows, use_original_rows=False,
                           upper=upper, rounds=rounds)

    new_levels = build_level_sets(
        Lp, level=compute_upper_levels(Lp) if upper else None)

    # weighted critical path before/after + per-row cost/benefit (the
    # quantities the transform planner and the critical_path policy trade)
    cp0 = _cp_in_from_levels(L, levels, solve_weights(L), upper=upper)
    cp1 = _cp_in_from_levels(Lp, new_levels, solve_weights(Lp), upper=upper)
    rew_ids = np.asarray(sorted(i for i, _ in plan_rows), dtype=np.int64)
    row_fill = (Lp.row_nnz()[rew_ids] - L.row_nnz()[rew_ids]).astype(np.int64) \
        if rew_ids.size else np.zeros(0, np.int64)
    row_benefit = (cp0[rew_ids] - cp1[rew_ids]).astype(np.int64) \
        if rew_ids.size else np.zeros(0, np.int64)

    e_off = E.nnz - L.n
    stats = RewriteStats(
        levels_before=levels.num_levels,
        levels_after=new_levels.num_levels,
        nnz_before=L.nnz,
        nnz_after=Lp.nnz,
        e_nnz_offdiag=e_off,
        flops_before=L.solve_flops(),
        # solve(L') plus the per-solve SpMV b' = E b (2 flops per off-diag nnz)
        flops_after=Lp.solve_flops() + 2 * e_off,
        rows_rewritten=rows_rewritten,
        eliminations=eliminations,
        eliminations_skipped=skipped,
        policy=config.policy,
        critical_path_before=int(cp0.max()) if cp0.size else 0,
        critical_path_after=int(cp1.max()) if cp1.size else 0,
        rewritten_rows=rew_ids,
        row_fill=row_fill,
        row_benefit=row_benefit,
    )
    return RewriteResult(L=Lp, E=E, levels=new_levels, stats=stats, plan=plan)


def _rounds_to_rows(rounds) -> tuple:
    """Per-row ``(i, (js...))`` summary of the batched rounds, in round/
    processing order (for introspection parity with the loop engine)."""
    out = []
    for r in rounds:
        if r.elim_row.size == 0:
            continue
        first = np.concatenate(
            [[True], r.elim_row[1:] != r.elim_row[:-1]])
        starts = np.nonzero(first)[0]
        bounds = np.concatenate([starts, [r.elim_row.size]])
        for k, s in enumerate(starts):
            out.append((int(r.elim_row[s]),
                        tuple(int(j) for j in r.elim_piv[s:bounds[k + 1]])))
    return tuple(out)


# --------------------------------------------------------------------------
# value-only replay
# --------------------------------------------------------------------------
def replay_rewrite_values(
    system: CSRMatrix,
    plan: RewritePlan,
    Lp: CSRMatrix,
    E: CSRMatrix,
) -> tuple[np.ndarray, np.ndarray]:
    """Replay a recorded elimination plan on **new values** of the same
    sparsity pattern.

    ``system`` carries the original pattern with the *new* data; ``Lp``/``E``
    are the cached rewrite outputs whose patterns the new values must land
    in.  Returns ``(lp_data, e_data)`` aligned to ``Lp``/``E`` — the numeric
    half of :meth:`SpTRSV.refresh`: no level analysis, no elimination-policy
    decisions.  Array-form plans (the batched engine) replay as vectorized
    per-round passes, O(nnz) total; legacy loop-engine plans replay through
    the per-row dict path.

    Raises :class:`RewriteReplayError` when the plan does not transfer (a
    zero pivot, or fill landing outside the cached pattern — possible only
    when the *original* values produced an exact cancellation that the new
    values do not).  Callers should treat that as "rebuild cold".
    """
    if plan.rounds is not None:
        return _replay_vectorized(system, plan, Lp, E)
    return _replay_loop(system, plan, Lp, E)


def _copy_unmodified(system, M, um, out, fill_diag=None):
    """Pattern-aligned vectorized value copy for unmodified rows (with the
    pattern-drift guard), shared by both replay paths."""
    indptr = system.indptr
    cnt = (M.indptr[um + 1] - M.indptr[um]).astype(np.int64)
    if fill_diag is None:
        if not np.array_equal(cnt,
                              (indptr[um + 1] - indptr[um]).astype(np.int64)):
            raise RewriteReplayError("pattern drift in unmodified rows")
        dpos = _expand_pos(M.indptr[um], cnt)
        spos = _expand_pos(indptr[um], cnt)
        out[dpos] = system.data[spos]
    else:
        out[M.indptr[um]] = fill_diag


def _replay_vectorized(system, plan, Lp, E):
    n = system.n
    data = system.data
    indptr, indices = system.indptr, system.indices
    upper = plan.upper
    diag = system.diagonal(first=upper)
    d_off = 1 if upper else 0

    lp_data = np.zeros(Lp.nnz, dtype=data.dtype)
    e_data = np.zeros(E.nnz, dtype=data.dtype)
    mod_any = np.zeros(n, dtype=bool)
    for r in plan.rounds:
        mod_any[r.rows] = True
    um = np.nonzero(~mod_any)[0]
    _copy_unmodified(system, Lp, um, lp_data)
    _copy_unmodified(system, E, um, e_data, fill_diag=1.0)

    settled = np.zeros(n, dtype=bool)
    excl = np.zeros(system.nnz, dtype=bool)
    for r in plan.rounds:
        piv = diag[r.elim_piv]
        if np.any(piv == 0.0):
            bad = int(r.elim_piv[np.nonzero(piv == 0.0)[0][0]])
            raise RewriteReplayError(f"zero pivot at row {bad}")
        t = data[r.coef_pos] / piv
        rows = r.rows
        loc = np.full(n, -1, dtype=np.int64)
        loc[rows] = np.arange(rows.size)
        el_row = loc[r.elim_row]
        el_j = r.elim_piv

        # base entries: original rows minus the eliminated coefficients
        lo, hi = indptr[rows], indptr[rows + 1]
        cnt = (hi - lo).astype(np.int64)
        pos, erow = _expand_ranges(lo, cnt)
        excl[r.coef_pos] = True
        base_keep = ~excl[pos]
        excl[r.coef_pos] = False
        arow = [erow[base_keep]]
        acol = [indices[pos[base_keep]].astype(np.int64)]
        aval = [data[pos[base_keep]]]
        e_arow = [np.arange(rows.size, dtype=np.int64)]
        e_acol = [rows.astype(np.int64)]
        e_aval = [np.ones(rows.size, data.dtype)]

        sm = settled[el_j]
        if (~sm).any():
            oj = el_j[~sm]
            spos, owner = _expand_ranges(
                indptr[oj] + d_off, (indptr[oj + 1] - indptr[oj]) - 1)
            arow.append(el_row[~sm][owner])
            acol.append(indices[spos].astype(np.int64))
            aval.append(-t[~sm][owner] * data[spos])
            e_arow.append(el_row[~sm])
            e_acol.append(oj)
            e_aval.append(-t[~sm])
        if sm.any():
            mj = el_j[sm]
            spos, owner = _expand_ranges(
                Lp.indptr[mj] + d_off, (Lp.indptr[mj + 1] - Lp.indptr[mj]) - 1)
            arow.append(el_row[sm][owner])
            acol.append(Lp.indices[spos].astype(np.int64))
            aval.append(-t[sm][owner] * lp_data[spos])
            spos_e, owner_e = _expand_ranges(
                E.indptr[mj], E.indptr[mj + 1] - E.indptr[mj])
            e_arow.append(el_row[sm][owner_e])
            e_acol.append(E.indices[spos_e].astype(np.int64))
            e_aval.append(-t[sm][owner_e] * e_data[spos_e])

        _scatter_round(np.concatenate(arow), np.concatenate(acol),
                       np.concatenate(aval), rows, Lp, lp_data, n)
        _scatter_round(np.concatenate(e_arow), np.concatenate(e_acol),
                       np.concatenate(e_aval), rows, E, e_data, n)
        settled[rows] = True
    return lp_data, e_data


def _scatter_round(arow, acol, aval, rows, M, out, n):
    """Accumulate round triplets and scatter them into the cached pattern
    rows of ``M``; a nonzero landing outside the pattern means the plan does
    not transfer to these values."""
    key = arow.astype(np.int64) * n + acol
    o = np.argsort(key, kind="stable")
    key_s, val_s = key[o], aval[o]
    first = np.concatenate([[True], key_s[1:] != key_s[:-1]]) \
        if key_s.size else np.zeros(0, bool)
    starts = np.nonzero(first)[0]
    sums = np.add.reduceat(val_s, starts) if starts.size else val_s[:0]
    ukey = key_s[starts]

    cnt = (M.indptr[rows + 1] - M.indptr[rows]).astype(np.int64)
    cpos, cowner = _expand_ranges(M.indptr[rows], cnt)
    ckey = cowner * n + M.indices[cpos]
    idx = np.searchsorted(ckey, ukey)
    idx_c = np.clip(idx, 0, max(ckey.size - 1, 0))
    hit = (idx < ckey.size) & (ckey[idx_c] == ukey) if ckey.size \
        else np.zeros(ukey.shape, bool)
    stray = ~hit & (sums != 0.0)
    if np.any(stray):
        k = int(np.nonzero(stray)[0][0])
        i = int(rows[ukey[k] // n])
        c = int(ukey[k] % n)
        raise RewriteReplayError(
            f"row {i}: fill outside the cached pattern (col {c})")
    out[cpos[idx_c[hit]]] = sums[hit]


def _replay_loop(system, plan, Lp, E):
    """Legacy per-row dict replay for loop-engine plans."""
    n = system.n
    data = system.data
    diag = system.diagonal(first=plan.upper)
    indptr, indices = system.indptr, system.indices

    def orig_row(j: int) -> Dict[int, float]:
        lo, hi = int(indptr[j]), int(indptr[j + 1])
        return dict(zip(indices[lo:hi].tolist(), data[lo:hi].tolist()))

    mod_rows: Dict[int, Dict[int, float]] = {}
    mod_rhs: Dict[int, Dict[int, float]] = {}
    for i, js in plan.rows:
        row = orig_row(i)
        rhs = {i: 1.0}
        for j in js:
            dj = float(diag[j])
            if dj == 0.0:
                raise RewriteReplayError(f"zero pivot at row {j}")
            t = row.get(j, 0.0) / dj
            src_row = (orig_row(j) if plan.use_original_rows
                       else mod_rows.get(j) or orig_row(j))
            for c, v in src_row.items():
                row[c] = row.get(c, 0.0) - t * v
            row.pop(j, None)   # exact cancellation of the eliminated entry
            src_rhs = ({j: 1.0} if plan.use_original_rows
                       else mod_rhs.get(j, {j: 1.0}))
            for c, v in src_rhs.items():
                rhs[c] = rhs.get(c, 0.0) - t * v
        mod_rows[i] = row
        mod_rhs[i] = rhs

    # --- untouched rows: vectorized pattern-aligned copy -------------------
    is_mod = np.zeros(n, dtype=bool)
    if mod_rows:
        is_mod[list(mod_rows)] = True
    lp_data = np.zeros(Lp.nnz, dtype=data.dtype)
    e_data = np.zeros(E.nnz, dtype=data.dtype)
    um = np.nonzero(~is_mod)[0]
    _copy_unmodified(system, Lp, um, lp_data)
    e_data[E.indptr[um]] = 1.0   # unmodified rows: E row is the unit diagonal

    # --- rewritten rows: scatter the replayed dicts into the patterns ------
    for i in mod_rows:
        for M, src, out in ((Lp, mod_rows[i], lp_data),
                            (E, mod_rhs[i], e_data)):
            lo, hi = int(M.indptr[i]), int(M.indptr[i + 1])
            cols_p = M.indices[lo:hi]
            for p in range(lo, hi):
                out[p] = src.get(int(M.indices[p]), 0.0)
            extra = set(src) - set(cols_p.tolist())
            if any(src[c] != 0.0 for c in extra):
                raise RewriteReplayError(
                    f"row {i}: fill outside the cached pattern "
                    f"(cols {sorted(c for c in extra if src[c] != 0.0)})")
    return lp_data, e_data
