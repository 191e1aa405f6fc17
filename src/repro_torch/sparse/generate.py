"""Synthetic sparse lower-triangular matrix suite.

The SuiteSparse collection is not available offline, so we generate matrices
with controlled level structure.  ``lung2_like`` mimics the paper's lung2
(109,460 rows, 492,564 nnz, 478 levels, 94% of levels with only 2 rows): a
few fat wavefronts interleaved with long runs of thin 2-row levels.

All generators produce diagonally-dominant matrices so forward substitution
is well-conditioned (tight allclose in tests).
"""
from __future__ import annotations

import numpy as np

from ..core.csr import CSRMatrix, from_coo

__all__ = [
    "random_lower",
    "banded_lower",
    "chain_matrix",
    "lung2_like",
    "poisson2d",
    "ic0_factor",
    "refresh_values",
    "serve_traffic",
]


def _finalize(rows, cols, vals, n, dtype):
    return from_coo(rows, cols, np.asarray(vals, dtype=dtype), (n, n))


def random_lower(
    n: int, avg_offdiag: float = 3.0, seed: int = 0, dtype=np.float64
) -> CSRMatrix:
    """Random lower-triangular, ~avg_offdiag nonzeros below the diagonal per
    row, strongly diagonally dominant."""
    rng = np.random.default_rng(seed)
    rows, cols, vals = list(range(n)), list(range(n)), list(4.0 + rng.random(n))
    for i in range(1, n):
        k = min(i, rng.poisson(avg_offdiag))
        if k:
            deps = rng.choice(i, size=k, replace=False)
            for j in deps:
                rows.append(i)
                cols.append(int(j))
                vals.append(rng.normal() * 0.3)
    return _finalize(rows, cols, vals, n, dtype)


def banded_lower(n: int, bandwidth: int = 8, fill: float = 0.5, seed: int = 0,
                 dtype=np.float64) -> CSRMatrix:
    rng = np.random.default_rng(seed)
    rows, cols, vals = list(range(n)), list(range(n)), list(4.0 + rng.random(n))
    for i in range(n):
        lo = max(0, i - bandwidth)
        for j in range(lo, i):
            if rng.random() < fill:
                rows.append(i)
                cols.append(j)
                vals.append(rng.normal() * 0.3)
    return _finalize(rows, cols, vals, n, dtype)


def chain_matrix(n: int, dtype=np.float64) -> CSRMatrix:
    """Pure serial chain: row i depends only on row i-1.  n levels — the
    worst case for level-set SpTRSV."""
    rows = list(range(n)) + list(range(1, n))
    cols = list(range(n)) + list(range(0, n - 1))
    vals = [4.0] * n + [0.5] * (n - 1)
    return _finalize(rows, cols, vals, n, dtype)


def lung2_like(
    scale: float = 1.0,
    fat_levels: int = 29,
    fat_rows: int = 3770,
    thin_run: int = 16,
    seed: int = 0,
    dtype=np.float64,
) -> CSRMatrix:
    """Structural twin of lung2 (paper §V).

    Pattern: ``fat_levels`` fat wavefronts; between consecutive fat levels a
    run of ``thin_run`` thin levels of 2 chained rows each.  At scale=1.0:
    ~110k rows, ~480 levels, ~94% of levels thin with 2 rows, ~4.5 nnz/row.
    Thin rows depend on the previous thin pair (chain) plus a row of the
    nearest fat level, so equation rewriting lifts them with bounded fill.
    """
    rng = np.random.default_rng(seed)
    fat_rows = max(4, int(fat_rows * scale))
    rows, cols, vals = [], [], []
    next_id = 0
    prev_fat: np.ndarray | None = None
    prev_thin: list[int] = []

    def add(i, j, v):
        rows.append(i)
        cols.append(j)
        vals.append(v)

    for _ in range(fat_levels):
        # --- fat wavefront.  Every fat row depends on the preceding thin
        # run's tail pair (the whole wavefront waits for the thin chain —
        # this is what makes lung2 "very serial") plus 1-3 rows of the
        # previous fat wavefront.
        ids = np.arange(next_id, next_id + fat_rows)
        next_id += fat_rows
        for i in ids:
            add(i, i, 4.0 + rng.random())
            if prev_thin:
                add(i, int(prev_thin[-2 + int(rng.integers(0, 2))]), rng.normal() * 0.25)
            if prev_fat is not None:
                k = int(rng.integers(1, 4))
                for j in rng.choice(prev_fat, size=min(k, prev_fat.size), replace=False):
                    add(i, int(j), rng.normal() * 0.25)
        prev_fat = ids
        # --- thin run: pairs of rows, each pair chained to the previous pair
        prev_thin = []
        pair_prev: list[int] = []
        for _t in range(thin_run):
            pair = [next_id, next_id + 1]
            next_id += 2
            for idx, i in enumerate(pair):
                add(i, i, 4.0 + rng.random())
                if pair_prev:
                    add(i, pair_prev[idx], rng.normal() * 0.25)
                else:
                    j = int(rng.choice(prev_fat))
                    add(i, j, rng.normal() * 0.25)
                # occasional extra dep into the fat level keeps nnz/row ~4.5
                if rng.random() < 0.5:
                    j = int(rng.choice(prev_fat))
                    if j != i:
                        add(i, j, rng.normal() * 0.1)
            pair_prev = pair
            prev_thin.extend(pair)
    return _finalize(rows, cols, vals, next_id, dtype)


def refresh_values(L: CSRMatrix, seed: int = 0, scale: float = 0.3) -> np.ndarray:
    """Fresh well-conditioned values on ``L``'s sparsity pattern — the
    numeric-refactorization payload a serving tier refreshes solvers with.
    Off-diagonal entries are ``N(0, scale)``; diagonal entries (the last
    stored entry of each lower-triangular row) are shifted away from zero
    so forward substitution stays well-conditioned."""
    rng = np.random.default_rng(seed)
    data = (rng.normal(size=L.nnz) * scale).astype(L.dtype, copy=False)
    diag = L.indptr[1:] - 1
    data[diag] = np.abs(data[diag]) + 1.0
    return data


def serve_traffic(
    *,
    num_patterns: int = 3,
    num_tenants: int = 4,
    num_events: int = 200,
    refresh_fraction: float = 0.15,
    rotate_fraction: float = 0.05,
    transpose_fraction: float = 0.25,
    n: int = 96,
    avg_offdiag: float = 3.0,
    seed: int = 0,
    dtype=np.float64,
):
    """Mixed cold/warm multi-tenant workload for the solve service.

    Generates ``num_patterns`` distinct sparsity patterns (same size,
    different structure — so the registry key genuinely distinguishes
    them) and a deterministic event stream over ``num_tenants`` tenants:

    * ``{"op": "register", "tenant", "pattern", "matrix"}`` — tenant binds
      to a factor (first touch of a pattern is a registry *miss* → cold
      path; later touches are *hits*).  Rotation events re-register a
      tenant onto another pattern, which is what churns the LRU.
    * ``{"op": "solve", "tenant", "b", "transpose"}`` — one RHS vector.
    * ``{"op": "refresh", "tenant", "values"}`` — same-pattern numeric
      refresh (:func:`refresh_values` payload), the warm path.

    Returns ``(patterns, events)``; every tenant's first event is its
    initial ``register``.  The stream is reproducible from ``seed`` — the
    serve benchmark and the service tests share it.
    """
    if num_patterns < 1 or num_tenants < 1:
        raise ValueError(
            f"need >= 1 pattern and tenant; got {num_patterns} pattern(s), "
            f"{num_tenants} tenant(s)")
    rng = np.random.default_rng(seed)
    patterns = [
        random_lower(n, avg_offdiag=avg_offdiag, seed=seed + 101 * p,
                     dtype=dtype)
        for p in range(num_patterns)
    ]
    events = []
    bound = {}
    values_seed = seed + 7_000

    def register(t: int, p: int):
        nonlocal values_seed
        values_seed += 1
        m = patterns[p]
        mat = CSRMatrix(m.indptr, m.indices,
                        refresh_values(m, seed=values_seed), m.shape)
        bound[t] = p
        events.append({"op": "register", "tenant": f"tenant-{t}",
                       "pattern": p, "matrix": mat})

    for t in range(num_tenants):
        register(t, t % num_patterns)
    for _ in range(num_events):
        t = int(rng.integers(num_tenants))
        u = rng.random()
        if u < rotate_fraction and num_patterns > 1:
            p = int(rng.integers(num_patterns - 1))
            register(t, p if p < bound[t] else p + 1)  # a different pattern
        elif u < rotate_fraction + refresh_fraction:
            values_seed += 1
            m = patterns[bound[t]]
            events.append({"op": "refresh", "tenant": f"tenant-{t}",
                           "values": refresh_values(m, seed=values_seed)})
        else:
            b = rng.normal(size=n).astype(dtype, copy=False)
            events.append({"op": "solve", "tenant": f"tenant-{t}", "b": b,
                           "transpose": bool(rng.random()
                                             < transpose_fraction)})
    return patterns, events


def poisson2d(nx: int, ny: int, dtype=np.float64) -> CSRMatrix:
    """5-point Laplacian on an nx*ny grid (SPD), returned as full matrix in
    CSR (not triangular) — input to :func:`ic0_factor`."""
    n = nx * ny
    rows, cols, vals = [], [], []
    for y in range(ny):
        for x in range(nx):
            i = y * nx + x
            rows.append(i); cols.append(i); vals.append(4.0)
            for dx, dy in ((-1, 0), (1, 0), (0, -1), (0, 1)):
                xx, yy = x + dx, y + dy
                if 0 <= xx < nx and 0 <= yy < ny:
                    j = yy * nx + xx
                    rows.append(i); cols.append(j); vals.append(-1.0)
    return _finalize(rows, cols, vals, n, dtype)


def ic0_factor(A: CSRMatrix, shift: float = 0.05) -> CSRMatrix:
    """Incomplete Cholesky IC(0): lower factor L with the sparsity pattern of
    tril(A), A_shifted = A + shift*diag(A).  Classic SpTRSV workload (its
    level sets are the grid wavefronts)."""
    n = A.n
    dense_rows = {}
    for i in range(n):
        c, v = A.row(i)
        keep = c <= i
        dense_rows[i] = dict(zip(c[keep].tolist(), v[keep].tolist()))
        dense_rows[i][i] = dense_rows[i][i] * (1.0 + shift)
    Lrows = [dict() for _ in range(n)]
    for i in range(n):
        pat = sorted(dense_rows[i].keys())
        for j in pat:
            s = dense_rows[i][j]
            # s -= sum_k L[i,k] * L[j,k]  over shared k < j
            li, lj = Lrows[i], Lrows[j]
            small, big = (li, lj) if len(li) < len(lj) else (lj, li)
            for k, v in small.items():
                if k < j and k in big:
                    s -= li[k] * lj[k]
            if j < i:
                Lrows[i][j] = s / Lrows[j][j]
            else:
                Lrows[i][i] = float(np.sqrt(max(s, 1e-8)))
    rows, cols, vals = [], [], []
    for i in range(n):
        for j in sorted(Lrows[i]):
            rows.append(i); cols.append(j); vals.append(Lrows[i][j])
    return _finalize(rows, cols, vals, n, A.dtype)
