"""Pathological triangular patterns (the JAX package's generators, copied).

Each generator is seeded and deterministic, and targets a structural corner
the regular suite's matrices do not reach:

``arrow``           column 0 dense + a dense last row: two-level DAG with one
                    maximal-fan-in row (K spans the whole matrix)
``dense_last_row``  identity apart from one dense final row — the widest
                    possible single-slab gather over an otherwise empty DAG
``bidiag_chain``    strict bidiagonal chain with random skip links: maximal
                    level count, 1-row levels (serial worst case)
``singleton_ladder``interleaved 1-row chains of random length anchored at
                    random earlier rows — runs of singleton levels, the
                    degenerate thin-level shape below even lung2's pairs
``power_law``       row degree ~ Zipf, preferential attachment to low ids:
                    a few huge rows over a mostly-sparse DAG (bucketing and
                    gather-unroll stress)
``near_singular``   diagonal magnitudes log-uniform over ~9 decades with a
                    few entries at the pivot-tolerance floor — conditioning
                    and pivot-skip stress
``jagged_rows``     alternating diagonal-only / far-deps-only rows — no two
                    adjacent rows share structure under any relaxation
                    below 1.0, so supernode amalgamation finds nothing (the
                    blocked executor's all-singleton degenerate case)
``extreme_scale``   diagonal magnitudes pinned at the fp32 format's edges
                    (~10^±38, plus mid decades): every value is exactly
                    representable in float64 but overflows/underflows a
                    float32 pipeline — the storage-precision stress case the
                    guarded execution layer's verification exists to catch
``denormal_pivot``  a few pivots at the float32 smallest subnormal (~1.4e-45,
                    a perfectly normal float64): flush-to-zero or
                    reduced-precision storage turns them into zero pivots
                    while the float64 oracle solves cleanly

All are lower-triangular with nonzero diagonals (solvable); ``near_singular``,
``extreme_scale`` and ``denormal_pivot`` are ill-conditioned by design, so
comparisons against an oracle must use the componentwise residual criterion
rather than forward error (see ``diag_condition``).
"""
from __future__ import annotations

import numpy as np

from ..core.csr import CSRMatrix, from_coo

__all__ = ["PATHOLOGICAL_PATTERNS", "pathological", "diag_condition"]


def _finalize(rows, cols, vals, n, dtype):
    return from_coo(rows, cols, np.asarray(vals, dtype=dtype), (n, n))


def _arrow(n: int, rng: np.random.Generator, dtype) -> CSRMatrix:
    rows = list(range(n)) + list(range(1, n - 1)) + [n - 1] * (n - 1)
    cols = list(range(n)) + [0] * (n - 2) + list(range(n - 1))
    vals = ([4.0 + rng.random()] + list(4.0 + rng.random(n - 1))
            + list(rng.normal(size=n - 2) * 0.3)
            + list(rng.normal(size=n - 1) * 0.1))
    return _finalize(rows, cols, vals, n, dtype)


def _dense_last_row(n: int, rng: np.random.Generator, dtype) -> CSRMatrix:
    rows = list(range(n)) + [n - 1] * (n - 1)
    cols = list(range(n)) + list(range(n - 1))
    vals = list(4.0 + rng.random(n)) + list(rng.normal(size=n - 1) * 0.2)
    return _finalize(rows, cols, vals, n, dtype)


def _bidiag_chain(n: int, rng: np.random.Generator, dtype) -> CSRMatrix:
    rows = list(range(n)) + list(range(1, n))
    cols = list(range(n)) + list(range(n - 1))
    vals = list(4.0 + rng.random(n)) + list(rng.normal(size=n - 1) * 0.5)
    # occasional skip link back to a random ancestor
    for i in range(2, n):
        if rng.random() < 0.2:
            j = int(rng.integers(0, i - 1))
            rows.append(i)
            cols.append(j)
            vals.append(rng.normal() * 0.2)
    return _finalize(rows, cols, vals, n, dtype)


def _singleton_ladder(n: int, rng: np.random.Generator, dtype) -> CSRMatrix:
    rows, cols, vals = list(range(n)), list(range(n)), list(4.0 + rng.random(n))
    i = 1
    while i < n:
        length = int(rng.integers(2, 9))
        anchor = int(rng.integers(0, i))
        prev = anchor
        for _ in range(length):
            if i >= n:
                break
            rows.append(i)
            cols.append(prev)
            vals.append(rng.normal() * 0.4)
            prev = i
            i += 1
    return _finalize(rows, cols, vals, n, dtype)


def _power_law(n: int, rng: np.random.Generator, dtype) -> CSRMatrix:
    rows, cols, vals = list(range(n)), list(range(n)), list(4.0 + rng.random(n))
    for i in range(1, n):
        k = min(i, int(rng.zipf(1.6)))
        if k <= 0:
            continue
        # preferential attachment to low row ids (power-law in-degree too)
        deps = np.unique(
            (rng.random(k) ** 2 * i).astype(np.int64).clip(0, i - 1))
        for j in deps:
            rows.append(i)
            cols.append(int(j))
            vals.append(rng.normal() * 0.25)
    return _finalize(rows, cols, vals, n, dtype)


def _near_singular(n: int, rng: np.random.Generator, dtype) -> CSRMatrix:
    rows, cols = list(range(n)), list(range(n))
    # diagonal magnitudes spread over ~9 decades, a few pinned at the floor
    expo = rng.uniform(-6.0, 3.0, size=n)
    expo[rng.integers(0, n, size=max(1, n // 50))] = -6.0
    diag = (10.0 ** expo) * np.where(rng.random(n) < 0.5, -1.0, 1.0)
    vals = list(diag)
    for i in range(1, n):
        for j in rng.choice(i, size=min(i, int(rng.integers(1, 4))),
                            replace=False):
            rows.append(i)
            cols.append(int(j))
            # off-diagonals scaled to the row's diagonal keep the system
            # solvable but heavily graded
            vals.append(rng.normal() * 0.3 * abs(diag[i]))
    return _finalize(rows, cols, vals, n, dtype)


def _jagged_rows(n: int, rng: np.random.Generator, dtype) -> CSRMatrix:
    """No-amalgamatable-rows pattern: odd rows are diagonal-only, even rows
    carry several dependencies that deliberately exclude row ``i-1``.  Every
    adjacent pair then mismatches by at least max(|A|, |B|) + 1 (a diag-only
    predecessor never appears in its successor's columns and vice versa), so
    the supernode similarity criterion fails for ANY relaxation below 1.0 —
    detection must degrade to all-singleton blocks and the blocked executor
    to the scalar-row case."""
    rows, cols, vals = list(range(n)), list(range(n)), list(4.0 + rng.random(n))
    for i in range(2, n, 2):
        for j in rng.choice(i - 1, size=min(i - 1, 3), replace=False):
            rows.append(i)
            cols.append(int(j))
            vals.append(rng.normal() * 0.3)
    return _finalize(rows, cols, vals, n, dtype)


def _extreme_scale(n: int, rng: np.random.Generator, dtype) -> CSRMatrix:
    """Diagonal magnitudes at the float32 format's extremes: ~10^±38 (right
    at fp32 overflow / underflow), with mid decades mixed in.  Off-diagonals
    are scaled to each row's own diagonal, which keeps the system solvable
    (|x_i| tops out near 10^38·poly(n), far inside float64 range) while any
    float32 storage of the values would overflow or flush to zero."""
    rows, cols = list(range(n)), list(range(n))
    expo = rng.choice(np.array([-38.0, -19.0, 0.0, 19.0, 38.0]), size=n)
    expo += rng.uniform(-0.5, 0.5, size=n)
    diag = (10.0 ** expo) * np.where(rng.random(n) < 0.5, -1.0, 1.0)
    vals = list(diag)
    for i in range(1, n):
        for j in rng.choice(i, size=min(i, int(rng.integers(1, 4))),
                            replace=False):
            rows.append(i)
            cols.append(int(j))
            vals.append(rng.normal() * 0.3 * abs(diag[i]))
    return _finalize(rows, cols, vals, n, dtype)


def _denormal_pivot(n: int, rng: np.random.Generator, dtype) -> CSRMatrix:
    """Well-scaled factor apart from a few pivots at the float32 smallest
    subnormal (~1.4e-45) — a perfectly ordinary float64 number the oracle
    divides by without drama, but one that flushes to exactly zero in bf16
    and sits on the flush-to-zero boundary of fp32 pipelines.  Row 0 is
    never hit (same rationale as the fault harness: a broken root proves
    nothing about propagation)."""
    rows, cols = list(range(n)), list(range(n))
    diag = (4.0 + rng.random(n)) * np.where(rng.random(n) < 0.5, -1.0, 1.0)
    k = max(2, n // 24)
    picked = 1 + rng.choice(n - 1, size=k, replace=False)
    diag[picked] = (np.float64(np.finfo(np.float32).smallest_subnormal)
                    * (1.0 + rng.random(k))
                    * np.sign(diag[picked]))
    vals = list(diag)
    for i in range(1, n):
        for j in rng.choice(i, size=min(i, int(rng.integers(1, 4))),
                            replace=False):
            rows.append(i)
            cols.append(int(j))
            vals.append(rng.normal() * 0.3)
    return _finalize(rows, cols, vals, n, dtype)


PATHOLOGICAL_PATTERNS = {
    "arrow": _arrow,
    "dense_last_row": _dense_last_row,
    "bidiag_chain": _bidiag_chain,
    "singleton_ladder": _singleton_ladder,
    "power_law": _power_law,
    "near_singular": _near_singular,
    "jagged_rows": _jagged_rows,
    "extreme_scale": _extreme_scale,
    "denormal_pivot": _denormal_pivot,
}


def pathological(kind: str, n: int = 96, seed: int = 0,
                 dtype=np.float64) -> CSRMatrix:
    """Build the named pathological pattern (see module docstring)."""
    gen = PATHOLOGICAL_PATTERNS[kind]
    return gen(n, np.random.default_rng(seed), dtype).validate()


def diag_condition(L: CSRMatrix) -> float:
    """max|diag| / min|diag| — a cheap lower bound on the triangular
    condition number, used to scale fuzz tolerances for ``near_singular``."""
    d = np.abs(L.diagonal())
    return float(d.max() / d.min())
