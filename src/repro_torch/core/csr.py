"""Host-side CSR containers for lower-triangular sparse matrices.

Preprocessing (DAG/level analysis) runs on host numpy — the paper's "matrix
analysis module".  Execution-side structures (ELL slabs, packed buffers) are
built by :mod:`repro_torch.core.codegen` / :mod:`repro_torch.core.packed` and
live on the solver's device as torch tensors.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Tuple

import numpy as np

__all__ = ["CSRMatrix", "from_dense", "from_coo", "eye_csr"]


@dataclasses.dataclass(frozen=True)
class CSRMatrix:
    """Compressed-sparse-row matrix (host numpy).

    ``indptr``  int64 (n+1,)
    ``indices`` int64 (nnz,)  column ids, sorted within each row
    ``data``    float (nnz,)
    ``shape``   (n, m)
    """

    indptr: np.ndarray
    indices: np.ndarray
    data: np.ndarray
    shape: Tuple[int, int]

    @classmethod
    def from_numpy(cls, indptr, indices, data, shape) -> "CSRMatrix":
        """Wrap CSR arrays given as numpy (or array-like) — how a factor
        built elsewhere (e.g. by the JAX package) is carried into the port.
        Index arrays are normalised to int64 as every consumer expects."""
        return cls(np.asarray(indptr, dtype=np.int64),
                   np.asarray(indices, dtype=np.int64),
                   np.asarray(data), (int(shape[0]), int(shape[1])))

    # -- basic properties ---------------------------------------------------
    @property
    def n(self) -> int:
        return self.shape[0]

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])

    @property
    def dtype(self):
        return self.data.dtype

    def row(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        """(cols, vals) of row ``i``."""
        lo, hi = self.indptr[i], self.indptr[i + 1]
        return self.indices[lo:hi], self.data[lo:hi]

    def row_nnz(self) -> np.ndarray:
        return np.diff(self.indptr)

    def pattern_hash(self) -> str:
        """Stable digest of the sparsity *pattern* (shape + indptr +
        indices; values excluded) — the key a serving tier uses to route
        same-pattern numeric refreshes onto already-compiled solvers
        (a solver registry keyed by pattern).

        The digest is content-based (blake2b over the canonical int64 index
        arrays), so it is stable across processes, sessions, and transports
        — unlike ``id()`` or Python ``hash()``.  Memoized per instance; the
        index arrays of a built matrix are treated as immutable, like every
        other consumer in this package treats them."""
        cached = getattr(self, "_pattern_hash", None)
        if cached is not None:
            return cached
        h = hashlib.blake2b(digest_size=16)
        h.update(np.asarray(self.shape, dtype=np.int64).tobytes())
        h.update(np.ascontiguousarray(self.indptr, dtype=np.int64).tobytes())
        h.update(np.ascontiguousarray(self.indices, dtype=np.int64).tobytes())
        digest = h.hexdigest()
        object.__setattr__(self, "_pattern_hash", digest)  # frozen dataclass
        return digest

    # -- validation ---------------------------------------------------------
    def validate(self) -> "CSRMatrix":
        n, m = self.shape
        assert self.indptr.shape == (n + 1,)
        assert self.indptr[0] == 0 and self.indptr[-1] == self.nnz
        assert np.all(np.diff(self.indptr) >= 0)
        assert self.indices.shape == self.data.shape
        if self.nnz:
            assert self.indices.min() >= 0 and self.indices.max() < m
            # sorted/unique columns within every row, O(nnz) vectorized:
            # adjacent column ids must increase except across row boundaries
            # (_pack_rows assumes the diagonal is the LAST entry of a row, so
            # an unsorted row anywhere — not just in the first 64 — would
            # silently corrupt the packed slabs).
            increasing = np.diff(self.indices) > 0
            starts = self.indptr[1:-1]
            boundary = starts[(starts > 0) & (starts < self.nnz)] - 1
            increasing[boundary] = True
            bad = np.nonzero(~increasing)[0]
            if bad.size:
                i = int(np.searchsorted(self.indptr, bad[0], side="right")) - 1
                raise AssertionError(f"row {i} columns not sorted/unique")
        return self

    def is_lower_triangular(self, *, strict_diag: bool = True) -> bool:
        """True iff all entries have col <= row and (optionally) every
        diagonal entry exists and is nonzero."""
        rows = np.repeat(np.arange(self.n), self.row_nnz())
        if np.any(self.indices > rows):
            return False
        if strict_diag:
            last = self.indptr[1:] - 1
            has_diag = (self.indptr[1:] > self.indptr[:-1]) & (
                self.indices[np.maximum(last, 0)] == np.arange(self.n)
            )
            if not np.all(has_diag):
                return False
            if np.any(self.data[last] == 0.0):
                return False
        return True

    # -- conversions ----------------------------------------------------------
    def diagonal(self, *, first: bool = False) -> np.ndarray:
        """Diagonal entries of a triangular matrix with stored diagonal.

        ``first=False`` (default) assumes lower-triangular storage — the
        diagonal is the *last* entry of each row.  ``first=True`` assumes
        upper-triangular storage (e.g. :meth:`transpose` of a lower factor) —
        the diagonal is the *first* entry of each row.
        """
        if first:
            return self.data[self.indptr[:-1]]
        last = self.indptr[1:] - 1
        return self.data[last]

    def csc_view(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """``(colptr, row_indices, data)`` — CSC arrays of this matrix, which
        are exactly the CSR arrays of its transpose.  O(nnz) (single stable
        counting pass; no lexsort), with row ids ascending within each column.
        """
        n, m = self.shape
        colptr = np.zeros(m + 1, dtype=np.int64)
        np.add.at(colptr, self.indices + 1, 1)
        colptr = np.cumsum(colptr)
        rows = np.repeat(np.arange(n, dtype=np.int64), self.row_nnz())
        order = np.argsort(self.indices, kind="stable")
        return colptr, rows[order], self.data[order]

    def transpose(self) -> "CSRMatrix":
        """CSR of the transpose (= :meth:`csc_view` rebound as CSR).  For a
        lower-triangular matrix this yields the upper-triangular factor with
        the diagonal stored *first* in each row (``diagonal(first=True)``)."""
        colptr, rows, vals = self.csc_view()
        return CSRMatrix(colptr, rows, vals, (self.shape[1], self.shape[0]))

    def to_dense(self) -> np.ndarray:
        out = np.zeros(self.shape, dtype=self.data.dtype)
        rows = np.repeat(np.arange(self.n), self.row_nnz())
        out[rows, self.indices] = self.data
        return out

    def matvec(self, v: np.ndarray) -> np.ndarray:
        rows = np.repeat(np.arange(self.n), self.row_nnz())
        out = np.zeros(self.n, dtype=np.result_type(self.data, v))
        np.add.at(out, rows, self.data * v[self.indices])
        return out

    def astype(self, dtype) -> "CSRMatrix":
        return CSRMatrix(self.indptr, self.indices, self.data.astype(dtype), self.shape)

    def memory_accesses(self) -> int:
        """Per-solve memory access count (paper's analysis metric): each nnz
        reads L.data, L.indices and x[col]; each row reads b and writes x."""
        return 3 * self.nnz + 2 * self.n

    def solve_flops(self) -> int:
        """FLOPs of one forward substitution: mul+sub per off-diagonal nnz,
        one divide per row (paper's FLOP accounting for Fig. 6)."""
        return 2 * (self.nnz - self.n) + self.n


def from_coo(rows, cols, vals, shape) -> CSRMatrix:
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    vals = np.asarray(vals)
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    # combine duplicates
    if rows.size:
        key_same = np.zeros(rows.size, dtype=bool)
        key_same[1:] = (rows[1:] == rows[:-1]) & (cols[1:] == cols[:-1])
        if key_same.any():
            grp = np.cumsum(~key_same) - 1
            out_vals = np.zeros(grp[-1] + 1, dtype=vals.dtype)
            np.add.at(out_vals, grp, vals)
            keep = ~key_same
            rows, cols, vals = rows[keep], cols[keep], out_vals
    indptr = np.zeros(shape[0] + 1, dtype=np.int64)
    np.add.at(indptr, rows + 1, 1)
    indptr = np.cumsum(indptr)
    return CSRMatrix(indptr, cols, vals, tuple(shape))


def from_dense(a: np.ndarray) -> CSRMatrix:
    n, m = a.shape
    rows, cols = np.nonzero(a)
    return from_coo(rows, cols, a[rows, cols], (n, m))


def eye_csr(n: int, dtype=np.float64) -> CSRMatrix:
    idx = np.arange(n, dtype=np.int64)
    return CSRMatrix(np.arange(n + 1, dtype=np.int64), idx, np.ones(n, dtype=dtype), (n, n))
