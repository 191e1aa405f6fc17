"""Fault-injection harness for the guarded execution layer.

Every fault a production refresh stream can deliver, as a deterministic
seeded generator — the tests use these (``tests/test_torch_guard.py``) to prove each
:class:`repro_torch.core.guard.GuardConfig` breakdown path actually fires instead
of trusting that it would:

``zero_pivot``       ``count`` diagonal entries set to exactly 0.0 — the
                     substitution divides produce inf/NaN downstream
``tiny_pivot``       diagonal entries at the dtype's smallest subnormal —
                     denormal divides that overflow the quotient
``perturb_pivot``    diagonal entries scaled by ``factor`` (default 1e-8) —
                     finite but wildly wrong pivots, the silent-corruption
                     case residual verification exists for
``nan_slab``         a contiguous run of ``slab`` stored values set to NaN
``inf_slab``         same run set to ±inf alternating
``denormal_values``  a contiguous run of off-diagonal values scaled into the
                     subnormal range — exercises flush-to-zero divergence
                     between storage precisions
``wrong_pattern``    a structurally different matrix with the same shape and
                     near-identical values — what ``refresh`` must REJECT
                     (pattern identity check), not absorb

Value faults (:func:`inject_values`) return a new ``data`` array aligned
with the source factor's CSR storage — feed it to
``SpTRSV.refresh(data, validate=False)`` to push the fault past the O(nnz)
validation scan and into the guard's breakdown machinery (with
``validate=True`` the scan rejects non-finite/zero-pivot payloads outright,
which is its own tested path).  Diagonal positions assume lower-triangular
CSR with sorted column indices (the diagonal is the last stored entry of
each row), matching :class:`repro_torch.core.csr.CSRMatrix` factors.
"""
from __future__ import annotations

import numpy as np

from ..core.csr import CSRMatrix, from_coo

__all__ = ["FAULT_KINDS", "VALUE_FAULTS", "diag_positions", "inject_values",
           "wrong_pattern"]

VALUE_FAULTS = ("zero_pivot", "tiny_pivot", "perturb_pivot", "nan_slab",
                "inf_slab", "denormal_values")
FAULT_KINDS = VALUE_FAULTS + ("wrong_pattern",)


def diag_positions(L: CSRMatrix) -> np.ndarray:
    """Indices of the diagonal entries inside ``L.data`` (lower-triangular
    CSR with sorted columns: last stored entry of every row)."""
    return np.asarray(L.indptr[1:]) - 1


def inject_values(L: CSRMatrix, kind: str, *, count: int = 2, slab: int = 8,
                  factor: float = 1e-8, seed: int = 0) -> np.ndarray:
    """Return a faulted copy of ``L.data`` (same pattern) for a value-fault
    ``kind`` from :data:`VALUE_FAULTS`.

    ``count`` pivots are hit for the pivot faults; a contiguous run of
    ``slab`` stored entries for the slab faults.  Row 0's pivot is never
    chosen (a broken root makes EVERY strategy fail identically, which
    proves nothing about downstream propagation)."""
    if kind not in VALUE_FAULTS:
        raise ValueError(f"unknown value fault {kind!r}; expected one of {VALUE_FAULTS}")
    rng = np.random.default_rng(seed)
    data = np.array(L.data, copy=True)
    dpos = diag_positions(L)
    if kind in ("zero_pivot", "tiny_pivot", "perturb_pivot"):
        rows = 1 + rng.choice(L.n - 1, size=min(count, L.n - 1),
                              replace=False)
        if kind == "zero_pivot":
            data[dpos[rows]] = 0.0
        elif kind == "tiny_pivot":
            data[dpos[rows]] = np.finfo(data.dtype).smallest_subnormal
        else:
            data[dpos[rows]] = data[dpos[rows]] * factor
        return data
    start = int(rng.integers(0, max(L.nnz - slab, 1)))
    run = np.arange(start, min(start + slab, L.nnz))
    if kind == "nan_slab":
        data[run] = np.nan
    elif kind == "inf_slab":
        data[run] = np.where(np.arange(run.size) % 2 == 0, np.inf, -np.inf)
    else:  # denormal_values: off-diagonal entries only, pivots stay sane
        off = np.setdiff1d(run, dpos, assume_unique=False)
        data[off] = (np.sign(data[off]) + (data[off] == 0)) \
            * np.finfo(data.dtype).smallest_subnormal * 2
    return data


def wrong_pattern(L: CSRMatrix, *, seed: int = 0) -> CSRMatrix:
    """A same-shape factor whose sparsity pattern differs from ``L`` by one
    extra off-diagonal entry (placed in the last row at a column it does not
    already use).  ``refresh`` must reject it with the pattern-identity
    error — silently re-packing values against a stale pattern is exactly
    the corruption class the validation layer exists to stop."""
    if L.n < 2:
        raise ValueError("need at least 2 rows to add an off-diagonal entry")
    rng = np.random.default_rng(seed)
    rows, cols = [], []
    for i in range(L.n):
        for k in range(L.indptr[i], L.indptr[i + 1]):
            rows.append(i)
            cols.append(int(L.indices[k]))
    vals = list(np.asarray(L.data))
    last = L.n - 1
    used = set(L.indices[L.indptr[last]:L.indptr[last + 1]])
    free = [c for c in range(last) if c not in used]
    if not free:
        raise ValueError("last row is already dense")
    rows.append(last)
    cols.append(int(rng.choice(free)))
    vals.append(0.125)
    return from_coo(rows, cols, np.asarray(vals, dtype=L.dtype),
                    (L.n, L.n))
