"""Matrix analysis module (paper §IV).

Extracts the properties the code generator consumes: size, nnz, level
structure, per-level memory-access totals/averages, thin-level fraction, and
FLOP counts.  The output feeds :mod:`repro_torch.core.codegen` (executor choice,
unroll thresholds, slab packing) and the benchmark reports.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np

from .csr import CSRMatrix
from .levels import (
    LevelSets,
    Supernodes,
    build_level_sets,
    compute_critical_path,
    detect_supernodes,
)

__all__ = ["MatrixAnalysis", "analyze"]


@dataclasses.dataclass(frozen=True)
class MatrixAnalysis:
    n: int
    nnz: int
    nnz_offdiag: int
    avg_nnz_per_row: float
    num_levels: int
    max_level_rows: int
    thin_levels_2: int              # levels with <= 2 rows (paper's metric)
    thin_fraction_2: float
    level_counts: np.ndarray
    mem_accesses_total: int
    mem_accesses_per_level: np.ndarray
    mem_accesses_per_level_avg: float
    solve_flops: int
    serial_fraction: float          # rows on the critical path / n
    # weighted-critical-path thunk: the per-level propagation costs
    # O(num_levels) Python iterations, which chain-like matrices (levels ~ n)
    # would pay on EVERY build — so it runs lazily, on first access (the
    # transform planner, rewrite pricing, and stats() are the consumers)
    _cp_thunk: Optional[Callable[[], int]] = dataclasses.field(
        default=None, repr=False, compare=False)
    _cp_cache: Optional[int] = dataclasses.field(
        default=None, repr=False, compare=False)
    # supernode-detection thunk: same lazy pattern — amalgamation is
    # O(nnz log nnz) and only report() / SpTRSV.stats() consume it
    _sn_thunk: Optional[Callable[[], Supernodes]] = dataclasses.field(
        default=None, repr=False, compare=False)
    _sn_cache: Optional[Supernodes] = dataclasses.field(
        default=None, repr=False, compare=False)

    @property
    def critical_path_flops(self) -> int:
        """Weighted critical path of the dependency DAG (Böhnlein et al.) —
        computed lazily on first access and cached."""
        if self._cp_cache is None:
            cp = self._cp_thunk() if self._cp_thunk is not None else 0
            object.__setattr__(self, "_cp_cache", cp)
        return self._cp_cache

    @property
    def supernodes(self) -> Optional[Supernodes]:
        """Supernode partition at the default relaxation (lazy, cached);
        ``None`` when the analysis was built without a matrix handle."""
        if self._sn_cache is None and self._sn_thunk is not None:
            object.__setattr__(self, "_sn_cache", self._sn_thunk())
        return self._sn_cache

    @property
    def supernode_count(self) -> int:
        sn = self.supernodes
        return sn.num_supernodes if sn is not None else self.n

    @property
    def mean_block_size(self) -> float:
        sn = self.supernodes
        return sn.mean_block_size if sn is not None else 1.0

    @property
    def dense_block_fraction(self) -> float:
        sn = self.supernodes
        return sn.dense_block_fraction if sn is not None else 0.0

    @property
    def critical_fraction(self) -> float:
        """critical_path_flops / solve_flops — 1.0 for a pure chain."""
        return self.critical_path_flops / max(self.solve_flops, 1)

    def report(self) -> Dict:
        return {
            "n": self.n,
            "nnz": self.nnz,
            "avg_nnz_per_row": round(self.avg_nnz_per_row, 3),
            "num_levels": self.num_levels,
            "max_level_rows": self.max_level_rows,
            "thin_levels(<=2 rows)": self.thin_levels_2,
            "thin_fraction": round(self.thin_fraction_2, 4),
            "mem_accesses_total": self.mem_accesses_total,
            "mem_accesses_per_level_avg": round(self.mem_accesses_per_level_avg, 1),
            "solve_flops": self.solve_flops,
            "serial_fraction": round(self.serial_fraction, 6),
            "critical_path_flops": self.critical_path_flops,
            "critical_fraction": round(self.critical_fraction, 6),
            "supernode_count": self.supernode_count,
            "mean_block_size": round(self.mean_block_size, 3),
            "dense_block_fraction": round(self.dense_block_fraction, 4),
        }

    def pretty(self) -> str:
        return "\n".join(f"{k:>28s}: {v}" for k, v in self.report().items())

    def traffic_bytes(self, itemsize: int = 4, index_size: int = 4) -> Dict:
        """Per-solve streaming-traffic floor implied by the analysis: matrix
        values + column indices + the solution/RHS vectors, in bytes.  The
        packed permuted layout approaches this floor (one flat value stream,
        contiguous b̂/x̂ slices); ``SpTRSV.stats()`` reports the *actual*
        packed-buffer bytes including padding for comparison."""
        return {
            "value_bytes": self.nnz * itemsize,
            "index_bytes": self.nnz_offdiag * index_size,
            "vector_bytes": 2 * self.n * itemsize,
        }


def analyze(
    L: CSRMatrix, levels: Optional[LevelSets] = None, *, upper: bool = False
) -> MatrixAnalysis:
    """Analyze a triangular system.  ``upper=True`` marks an
    upper-triangular matrix (a transpose-solve system, diagonal stored
    first) so the dependency edges of the weighted critical path point the
    right way; every other metric is direction-agnostic."""
    if levels is None:
        levels = build_level_sets(L)
    row_nnz = L.row_nnz()
    counts = levels.counts
    # per-level memory accesses: 3 per nnz (L.data, L.indices, x[col]) plus
    # 2 per row (read b, write x) — the paper's analysis-module metric.
    # One bincount over level ids instead of a Python loop over levels.
    per_level = 3 * np.bincount(
        levels.level, weights=row_nnz, minlength=levels.num_levels
    ).astype(np.int64) + 2 * counts.astype(np.int64)
    thin2 = int((counts <= 2).sum())
    solve_flops = L.solve_flops()
    return MatrixAnalysis(
        n=L.n,
        nnz=L.nnz,
        nnz_offdiag=L.nnz - L.n,
        avg_nnz_per_row=L.nnz / max(L.n, 1),
        num_levels=levels.num_levels,
        max_level_rows=int(counts.max()) if counts.size else 0,
        thin_levels_2=thin2,
        thin_fraction_2=thin2 / max(levels.num_levels, 1),
        level_counts=counts,
        mem_accesses_total=L.memory_accesses(),
        mem_accesses_per_level=per_level,
        mem_accesses_per_level_avg=float(per_level.mean()) if per_level.size else 0.0,
        solve_flops=solve_flops,
        serial_fraction=levels.num_levels / max(L.n, 1),
        _cp_thunk=lambda: compute_critical_path(L, levels, upper=upper),
        _sn_thunk=lambda: detect_supernodes(L, upper=upper),
    )
