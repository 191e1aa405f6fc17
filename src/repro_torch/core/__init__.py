"""Host-side analysis, schedules and packed layouts, and the ``SpTRSV``
solver of the port."""
from .analysis import MatrixAnalysis, analyze
from .coarsen import CoarsenConfig, CoarsenStats, coarsen_schedule, coarsen_stats
from .codegen import LevelSlab, Schedule, build_ell, build_schedule, stack_sub_slabs
from .csr import CSRMatrix, eye_csr, from_coo, from_dense
from .levels import (
    LevelSets,
    build_level_sets,
    build_reverse_level_sets,
    compute_levels,
    compute_reverse_levels,
    compute_upper_levels,
)
from .packed import PackedLayout, PackedStats, build_packed_layout, pack_values
from .solver import LAYOUTS, STRATEGIES, SpTRSV

__all__ = [
    "MatrixAnalysis", "analyze",
    "CoarsenConfig", "CoarsenStats", "coarsen_schedule", "coarsen_stats",
    "LevelSlab", "Schedule", "build_ell", "build_schedule", "stack_sub_slabs",
    "CSRMatrix", "eye_csr", "from_coo", "from_dense",
    "LevelSets", "build_level_sets", "build_reverse_level_sets",
    "compute_levels", "compute_reverse_levels", "compute_upper_levels",
    "PackedLayout", "PackedStats", "build_packed_layout", "pack_values",
    "LAYOUTS", "STRATEGIES", "SpTRSV",
]
