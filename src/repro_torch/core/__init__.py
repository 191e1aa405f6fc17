"""Host-side analysis, schedules and packed layouts, and the ``SpTRSV``
solver of the port."""
from .analysis import MatrixAnalysis, analyze
from .coarsen import (
    BlockSchedule,
    CoarsenConfig,
    CoarsenStats,
    build_block_schedule,
    coarsen_schedule,
    coarsen_stats,
)
from .codegen import LevelSlab, Schedule, build_ell, build_schedule, stack_sub_slabs
from .csr import CSRMatrix, eye_csr, from_coo, from_dense
from .levels import (
    LevelSets,
    SupernodeConfig,
    Supernodes,
    build_level_sets,
    build_reverse_level_sets,
    compute_criticality,
    compute_levels,
    compute_reverse_levels,
    compute_upper_levels,
    detect_supernodes,
)
from .packed import (
    PackedBlockedLayout,
    PackedLayout,
    PackedStats,
    build_packed_blocked_layout,
    build_packed_layout,
    pack_blocked_values,
    pack_values,
)
from .rewrite import (
    RewriteConfig,
    RewritePlan,
    RewriteReplayError,
    RewriteResult,
    RewriteStats,
    replay_rewrite_values,
    rewrite_matrix,
)
from .solver import LAYOUTS, STRATEGIES, SpTRSV

__all__ = [
    "MatrixAnalysis", "analyze",
    "BlockSchedule", "CoarsenConfig", "CoarsenStats", "build_block_schedule",
    "coarsen_schedule", "coarsen_stats",
    "LevelSlab", "Schedule", "build_ell", "build_schedule", "stack_sub_slabs",
    "CSRMatrix", "eye_csr", "from_coo", "from_dense",
    "LevelSets", "SupernodeConfig", "Supernodes", "build_level_sets",
    "build_reverse_level_sets", "compute_criticality", "compute_levels",
    "compute_reverse_levels", "compute_upper_levels", "detect_supernodes",
    "PackedBlockedLayout", "PackedLayout", "PackedStats",
    "build_packed_blocked_layout", "build_packed_layout",
    "pack_blocked_values", "pack_values",
    "RewriteConfig", "RewritePlan", "RewriteReplayError", "RewriteResult",
    "RewriteStats", "replay_rewrite_values", "rewrite_matrix",
    "LAYOUTS", "STRATEGIES", "SpTRSV",
]
