"""Host-side analysis, schedules and packed layouts, the ``SpTRSV`` solver
of the port, its planner, sweep and guard layers.  PCG lives in
:mod:`repro_torch.core.pcg` and is imported from there, as the JAX
package's is."""
from .analysis import MatrixAnalysis, analyze
from .calibrate import (BackendCalibration, DEFAULT_CALIBRATIONS,
                        get_calibration, load_calibrations, save_calibrations)
from .coarsen import (
    BlockSchedule,
    BlockedCandidate,
    CoarsenConfig,
    CoarsenStats,
    PlanDecision,
    RewriteCandidate,
    SweepCandidate,
    blocked_candidate,
    build_block_schedule,
    coarsen_schedule,
    coarsen_stats,
    plan_strategy,
    schedule_cost,
    should_consider_rewrite,
)
from .codegen import (LevelSlab, Schedule, build_ell, build_offdiag_ell,
                      build_schedule, stack_sub_slabs)
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
from .guard import (GuardBreakdownError, GuardConfig, GuardStats, SolveGuard,
                    repair_pivots, scan_values)
from .solver import LAYOUTS, STRATEGIES, SpTRSV
from .sweep import (SweepConfig, SweepStats, contraction_factor,
                    planned_sweeps)

__all__ = [
    "MatrixAnalysis", "analyze",
    "BackendCalibration", "DEFAULT_CALIBRATIONS", "get_calibration",
    "load_calibrations", "save_calibrations",
    "BlockSchedule", "BlockedCandidate", "CoarsenConfig", "CoarsenStats",
    "PlanDecision", "RewriteCandidate", "SweepCandidate", "blocked_candidate",
    "build_block_schedule", "coarsen_schedule", "coarsen_stats",
    "plan_strategy", "schedule_cost", "should_consider_rewrite",
    "LevelSlab", "Schedule", "build_ell", "build_offdiag_ell",
    "build_schedule", "stack_sub_slabs",
    "CSRMatrix", "eye_csr", "from_coo", "from_dense",
    "LevelSets", "SupernodeConfig", "Supernodes", "build_level_sets",
    "build_reverse_level_sets", "compute_criticality", "compute_levels",
    "compute_reverse_levels", "compute_upper_levels", "detect_supernodes",
    "PackedBlockedLayout", "PackedLayout", "PackedStats",
    "build_packed_blocked_layout", "build_packed_layout",
    "pack_blocked_values", "pack_values",
    "RewriteConfig", "RewritePlan", "RewriteReplayError", "RewriteResult",
    "RewriteStats", "replay_rewrite_values", "rewrite_matrix",
    "GuardBreakdownError", "GuardConfig", "GuardStats", "SolveGuard",
    "repair_pivots", "scan_values",
    "LAYOUTS", "STRATEGIES", "SpTRSV",
    "SweepConfig", "SweepStats", "contraction_factor", "planned_sweeps",
]
