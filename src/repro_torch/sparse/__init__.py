"""Synthetic sparse lower-triangular matrices, pathological patterns and
value faults (the JAX package's generators, copied)."""
from .faults import (FAULT_KINDS, VALUE_FAULTS, diag_positions, inject_values,
                     wrong_pattern)
from .generate import (
    banded_lower,
    chain_matrix,
    ic0_factor,
    lung2_like,
    poisson2d,
    random_lower,
    refresh_values,
    serve_traffic,
)
from .pathological import PATHOLOGICAL_PATTERNS, diag_condition, pathological

__all__ = ["banded_lower", "chain_matrix", "ic0_factor", "lung2_like",
           "poisson2d", "random_lower", "refresh_values", "serve_traffic",
           "FAULT_KINDS", "VALUE_FAULTS", "diag_positions", "inject_values",
           "wrong_pattern", "PATHOLOGICAL_PATTERNS", "diag_condition",
           "pathological"]
