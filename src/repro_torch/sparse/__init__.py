"""Synthetic sparse lower-triangular matrices (the JAX package's generators,
copied)."""
from .generate import (
    banded_lower,
    chain_matrix,
    ic0_factor,
    lung2_like,
    poisson2d,
    random_lower,
    refresh_values,
)

__all__ = ["banded_lower", "chain_matrix", "ic0_factor", "lung2_like",
           "poisson2d", "random_lower", "refresh_values"]
