"""Shared helpers of the parity tests that hold ``repro_torch`` against the
JAX package ``repro``: small matrices made by both packages' generators,
carrying a factor and a config across, and field-by-field equality of the
symbolic artifacts (levels, schedules, packed layouts, rewrite results and
plans, supernodes and blocked schedules)."""
from __future__ import annotations

import dataclasses

import numpy as np

import repro.core.levels as j_levels
import repro.sparse as jsparse
import repro_torch.core.levels as t_levels
import repro_torch.sparse as tsparse
from repro_torch.core.csr import CSRMatrix as TorchCSR

# name -> (generator name, kwargs): small shapes of each structure class
MATRICES = {
    "lung2": ("lung2_like", dict(scale=0.02, fat_levels=4)),
    "banded": ("banded_lower", dict(n=300)),
    "chain": ("chain_matrix", dict(n=64)),
    "random": ("random_lower", dict(n=200, seed=3)),
    # a fully dense band: the one class with real supernodes (64-row caps)
    "dense_band": ("banded_lower", dict(n=300, bandwidth=8, fill=1.0)),
}

# the JAX package's own tolerances (tests/test_pallas_interpret.py)
TOL = {np.float32: dict(rtol=2e-5, atol=2e-6),
       np.float64: dict(rtol=1e-11, atol=1e-12)}


def jax_matrix(name: str, dtype=np.float64):
    gen, kw = MATRICES[name]
    return getattr(jsparse, gen)(dtype=dtype, **kw)


def to_port(L) -> TorchCSR:
    """The JAX package's factor as the port's CSRMatrix (numpy arrays)."""
    return TorchCSR.from_numpy(L.indptr, L.indices, L.data, L.shape)


def port_matrix(name: str, dtype=np.float64) -> TorchCSR:
    gen, kw = MATRICES[name]
    return getattr(tsparse, gen)(dtype=dtype, **kw)


def carry(cfg, cls):
    """A config of the JAX package (``RewriteConfig``, ``SupernodeConfig``,
    ...) as the port's class ``cls``, field by field."""
    return cls(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})


def systems(name: str, transpose: bool):
    """(JAX system, port system, JAX levels, port levels) of one direction:
    the factor and its levels, or its transpose and the backward levels."""
    Lj = jax_matrix(name)
    Lt = to_port(Lj)
    if transpose:
        return (Lj.transpose(), Lt.transpose(),
                j_levels.build_reverse_level_sets(Lj),
                t_levels.build_reverse_level_sets(Lt))
    return Lj, Lt, j_levels.build_level_sets(Lj), t_levels.build_level_sets(Lt)


def assert_same(a, b, path: str = "") -> None:
    """Exact equality of two symbolic artifacts, one from each package:
    dataclasses of the same class name field by field (by the port's field
    names), arrays with ``np.array_equal`` and equal dtype, sequences
    element-wise, anything else with ``==``.  Callables (lazy thunks) are
    skipped."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, \
            f"{path}: {type(a).__name__} != {type(b).__name__}"
        for f in dataclasses.fields(a):
            va = getattr(a, f.name)
            if callable(va):
                continue
            assert_same(va, getattr(b, f.name), f"{path}.{f.name}")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype, f"{path}: dtype {a.dtype} != {b.dtype}"
        assert np.array_equal(a, b), f"{path}: arrays differ"
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), f"{path}: length {len(a)} != {len(b)}"
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    else:
        assert a == b, f"{path}: {a!r} != {b!r}"
