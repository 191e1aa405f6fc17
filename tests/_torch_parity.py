"""Shared helpers of the parity tests that hold ``repro_torch`` against the
JAX package ``repro``: small matrices made by both packages' generators,
carrying a factor across, and field-by-field equality of the symbolic
artifacts."""
from __future__ import annotations

import dataclasses

import numpy as np

import repro.sparse as jsparse
import repro_torch.sparse as tsparse
from repro_torch.core.csr import CSRMatrix as TorchCSR

# name -> (generator name, kwargs): small shapes of each structure class
MATRICES = {
    "lung2": ("lung2_like", dict(scale=0.02, fat_levels=4)),
    "banded": ("banded_lower", dict(n=300)),
    "chain": ("chain_matrix", dict(n=64)),
    "random": ("random_lower", dict(n=200, seed=3)),
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


def assert_same(a, b, path: str = "") -> None:
    """Exact equality of two symbolic artifacts, one from each package:
    dataclasses field by field (by the port's field names), arrays with
    ``np.array_equal`` and equal dtype, sequences element-wise.  Callables
    (lazy thunks) are skipped."""
    if dataclasses.is_dataclass(a):
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
