"""One rank of the port's distributed solve, for ``tests/test_torch_dist.py``.

The test spawns ``world`` processes (``spawn`` start method) that each run
:func:`run_rank`: a gloo process group on a ``FileStore``, a ``("data",)``
mesh, then every case of :func:`cases` built and solved by every rank in
the same order (SPMD).  Each rank pickles its answers and collective counts
to ``<out_dir>/rank<r>.pkl`` for the parent to compare.  This module imports
the port only, never JAX: the parent computes the JAX answers."""
from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np

# matrix name -> (generator, kwargs, rewrite thin_threshold): the JAX
# tests' random factor (tests/test_core_solvers.py) and a small lung2
MATRICES = {
    "random": ("random_lower", dict(n=400, avg_offdiag=3.0, seed=4), 4),
    "lung2": ("lung2_like", dict(scale=0.02, fat_levels=4), 2),
}
TRANSFORMS = ("plain", "rewrite", "coarsen")
LAYOUTS = ("permuted", "scatter")
DIST_STRATEGIES = ("all_gather", "psum")
WIDTHS = (1, 3)


def matrix(name: str, sparse):
    """The factor ``name`` from a package's generators (``repro.sparse`` or
    ``repro_torch.sparse``), f64."""
    gen, kw, _ = MATRICES[name]
    return getattr(sparse, gen)(dtype=np.float64, **kw)


def transform_kwargs(name: str, transform: str, rewrite_config) -> dict:
    if transform == "rewrite":
        return dict(rewrite=rewrite_config(thin_threshold=MATRICES[name][2]))
    if transform == "coarsen":
        return dict(coarsen=True)
    return {}


def rhs(n: int) -> np.ndarray:
    """The ``(n, 3)`` right-hand sides of every case; a single-RHS solve
    takes column 0."""
    return np.random.default_rng(1).standard_normal((n, max(WIDTHS)))


def cases():
    for name in MATRICES:
        for transform in TRANSFORMS:
            for layout in LAYOUTS:
                for ds in DIST_STRATEGIES:
                    yield name, transform, layout, ds


def run_rank(rank: int, world: int, store: str, out_dir: str) -> None:
    import torch

    import repro_torch.sparse as tsparse
    from repro_torch.core import CSRMatrix, RewriteConfig, SpTRSV
    from repro_torch.core import dist as tdist
    from repro_torch.launch.mesh import destroy_process_group, make_mesh

    torch.set_num_threads(1)
    mesh = make_mesh((world,), ("data",), device="cpu", rank=rank,
                     store_path=store)
    answers, counts = {}, {}

    def solve(key, s, b):
        tdist.reset_collectives()
        answers[key] = s.solve(torch.from_numpy(b)).numpy()
        counts[key] = dict(tdist.collectives)

    try:
        for name, transform, layout, ds in cases():
            L = matrix(name, tsparse)
            B = rhs(L.n)
            pair = SpTRSV.build_pair(
                L, strategy="distributed", mesh=mesh, layout=layout,
                dist_strategy=ds, device="cpu",
                **transform_kwargs(name, transform, RewriteConfig))
            for s in pair:
                for m in WIDTHS:
                    b = B[:, 0].copy() if m == 1 else B
                    solve((name, transform, layout, ds, s.transpose, m), s, b)
        # refresh (in place for the permuted layout, a cold rebuild for the
        # scatter one) and guard=True, on lung2 with the default exchange
        L = matrix("lung2", tsparse)
        B = rhs(L.n)
        data = tsparse.refresh_values(L, seed=2)
        for layout in LAYOUTS:
            pair = SpTRSV.build_pair(L, strategy="distributed", mesh=mesh,
                                     layout=layout, coarsen=True,
                                     device="cpu")
            for s in pair:
                ptrs = [v.data_ptr() for v in s._values or ()]
                s.refresh(data)
                assert [v.data_ptr() for v in s._values or ()] == ptrs
                solve(("refresh", layout, s.transpose), s, B)
            fresh = SpTRSV.build_pair(
                CSRMatrix(L.indptr, L.indices, data, L.shape),
                strategy="distributed", mesh=mesh, layout=layout,
                coarsen=True, device="cpu")
            for s in fresh:
                solve(("fresh", layout, s.transpose), s, B)
            for s in SpTRSV.build_pair(L, strategy="distributed", mesh=mesh,
                                       layout=layout, guard=True,
                                       dist_strategy="psum", device="cpu"):
                solve(("guard", layout, s.transpose), s, B)
                assert s.stats()["guard"]["verified"] == 1, s.stats()["guard"]
    finally:
        destroy_process_group()
    with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump({"answers": answers, "counts": counts}, f)
