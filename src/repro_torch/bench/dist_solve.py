"""Distributed SpTRSV: collective count and bytes with and without
rewriting (the paper's barrier-removal story across ranks — each level
boundary is one collective): the port's mirror of the JAX package's
``benchmarks/dist_solve.py``.

On ``lung2_like(0.25)`` (f32; 0.05 with ``--small``) it builds
``strategy="distributed"`` with each exchange (``psum``, the full-vector
barrier port, and ``all_gather``, the value-only exchange), with and
without ``RewriteConfig(thin_threshold=2)``, over the mesh it is given,
and reports per solve:

* ``dist.<label>.<strategy>.levels`` — segments of the 8-way sharded
  schedule (``shard_schedule(schedule, 8)``, host only: the JAX bench's
  8-device count whatever the mesh), = collectives per solve;
* ``dist.<label>.<strategy>.bytes`` — that schedule's collective bytes;
* ``dist.<label>.<strategy>.ms`` — ms per solve on the mesh.

It checks every answer against the ``levelset`` solve and that the
collectives issued per solve equal the mesh's own ``num_collectives``.

    python -m repro_torch.bench.dist_solve [--small] [--device cpu] [--json PATH]

Without a process group it makes a world of one (``make_mesh``); run one
process per rank with ``RANK``, ``WORLD_SIZE`` and ``REPRO_TORCH_STORE``
set for more.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch
import torch.distributed as dist

from ..core import RewriteConfig, SpTRSV
from ..core import dist as tdist
from ..core.codegen import build_schedule
from ..kernels.backend import resolve_device
from ..sparse import lung2_like
from .common import emit, timeit, write_bench_json

__all__ = ["HOST_NDEV", "measure", "write_json", "run"]

# the JAX bench's device count: levels and bytes are reported for it
HOST_NDEV = 8
LABELS = (("base", None), ("rewrite", RewriteConfig(thin_threshold=2)))


def measure(mesh, *, full_scale: bool = True, device="cuda") -> dict:
    """``{label: {strategy: {levels, bytes, ms}}}`` over ``mesh["data"]``,
    with ``_n``/``_nnz`` and, per case, the collectives the mesh's solve
    issued and expected (``_collectives``)."""
    dev = resolve_device(device)
    ndev = tdist.axis_size(mesh, "data")
    print(f"== dist_solve: level collectives with/without rewriting "
          f"({dev.type}, {ndev} rank(s)) ==")
    L = lung2_like(scale=0.25 if full_scale else 0.05, dtype=np.float32)
    b = torch.from_numpy(
        np.random.default_rng(0).normal(size=L.n).astype(np.float32)).to(dev)
    results = {"_n": L.n, "_nnz": L.nnz, "_collectives": {}}
    for label, rw in LABELS:
        want = SpTRSV.build(L, strategy="levelset", rewrite=rw,
                            device=dev).solve(b).cpu().numpy()
        results[label] = {}
        for strat in tdist.DIST_STRATEGIES[::-1]:   # psum, all_gather
            s = SpTRSV.build(L, strategy="distributed", mesh=mesh,
                             dist_strategy=strat, rewrite=rw, device=dev)
            target = s.rewrite_result.L if s.rewrite_result else L
            sched = build_schedule(target)
            d = tdist.shard_schedule(sched, HOST_NDEV)
            tdist.reset_collectives()
            x = s.solve(b)
            issued = tdist.collectives[strat]
            expect = tdist.shard_schedule(sched, ndev).num_collectives
            np.testing.assert_allclose(x.cpu().numpy(), want, rtol=2e-3,
                                       atol=2e-4)
            if issued != expect:
                raise AssertionError(f"dist.{label}.{strat}: {issued} "
                                     f"collectives per solve, {expect} planned")
            t = timeit(s.solve, b, iters=3, warmup=1)
            emit(f"dist.{label}.{strat}.levels", d.num_levels,
                 note="= collectives/solve")
            emit(f"dist.{label}.{strat}.bytes", d.collective_bytes(4, strat),
                 "B/solve")
            emit(f"dist.{label}.{strat}.ms", f"{t*1e3:.2f}", "ms")
            results[label][strat] = dict(levels=d.num_levels,
                                         bytes=d.collective_bytes(4, strat),
                                         ms=t * 1e3)
            results["_collectives"][label, strat] = (issued, expect)
    print(f"  [check] answers match levelset; collectives per solve on "
          f"{ndev} rank(s): "
          + ", ".join(f"{k[0]}.{k[1]} {v[0]}"
                      for k, v in results["_collectives"].items()))
    return results


def write_json(path: str, results: dict, device="cuda") -> None:
    write_bench_json(path, "dist",
                     {label: results[label] for label, _ in LABELS},
                     backend=resolve_device(device).type, n=results["_n"],
                     nnz=results["_nnz"])


def run(*, full_scale: bool = True, json_path: str = "", device="cuda") -> dict:
    """The command line: a mesh over every rank of the process group (a
    world of one when none exists, destroyed at the end)."""
    from ..launch.mesh import destroy_process_group, make_mesh

    dev = resolve_device(device)
    owned = not dist.is_initialized()
    world = int(os.environ.get("WORLD_SIZE", 1)) if owned \
        else dist.get_world_size()
    mesh = make_mesh((world,), ("data",), device=dev)
    try:
        results = measure(mesh, full_scale=full_scale, device=dev)
        if json_path and (not dist.is_initialized() or dist.get_rank() == 0):
            write_json(json_path, results, dev)
    finally:
        if owned:
            destroy_process_group()
    return results


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true",
                    help="lung2_like(scale=0.05) instead of 0.25")
    ap.add_argument("--json", default="", help="write results JSON here")
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args()
    run(full_scale=not args.small, json_path=args.json, device=args.device)
