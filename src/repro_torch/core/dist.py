"""Distributed SpTRSV over a mesh dimension, on ``torch.distributed``.

Rows of each segment are split across the ranks of one dimension of a
:class:`~torch.distributed.device_mesh.DeviceMesh`
(:func:`repro_torch.launch.mesh.make_mesh`).  After a segment solves its
rows, the newly computed ``x`` entries are exchanged: **each segment
boundary is one collective** — the direct analogue of the paper's
per-level CPU barrier.  Equation rewriting reduces the number of levels and
schedule coarsening merges the survivors, so both shrink the collective
count.

Two exchange strategies:

* ``psum``       — every rank writes its solved rows into a zero vector of
                   the solution's length and one ``all_reduce(SUM)``
                   combines them.  Bytes/segment = O(n): the plain port of
                   "barrier".
* ``all_gather`` — each rank contributes only its ``R/ndev`` solved values;
                   bytes/segment = O(R_segment).

Row ids are host-known constants, so only solved *values* move: the full
row order every rank needs after the exchange is precomputed on the host in
:func:`shard_schedule` (an ``all_gather`` of contiguous row shards in rank
order reproduces the segment's own row array), and each rank slices its
shard out of it with its rank in the mesh dimension.  No collective ever
moves indices.

Coarsened slabs (``depth > 1``, :mod:`repro_torch.core.coarsen`) run
**replicated**: every rank computes the whole chain (thin levels are
latency-bound, so the redundant FLOPs are noise) and the solution stays
equal on every rank with **zero** collectives for those slabs.

Transpose solves (``SpTRSV.build(L, transpose=True,
strategy="distributed")``) flow through unchanged: the backward schedule
packs columns of L over the reverse level sets, and the collective count is
the number of *sharded backward segments*.

The solve is SPMD: every rank builds the same layout from the same host
arrays and calls ``solve`` with the same ``b``; ``x`` is replicated, and
every rank returns the same answer.  A rank that skips a solve leaves the
others waiting in a collective.  Each collective adds one to
:data:`collectives` (keyed by strategy), as a kernel wrapper counts its
launches.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch
import torch.distributed as dist

from ..kernels.sptrsv_level.ref import level_solve_ref, level_walk_ref
from ..kernels.sptrsv_level.table import make_level_table
from .codegen import Schedule, _upload, stack_sub_slabs
from .packed import (PackedLayout, build_packed_layout, pack_values,
                     permute_rhs, row_lengths, segment_table)

__all__ = [
    "DIST_STRATEGIES",
    "DistributedSchedule",
    "axis_size",
    "shard_schedule",
    "make_distributed_solver",
    "build_packed_dist_layout",
    "make_packed_distributed_solver",
    "all_gather_tensor",
    "collectives",
    "reset_collectives",
]

DIST_STRATEGIES = ("all_gather", "psum")

# collectives issued by the solvers of this module, per strategy
collectives = {s: 0 for s in DIST_STRATEGIES}

# torch 2.13 deprecates all_gather_into_tensor for all_gather_single (the
# same arguments); older releases have only the former.  Chosen once here.
all_gather_tensor = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor


def reset_collectives() -> None:
    for k in collectives:
        collectives[k] = 0


@dataclasses.dataclass(frozen=True)
class DistributedSchedule:
    """Per-segment slabs.

    Sharded segments are padded so the row dimension splits evenly over the
    mesh dimension; padding rows are no-ops (col 0 / val 0 / diag 1) writing
    to the scratch slot ``n`` of the x vector (length n+1).  Replicated
    segments (coarsened chains) hold the uniform *stacked* sub-slab arrays
    of :func:`repro_torch.core.codegen.stack_sub_slabs` — ``rows (d,
    Rmax)``, ``cols/vals (d, K, Rmax)``, ``diag (d, Rmax)``.  ``rows`` of a
    sharded segment is the **full** row order — the host-side precomputed
    gather order; ranks never exchange indices."""

    n: int
    ndev: int
    rows: List[np.ndarray]   # (R_pad,) sharded / (d, Rmax) replicated; pad -> n
    cols: List[np.ndarray]   # (K, R_pad) sharded / (d, K, Rmax) replicated
    vals: List[np.ndarray]
    diag: List[np.ndarray]
    replicated: List[bool]   # True: run on every rank, no collective

    @property
    def num_levels(self) -> int:
        return len(self.rows)

    @property
    def num_collectives(self) -> int:
        """Collectives per solve — sharded segments only (replicated chains
        exchange nothing; row ids never move)."""
        return sum(not r for r in self.replicated)

    def collective_bytes(self, itemsize: int = 4, strategy: str = "all_gather",
                         batch: int = 1) -> int:
        """Predicted on-wire bytes per solve (per rank, ring all-gather):
        solved values of *sharded* segments only.  A batched solve
        multiplies the payload by ``batch`` but keeps the collective
        *count* fixed."""
        if strategy == "psum":
            return self.num_collectives * 2 * (self.n + 1) * batch * itemsize
        return sum(r.size * batch * itemsize
                   for r, rep in zip(self.rows, self.replicated) if not rep)


def _pad_to(x: np.ndarray, size: int, fill) -> np.ndarray:
    pad = size - x.shape[-1]
    if pad == 0:
        return x
    width = [(0, 0)] * (x.ndim - 1) + [(0, pad)]
    return np.pad(x, width, constant_values=fill)


def shard_schedule(schedule: Schedule, ndev: int) -> DistributedSchedule:
    """Pad every depth-1 segment to a multiple of ``ndev`` rows (pad rows
    ``n`` / col 0 / val 0 / diag 1); stack every coarsened chain's
    sub-slabs and mark it replicated."""
    rows, cols, vals, diag, replicated = [], [], [], [], []
    for slab in schedule.slabs:
        if slab.depth > 1:
            r_s, c_s, v_s, d_s = stack_sub_slabs(slab, schedule.n)
            rows.append(r_s)
            cols.append(c_s)
            vals.append(v_s)
            diag.append(d_s)
            replicated.append(True)
            continue
        rpad = int(np.ceil(slab.R / ndev) * ndev)
        rows.append(_pad_to(slab.rows.astype(np.int32), rpad, schedule.n))
        cols.append(_pad_to(slab.cols, rpad, 0))
        vals.append(_pad_to(slab.vals, rpad, 0.0))
        diag.append(_pad_to(slab.diag, rpad, 1.0))
        replicated.append(False)
    return DistributedSchedule(
        n=schedule.n, ndev=ndev, rows=rows, cols=cols, vals=vals, diag=diag,
        replicated=replicated,
    )


def build_packed_dist_layout(schedule: Schedule, ndev: int) -> PackedLayout:
    """Packed layout whose sharded segments are row-padded to a multiple of
    the mesh dimension's size (chains run replicated and need no
    alignment)."""
    return build_packed_layout(
        schedule,
        pad_rows=lambda r: int(np.ceil(r / ndev) * ndev),
        pad_chain_rows=lambda r: r,
    )


def axis_size(mesh, axis: str) -> int:
    """Ranks along the mesh dimension named ``axis``."""
    names = mesh.mesh_dim_names or ()
    if axis not in names:
        raise ValueError(f"the mesh has no dimension {axis!r}; it has {names}")
    return mesh.size(names.index(axis))


def _rank_of(mesh, axis: str, strategy: str, device, ndev: int):
    """``(group, me)`` of this process in ``mesh[axis]``, after checking
    the strategy, the mesh's device type and its size."""
    if strategy not in DIST_STRATEGIES:
        raise ValueError(f"unknown dist_strategy {strategy!r}; expected one "
                         f"of {DIST_STRATEGIES}")
    dev = torch.device(device)
    if mesh.device_type != dev.type:
        raise ValueError(f"the mesh is on {mesh.device_type!r} devices; the "
                         f"solver runs on {dev.type!r}")
    if axis_size(mesh, axis) != ndev:
        raise ValueError(f"the layout is sharded {ndev} ways; mesh[{axis!r}] "
                         f"has {axis_size(mesh, axis)} ranks")
    return mesh.get_group(axis), mesh.get_local_rank(axis)


def make_distributed_solver(dsched: DistributedSchedule, mesh, axis: str = "data",
                            *, strategy: str = "all_gather", device="cuda"):
    """The distributed level-set ``solve(b)`` over ``mesh[axis]``, scatter
    layout.

    ``x`` is replicated (``n + 1`` rows, scratch slot last); per sharded
    segment each rank solves its ``R/ndev`` shard of rows and the solved
    values are exchanged — values only: the rank's row shard is a slice of
    the replicated host-precomputed row order, and the scatter after the
    exchange uses that same constant.  Replicated (coarsened) segments run
    their whole chain on every rank with no collective.  The scratch slot is
    cleared after every segment.

    ``b`` may be ``(n,)`` or ``(n, m)``: the batch axis rides through
    unsharded, so the per-segment collective moves ``R * m`` values instead
    of ``R`` — the collective *count* is unchanged."""
    n, ndev = dsched.n, dsched.ndev
    group, me = _rank_of(mesh, axis, strategy, device, ndev)
    dev = torch.device(device)
    program = []
    for rows, cols, vals, diag, rep in zip(dsched.rows, dsched.cols,
                                           dsched.vals, dsched.diag,
                                           dsched.replicated):
        if rep:
            program.append((True, tuple(
                _upload(a, dev, t) for a, t in ((rows, np.int64),
                                                (cols, np.int64),
                                                (vals, None), (diag, None)))))
            continue
        shard = rows.shape[0] // ndev
        mine = slice(me * shard, (me + 1) * shard)
        program.append((False, (_upload(rows, dev, np.int64),
                                _upload(rows[mine], dev, np.int64),
                                _upload(cols[:, mine], dev, np.int64),
                                _upload(vals[:, mine], dev),
                                _upload(diag[mine], dev))))

    def solve(b: torch.Tensor) -> torch.Tensor:
        dt, tail = b.dtype, tuple(b.shape[1:])
        bx = torch.cat([b, b.new_zeros((1,) + tail)])
        x = torch.zeros((n + 1,) + tail, dtype=dt, device=b.device)
        for rep, seg in program:
            if rep:
                rows, cols, vals, diag = seg
                vals, diag = vals.to(dt), diag.to(dt)
                for t in range(rows.shape[0]):
                    xl = level_solve_ref(x, bx.index_select(0, rows[t]),
                                         cols[t], vals[t], diag[t])
                    x.index_copy_(0, rows[t], xl)
                x[n] = 0
                continue
            rows, rows_me, cols, vals, diag = seg
            xl = level_solve_ref(x, bx.index_select(0, rows_me), cols,
                                 vals.to(dt), diag.to(dt))
            if strategy == "all_gather":
                # values only; the gathered order is the constant ``rows``
                xg = xl.new_empty((rows.shape[0],) + tail)
                all_gather_tensor(xg, xl, group=group)
                x.index_copy_(0, rows, xg)
            else:  # psum: full-vector exchange — the plain barrier port
                contrib = torch.zeros_like(x).index_copy_(0, rows_me, xl)
                dist.all_reduce(contrib, op=dist.ReduceOp.SUM, group=group)
                x += contrib
            collectives[strategy] += 1
            x[n] = 0  # clear pad-row scratch writes
        return x[:n]

    return solve


def make_packed_distributed_solver(layout: PackedLayout, mesh,
                                   axis: str = "data", *,
                                   strategy: str = "all_gather",
                                   device="cuda"):
    """Permuted-space distributed solve over ``mesh[axis]``.

    The exchange of :func:`make_distributed_solver` — one value
    ``all_gather`` (or ``all_reduce``) per *sharded* segment, replicated
    chains exchange nothing — run in permuted space: ``b`` is permuted once
    on entry, each rank solves a contiguous shard of its segment's
    positions, and the gathered window lands as one contiguous slice at the
    segment's offset (no row-id scatter).  ``psum`` zeroes the lanes at or
    past the segment's ``R`` before the sum.  A coarsened chain runs the
    ``levelset`` executor's walk (:func:`level_walk_ref`).

    Returns ``(solve(b, values), values0, repack)``: ``values0 =
    (vals_flat, diag_flat)`` on ``device`` (every rank holds the whole
    buffers and reads its shard's columns of them), and
    ``repack(target_data)`` gives the new flat arrays, so
    ``SpTRSV.refresh`` swaps values with no rebuild."""
    n_pad, ndev = layout.n_pad, axis_size(mesh, axis)
    group, me = _rank_of(mesh, axis, strategy, device, ndev)
    dev = torch.device(device)
    cols_flat = _upload(layout.cols_flat, dev, np.int64)
    perm, pos = _upload(layout.perm, dev), _upload(layout.pos, dev)
    geometry, sub_offs = segment_table(layout)
    row_len = row_lengths(layout)
    program = []
    for i, seg in enumerate(layout.segments):
        if seg.kind == "chain":
            if not int(seg.sub_offs.max()) + seg.R_pad <= n_pad:
                raise ValueError(f"chain at {seg.off}: a sub-step window "
                                 f"passes n_pad={n_pad}")
            program.append((seg, make_level_table(geometry[i: i + 1],
                                                  sub_offs, row_len, dev)))
            continue
        if seg.R_pad % ndev or seg.off + seg.R_pad > n_pad:
            raise ValueError(f"segment at {seg.off}: R_pad={seg.R_pad} does "
                             f"not split {ndev} ways inside n_pad={n_pad}")
        shard = seg.R_pad // ndev
        lo = me * shard
        mine = slice(lo, lo + shard)
        span = slice(seg.val_off, seg.val_off + seg.K * seg.R_pad)
        cols_me = cols_flat[span].view(seg.K, seg.R_pad)[:, mine].contiguous()
        lanes = torch.arange(lo, lo + shard, device=dev) < seg.R
        program.append((seg, (mine, cols_me, lanes)))

    def solve(b: torch.Tensor, values) -> torch.Tensor:
        vf, df = (v.to(b.dtype) for v in values)
        bhat = permute_rhs(b, perm, n_pad)
        x = torch.zeros_like(bhat)
        for seg, step in program:
            if seg.kind == "chain":
                level_walk_ref(x, bhat, cols_flat, vf, df, step)
                continue
            mine, cols_me, lanes = step
            o, K, Rp = seg.off, seg.K, seg.R_pad
            vals_me = vf[seg.val_off: seg.val_off + K * Rp].view(K, Rp)[:, mine]
            diag_me = df[seg.diag_off: seg.diag_off + Rp][mine]
            xl = level_solve_ref(x, bhat[o + mine.start: o + mine.stop],
                                 cols_me, vals_me, diag_me)
            if strategy == "all_gather":
                # values only, in position order: the gathered window IS
                # the segment's contiguous permuted-space slice
                all_gather_tensor(x[o: o + Rp], xl.contiguous(), group=group)
            else:  # psum: full-vector exchange — the plain barrier port
                xl = torch.where(lanes if xl.dim() == 1 else lanes[:, None],
                                 xl, 0)
                contrib = torch.zeros_like(x)
                contrib[o + mine.start: o + mine.stop] = xl
                dist.all_reduce(contrib, op=dist.ReduceOp.SUM, group=group)
                x[o: o + Rp] = contrib[o: o + Rp]
            collectives[strategy] += 1
        return x.index_select(0, pos)

    values0 = (_upload(layout.vals_flat, dev), _upload(layout.diag_flat, dev))
    return solve, values0, lambda data: pack_values(layout, data)
