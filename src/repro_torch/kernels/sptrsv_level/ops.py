"""Permuted-space packed level-scheduled solve on the level kernel
(``strategy="pallas_level"``).

:func:`make_packed_solver` packs a :class:`Schedule` with the kernel's row
padding (the same geometry as the JAX package's ``sptrsv_level`` packing)
and turns every segment into one launch: a plain segment over as many
blocks as it needs, a coarsened chain on one block that walks its
``depth`` sub-steps (:func:`repro_torch.core.packed.level_table`, which
also holds each row's count of real entries).  The table is built once; a
solve hands it to :func:`level_solve`, which launches the CUDA kernels for
tensors on the card and runs the plain torch version for tensors on the
CPU.

:func:`make_solver` is the scatter layout (``layout="scatter"``), the JAX
package's ``make_solver``: every wavefront (a coarsened chain's sub-steps
one by one) gathers ``b`` at its row ids, runs the TPU kernel's function
on its slab and scatters the result into ``x`` by row id, with the values
fixed at build.  :func:`level_scatter` launches it for tensors on the card
and runs the plain torch version for tensors on the CPU.

Direction-agnostic: a backward (transpose) schedule runs through the same
kernel.
"""
from __future__ import annotations

import numpy as np
import torch

from ...core.codegen import Schedule, stack_sub_slabs
from ...core.packed import build_packed_layout, level_table, pack_values, permute_rhs
from ..backend import resolve_device
from . import cuda
from .ref import level_scatter_ref, level_walk_ref
from .table import LevelTable, ScatterTable, make_scatter_table

__all__ = ["make_packed_solver", "level_solve", "make_solver", "level_scatter"]


def _ceil_to(v: int, m: int) -> int:
    return int(np.ceil(v / m) * m) if v else m


def level_solve(x, bhat, cols, vals, diag, table: LevelTable) -> None:
    """Run the table's segments in place into ``x``: the CUDA kernels for
    tensors on the card, the plain torch version for tensors on the CPU."""
    if x.is_cuda:
        cuda.level_walk(x, bhat, cols, vals, diag, table)
    elif x.device.type == "cpu":
        level_walk_ref(x, bhat, cols, vals, diag, table)
    else:
        raise ValueError(f"no level kernel for device {x.device}")


def make_packed_solver(schedule: Schedule, *, device="cuda",
                       block_rows: int = 512):
    """Returns ``(solve(b, values), values0, repack, layout)``.

    ``values0`` are the packed ``(vals_flat, diag_flat)`` tensors on
    ``device``; ``repack(data)`` re-packs new matrix data of the same
    pattern as numpy arrays of the same shapes."""
    dev = resolve_device(device)

    def _pad(r):
        return _ceil_to(r, block_rows if r > block_rows // 4 else 128)

    layout = build_packed_layout(
        schedule, pad_rows=_pad, pad_chain_rows=_pad,
        block_rows_for=lambda rp: min(block_rows, rp))
    n_pad = layout.n_pad
    n_x = _ceil_to(n_pad, 128)
    # A CUDA gather does not clip: every column position must lie in x̂.
    if layout.cols_flat.size and int(layout.cols_flat.max()) >= n_x:
        raise RuntimeError("packed column position outside x̂")
    table = level_table(layout, dev)
    # int32 positions for the kernel, int64 for torch indexing on the CPU
    cols_np = layout.cols_flat if dev.type == "cuda" \
        else layout.cols_flat.astype(np.int64)
    cols = torch.from_numpy(cols_np).to(dev)
    perm = torch.from_numpy(layout.perm).to(dev)
    pos = torch.from_numpy(layout.pos).to(dev)
    values0 = (torch.from_numpy(layout.vals_flat).to(dev),
               torch.from_numpy(layout.diag_flat).to(dev))

    def repack(data):
        return pack_values(layout, data)

    def solve(b: torch.Tensor, values) -> torch.Tensor:
        vals_flat, diag_flat = values
        dt = b.dtype
        vf = vals_flat.to(dt)
        df = diag_flat.to(dt)
        bhat = permute_rhs(b, perm, n_pad)
        x = torch.zeros((n_x,) + tuple(b.shape[1:]), dtype=dt, device=b.device)
        level_solve(x, bhat, cols, vf, df, table)
        return x.index_select(0, pos)

    return solve, values0, repack, layout


def level_scatter(x, b_ext, rows, cols, vals, diag, table: ScatterTable) -> None:
    """Run a scatter solve's steps in place into ``x``: the CUDA kernels for
    tensors on the card, the plain torch version for tensors on the CPU."""
    if x.is_cuda:
        cuda.level_scatter(x, b_ext, rows, cols, vals, diag, table)
    elif x.device.type == "cpu":
        level_scatter_ref(x, b_ext, rows, cols, vals, diag, table)
    else:
        raise ValueError(f"no level kernel for device {x.device}")


def _scatter_steps(schedule: Schedule, block_rows: int):
    """The JAX package's per-segment padding of a schedule, flattened: one
    ``(rows (R_pad,), cols (K, R_pad), vals, diag)`` per wavefront, pad rows
    carrying the row id ``n``, pad slots column 0 and value 0, pad diagonal
    1; a chain is stacked to its widest sub-slab and padded as one."""
    n = schedule.n
    for slab in schedule.slabs:
        if slab.depth > 1:
            rows_s, cols_s, vals_s, diag_s = stack_sub_slabs(slab, n)
        else:
            rows_s, cols_s, vals_s, diag_s = (
                slab.rows[None], slab.cols[None], slab.vals[None], slab.diag[None])
        d, K, r = cols_s.shape
        R_pad = _ceil_to(r, block_rows if r > block_rows // 4 else 128)
        for t in range(d):
            rows = np.full((R_pad,), n, dtype=np.int32)
            rows[:r] = rows_s[t]
            cols = np.zeros((K, R_pad), np.int32)
            cols[:, :r] = cols_s[t]
            vals = np.zeros((K, R_pad), slab.vals.dtype)
            vals[:, :r] = vals_s[t]
            diag = np.ones((R_pad,), slab.diag.dtype)
            diag[:r] = diag_s[t]
            yield rows, cols, vals, diag


def make_solver(schedule: Schedule, *, device="cuda", block_rows: int = 512):
    """Scatter-layout solve ``solve(b)`` on the level kernel, one launch per
    wavefront, with the schedule's values fixed at build.  ``b`` is
    ``(n,)`` or ``(n, m)`` on ``device``; the values are cast to its dtype.
    ``solve.table`` is the :class:`ScatterTable`, ``solve.buffers`` the
    flat ``(rows, cols, vals, diag)`` step buffers and ``solve.n_pad`` the
    length of ``x``."""
    dev = resolve_device(device)
    n = schedule.n
    n_pad = _ceil_to(n + 1, 128)
    geo, rows_b, cols_b, vals_b, diag_b = [], [], [], [], []
    voff = doff = 0
    for rows, cols, vals, diag in _scatter_steps(schedule, block_rows):
        K, R_pad = cols.shape
        geo.append((K, R_pad, voff, doff))
        rows_b.append(rows)
        cols_b.append(cols.ravel())
        vals_b.append(vals.ravel())
        diag_b.append(diag)
        voff += K * R_pad
        doff += R_pad
    table = make_scatter_table(np.array(geo, dtype=np.int64).reshape(-1, 4), n)
    dtype = schedule.slabs[0].vals.dtype if schedule.slabs else np.float64
    idt = np.int32 if dev.type == "cuda" else np.int64

    def cat(blocks, dt):
        return torch.from_numpy(np.concatenate(blocks).astype(dt, copy=False)
                                if blocks else np.zeros(0, dtype=dt)).to(dev)

    rows_t, cols_t = cat(rows_b, idt), cat(cols_b, idt)
    vals_t, diag_t = cat(vals_b, dtype), cat(diag_b, dtype)
    cast = {}

    def solve(b: torch.Tensor) -> torch.Tensor:
        dt = b.dtype
        if dt not in cast:
            cast[dt] = (vals_t.to(dt), diag_t.to(dt))
        vals, diag = cast[dt]
        tail = tuple(b.shape[1:])
        b_ext = torch.cat([b, b.new_zeros((1,) + tail)])
        x = torch.zeros((n_pad,) + tail, dtype=dt, device=b.device)
        level_scatter(x, b_ext, rows_t, cols_t, vals, diag, table)
        return x[:n]

    solve.table = table
    solve.buffers = (rows_t, cols_t, vals_t, diag_t)
    solve.n_pad = n_pad
    return solve
