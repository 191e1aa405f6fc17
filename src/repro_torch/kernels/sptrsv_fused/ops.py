"""Fused level-order layout and the one-launch solve
(``strategy="pallas_fused"``).

:func:`build_layout` packs a :class:`Schedule` into the level-order permuted
ELL layout with chunk-aligned wavefront ``spans`` (array for array the JAX
package's fused layout).  :func:`fused_solve` runs the whole solve: the
CUDA kernel for tensors on the card (for a single RHS a walk of the
layout's :class:`~.table.FusedTable`, each row waiting only for the rows
it reads; for a batch a cooperative grid over every SM with a barrier per
span), the plain chunk walk for tensors on the CPU.  :func:`make_solver` is
the scatter layout's form (``layout="scatter"``): the same layout and
kernels, with the values fixed at build.

Direction-agnostic: backward (transpose) schedules permute rows by reverse
level order, so every dependency position still precedes its consumer.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ...core.codegen import Schedule
from ...core.packed import gather_src
from ..backend import resolve_device
from . import cuda
from .ref import fused_solve_ref
from .table import FusedTable, fused_table

__all__ = ["FusedLayout", "build_layout", "fused_solve", "make_packed_solver",
           "make_solver"]


@dataclasses.dataclass(frozen=True)
class FusedLayout:
    """Level-order permuted ELL layout with chunk-aligned level boundaries.

    ``perm_rows[p]`` = original row at position p (pad -> n).
    ``pos[i]``       = position of original row i.
    ``cols``         (K, n_pad) dependency *positions*.
    ``val_src``/``diag_src`` map packed values back to the source matrix's
    ``data`` indices (-1 padding) — the value-only refresh maps.
    ``spans``        chunk-aligned ``(offset, padded_rows)`` of each
                     wavefront — the barrier boundaries of the batched
                     kernel's walk.
    """

    n: int
    n_pad: int
    chunk: int
    K: int
    perm_rows: np.ndarray
    pos: np.ndarray
    cols: np.ndarray
    vals: np.ndarray
    diag: np.ndarray
    val_src: Optional[np.ndarray] = None
    diag_src: Optional[np.ndarray] = None
    spans: tuple = ()

    @property
    def padded_flops(self) -> int:
        return 2 * self.K * self.n_pad + self.n_pad


def build_layout(schedule: Schedule, chunk: int = 512) -> FusedLayout:
    n = schedule.n
    # A coarsened slab's sub-slabs are NOT mutually independent, so every
    # wavefront keeps its own chunk-aligned span — chains expand back to
    # their sub-slabs.
    slabs = [sub for slab in schedule.slabs for sub in slab.sub_slabs()]
    K = max(s.K for s in slabs)
    spans = []
    off = 0
    for slab in slabs:
        r_pad = int(np.ceil(slab.R / chunk) * chunk)
        spans.append((off, r_pad))
        off += r_pad
    n_pad = off
    perm_rows = np.full((n_pad,), n, dtype=np.int32)
    pos = np.zeros((n + 1,), dtype=np.int64)
    for (o, _), slab in zip(spans, slabs):
        perm_rows[o : o + slab.R] = slab.rows
        pos[slab.rows] = np.arange(o, o + slab.R)
    pos[n] = n_pad - 1  # scratch row maps to the last pad position

    val_dtype = slabs[0].vals.dtype
    cols = np.zeros((K, n_pad), dtype=np.int32)
    vals = np.zeros((K, n_pad), dtype=val_dtype)
    diag = np.ones((n_pad,), dtype=val_dtype)
    val_src = np.full((K, n_pad), -1, dtype=np.int64)
    diag_src = np.full((n_pad,), -1, dtype=np.int64)
    for (o, _), slab in zip(spans, slabs):
        k = slab.K
        cols[:k, o : o + slab.R] = pos[slab.cols]
        vals[:k, o : o + slab.R] = slab.vals
        diag[o : o + slab.R] = slab.diag
        if slab.val_src is not None:
            val_src[:k, o : o + slab.R] = slab.val_src
            diag_src[o : o + slab.R] = slab.diag_src
    return FusedLayout(
        n=n, n_pad=n_pad, chunk=chunk, K=K,
        perm_rows=perm_rows, pos=pos, cols=cols, vals=vals, diag=diag,
        val_src=val_src, diag_src=diag_src,
        spans=tuple((int(o), int(rp)) for o, rp in spans),
    )


def fused_solve(bl_perm, cols, vals, diag, *, chunk: int, spans,
                table: Optional[FusedTable] = None):
    """The whole permuted solve ``x̂``: the CUDA kernel for tensors on the
    card (a single RHS walks ``table``, a batch ``spans``, an int32
    ``(S, 2)`` tensor), the plain chunk walk for tensors on the CPU."""
    if bl_perm.is_cuda:
        return cuda.fused_solve(bl_perm, cols, vals, diag, spans, table)
    if bl_perm.device.type == "cpu":
        return fused_solve_ref(bl_perm, cols, vals, diag, chunk=chunk)
    raise ValueError(f"no fused kernel for device {bl_perm.device}")


def make_packed_solver(schedule: Schedule, *, device="cuda", chunk: int = 512):
    """Returns ``(solve(b, values), values0, repack, layout)``.

    ``values0`` are the packed ``(vals (K, n_pad), diag (n_pad,))`` tensors
    on ``device``; ``repack(data)`` re-packs new matrix data of the same
    pattern as numpy arrays of the same shapes, and ``repack.into(buffers,
    data)`` writes them into the value tensors in place (``repack.sourced``
    of the ``K * n_pad`` slots hold matrix values, the rest pad).  The solve's
    device buffers are ``solve.cols``, ``solve.spans`` and
    ``solve.perm_rows`` (its chunk ``solve.chunk``), and the single-RHS
    walk's table, built once here, ``solve.table``.  Neither closure keeps
    the host layout."""
    dev = resolve_device(device)
    lay = build_layout(schedule, chunk)
    n = lay.n
    # A CUDA gather does not clip: every column position must lie in x̂.
    if int(lay.cols.max()) >= lay.n_pad:
        raise RuntimeError("fused column position outside x̂")
    table = fused_table(lay, dev)
    cols_np = lay.cols if dev.type == "cuda" else lay.cols.astype(np.int64)
    cols = torch.from_numpy(cols_np).to(dev)
    perm_rows = torch.from_numpy(lay.perm_rows.astype(np.int64)).to(dev)
    pos = torch.from_numpy(lay.pos[:n]).to(dev)
    spans = torch.tensor(lay.spans, dtype=torch.int32, device=dev)
    values0 = (torch.from_numpy(lay.vals).to(dev),
               torch.from_numpy(lay.diag).to(dev))

    # the sourced slots of the padded (K, n_pad) values and their sources in
    # the matrix data; every other slot is a pad, 0 through every refresh
    # (the transpose layout of a factor with a dense column is almost all
    # pad)
    src_flat = lay.val_src.reshape(-1)
    slots = np.flatnonzero(src_flat >= 0)
    slot_src = src_flat[slots]
    slots_d = torch.from_numpy(slots).to(dev)
    shape, vdt = lay.vals.shape, lay.vals.dtype
    diag_src, ddt = lay.diag_src, lay.diag.dtype

    def repack(data):
        data = np.asarray(data)
        vals = np.zeros(shape, dtype=vdt)
        vals.reshape(-1)[slots] = data[slot_src]
        return vals, gather_src(data, diag_src, 1.0, ddt)

    def repack_into(buffers, data):
        vals, diag = buffers
        data = np.asarray(data)
        new = torch.from_numpy(data[slot_src].astype(vdt, copy=False))
        vals.view(-1).index_copy_(0, slots_d, new.to(vals))
        diag.copy_(torch.from_numpy(gather_src(data, diag_src, 1.0, ddt)))

    repack.into, repack.sourced = repack_into, int(slots.size)

    def solve(b: torch.Tensor, values) -> torch.Tensor:
        vals, diag = values
        dt = b.dtype
        b_ext = torch.cat([b, b.new_zeros((1,) + tuple(b.shape[1:]))])
        bl_perm = b_ext.index_select(0, perm_rows)  # pad rows -> b_ext[n] = 0
        xp = fused_solve(bl_perm, cols, vals.to(dt), diag.to(dt),
                         chunk=chunk, spans=spans, table=table)
        return xp.index_select(0, pos)

    solve.table, solve.cols, solve.spans = table, cols, spans
    solve.perm_rows, solve.chunk = perm_rows, chunk
    return solve, values0, repack, lay


def make_solver(schedule: Schedule, *, device="cuda", chunk: int = 512):
    """Scatter-layout fused solve ``solve(b)``: the layout and kernels of
    :func:`make_packed_solver` with the values fixed at build (the JAX
    package embeds them in the traced program).  ``solve.table`` is the
    single-RHS walk's table."""
    fn, values, _, _ = make_packed_solver(schedule, device=device, chunk=chunk)

    def solve(b: torch.Tensor) -> torch.Tensor:
        return fn(b, values)

    solve.table = fn.table
    return solve
