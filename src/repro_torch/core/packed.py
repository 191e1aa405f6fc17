"""Permuted-space packed layout + value-only numeric refresh.

The slab order of a :class:`~repro_torch.core.codegen.Schedule` visits every
row exactly once, so it defines a row permutation ``perm``
(:meth:`Schedule.perm`) under which each segment's output rows are a
*contiguous slice*.  Executors run entirely in that space: ``b`` is permuted
once at entry (``b̂ = b[perm]``), every segment reads its RHS and writes its
solution as a contiguous slice at a static offset, and ``x`` is un-permuted
once at exit (``x = x̂[pos]``).  ELL dependency columns are remapped to
permuted positions once at build.

All per-segment ``vals`` slabs are packed into one flat buffer with static
offsets (same for ``diag`` and the column positions).  The solver keeps the
value buffers as persistent device tensors; :meth:`SpTRSV.refresh` re-packs
new values of the same pattern with one vectorized gather
(:func:`pack_values`) and copies them into those tensors in place, so their
addresses never change.

Padding discipline: a segment may write its full padded width ``R_pad``;
padding lanes compute finite garbage (val 0 / diag 1) that lands *forward*
— on positions whose owning segment has not yet executed and always
overwrites them before any consumer reads them — so only writes past
position ``n`` need scratch, provided by the ``n_pad - n`` tail.

This module also holds the plain torch-op executor of the layout
(``strategy="levelset"``), the baseline the kernels are measured against.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..kernels.sptrsv_level.ref import level_walk_ref
from .codegen import Schedule, stack_sub_slabs

__all__ = [
    "PackedSegment",
    "PackedLayout",
    "PackedStats",
    "build_packed_layout",
    "gather_src",
    "pack_values",
    "permute_rhs",
    "segment_steps",
    "make_packed_levelset_solver",
]


@dataclasses.dataclass(frozen=True)
class PackedSegment:
    """Geometry of one segment inside the packed flat buffers.

    ``off`` is the segment's first position in permuted space; its rows own
    positions ``[off, off + R)``.  ``R_pad`` is the padded lane width the
    executor computes/writes.  Chains (``depth > 1``) store the stacked
    uniform sub-slab arrays ``(d, K, R_pad)``; ``sub_offs`` are the
    per-sub-slab permuted-space offsets."""

    kind: str                 # "plain" | "chain"
    off: int
    R: int
    R_pad: int
    K: int
    depth: int
    val_off: int
    col_off: int
    diag_off: int
    sub_offs: Optional[np.ndarray] = None  # (depth,) int64, chains only
    block_rows: int = 0       # kernel row-block size (0 = not a kernel path)

    @property
    def val_size(self) -> int:
        return self.depth * self.K * self.R_pad

    @property
    def diag_size(self) -> int:
        return self.depth * self.R_pad


@dataclasses.dataclass(frozen=True)
class PackedStats:
    """Byte-level accounting of a packed layout (surfaced by
    ``SpTRSV.stats()``)."""

    permutation_applied: bool
    value_bytes: int          # packed vals + diag buffers
    index_bytes: int          # packed column-position buffer
    padded_value_bytes: int   # zero-padding share of value_bytes
    n_pad: int                # permuted vector length incl. scratch tail
    num_segments: int


@dataclasses.dataclass(frozen=True)
class PackedLayout:
    """Permuted-space packed form of a :class:`Schedule`.

    ``perm[p]`` = original row at permuted position ``p``; ``pos[i]`` =
    position of original row ``i``.  ``cols_flat`` holds *positions*.
    ``vals_src``/``diag_src`` map every packed value back into the target
    matrix's ``data`` array (-1 = padding) — the refresh maps consumed by
    :func:`pack_values`."""

    n: int
    n_pad: int
    nnz: int
    perm: np.ndarray
    pos: np.ndarray
    segments: tuple
    cols_flat: np.ndarray
    vals_flat: np.ndarray
    diag_flat: np.ndarray
    vals_src: np.ndarray
    diag_src: np.ndarray

    def stats(self) -> PackedStats:
        item = self.vals_flat.itemsize
        pad = int((self.vals_src < 0).sum() + (self.diag_src < 0).sum())
        return PackedStats(
            permutation_applied=True,
            value_bytes=self.vals_flat.nbytes + self.diag_flat.nbytes,
            index_bytes=self.cols_flat.nbytes,
            padded_value_bytes=pad * item,
            n_pad=self.n_pad,
            num_segments=len(self.segments),
        )


def build_packed_layout(
    schedule: Schedule,
    *,
    pad_rows: Optional[Callable[[int], int]] = None,
    pad_chain_rows: Optional[Callable[[int], int]] = None,
    block_rows_for: Optional[Callable[[int], int]] = None,
) -> PackedLayout:
    """Lower a schedule into the permuted-space packed layout.

    ``pad_rows(R) -> R_pad`` lets kernel executors request row alignment;
    default is no padding.  ``pad_chain_rows`` applies to the widest
    sub-slab of a chain (defaults to ``pad_rows``).  ``block_rows_for(R_pad)``
    records a per-segment kernel block size."""
    pad_rows = pad_rows or (lambda r: r)
    pad_chain_rows = pad_chain_rows or pad_rows
    n = schedule.n
    perm = schedule.perm()
    assert perm.size == n, (perm.size, n)
    pos = np.empty(n, dtype=np.int64)
    pos[perm] = np.arange(n, dtype=np.int64)
    pos32 = pos.astype(np.int32)

    segments = []
    cols_b, vals_b, diag_b, vsrc_b, dsrc_b = [], [], [], [], []
    off = voff = doff = 0
    write_end_max = n
    dtype = schedule.slabs[0].vals.dtype if schedule.slabs else np.float64
    for slab in schedule.slabs:
        R = slab.R
        if R == 0:
            continue
        if slab.depth > 1:
            _, cols_s, vals_s, diag_s, vsrc_s, dsrc_s = stack_sub_slabs(
                slab, n, with_src=True)
            d, K, rmax = cols_s.shape
            Rp = int(pad_chain_rows(rmax))
            cols_p = np.zeros((d, K, Rp), dtype=np.int32)
            cols_p[:, :, :rmax] = pos32[cols_s]
            vals_p = np.zeros((d, K, Rp), dtype=vals_s.dtype)
            vals_p[:, :, :rmax] = vals_s
            diag_p = np.ones((d, Rp), dtype=diag_s.dtype)
            diag_p[:, :rmax] = diag_s
            vsrc_p = np.full((d, K, Rp), -1, dtype=np.int64)
            vsrc_p[:, :, :rmax] = vsrc_s
            dsrc_p = np.full((d, Rp), -1, dtype=np.int64)
            dsrc_p[:, :rmax] = dsrc_s
            sub_offs = off + np.concatenate(
                [[0], np.cumsum(slab.sub_rows[:-1])]).astype(np.int64)
            write_end = int(sub_offs[-1]) + Rp
            seg = PackedSegment(
                kind="chain", off=off, R=R, R_pad=Rp, K=K, depth=d,
                val_off=voff, col_off=voff, diag_off=doff, sub_offs=sub_offs,
                block_rows=block_rows_for(Rp) if block_rows_for else 0)
        else:
            K = slab.K
            Rp = int(pad_rows(R))
            cols_p = np.zeros((K, Rp), dtype=np.int32)
            cols_p[:, :R] = pos32[slab.cols]
            vals_p = np.zeros((K, Rp), dtype=slab.vals.dtype)
            vals_p[:, :R] = slab.vals
            diag_p = np.ones((Rp,), dtype=slab.diag.dtype)
            diag_p[:R] = slab.diag
            vsrc_p = np.full((K, Rp), -1, dtype=np.int64)
            dsrc_p = np.full((Rp,), -1, dtype=np.int64)
            if slab.val_src is not None:
                vsrc_p[:, :R] = slab.val_src
                dsrc_p[:R] = slab.diag_src
            write_end = off + Rp
            seg = PackedSegment(
                kind="plain", off=off, R=R, R_pad=Rp, K=K, depth=1,
                val_off=voff, col_off=voff, diag_off=doff,
                block_rows=block_rows_for(Rp) if block_rows_for else 0)
        segments.append(seg)
        cols_b.append(cols_p.ravel())
        vals_b.append(vals_p.ravel())
        diag_b.append(diag_p.ravel())
        vsrc_b.append(vsrc_p.ravel())
        dsrc_b.append(dsrc_p.ravel())
        write_end_max = max(write_end_max, write_end)
        off += R
        voff += seg.val_size
        doff += seg.diag_size
    assert off == n, (off, n)

    def cat(blocks, dt):
        return (np.concatenate(blocks).astype(dt, copy=False) if blocks
                else np.zeros(0, dtype=dt))

    return PackedLayout(
        n=n, n_pad=write_end_max, nnz=schedule.nnz,
        perm=perm, pos=pos,
        segments=tuple(segments),
        cols_flat=cat(cols_b, np.int32),
        vals_flat=cat(vals_b, dtype),
        diag_flat=cat(diag_b, dtype),
        vals_src=cat(vsrc_b, np.int64),
        diag_src=cat(dsrc_b, np.int64),
    )


def gather_src(data: np.ndarray, src: np.ndarray, fill, dtype) -> np.ndarray:
    """Masked source-map gather: ``out[i] = data[src[i]]`` where ``src >= 0``
    and ``fill`` at padding slots (``src < 0``)."""
    data = np.asarray(data)
    out = np.where(src >= 0, data[np.clip(src, 0, None)], fill)
    return out.astype(dtype, copy=False)


def pack_values(layout: PackedLayout, data: np.ndarray):
    """Re-pack the flat value buffers for new ``data`` of the same pattern —
    two vectorized gathers, O(nnz + padding), no analysis."""
    return (gather_src(data, layout.vals_src, 0.0, layout.vals_flat.dtype),
            gather_src(data, layout.diag_src, 1.0, layout.diag_flat.dtype))


def permute_rhs(b: torch.Tensor, perm: torch.Tensor, length: int) -> torch.Tensor:
    """``b̂``: ``b[perm]`` in a zero-filled buffer of ``length`` rows (the
    scratch tail past ``n`` reads zeros)."""
    bhat = torch.zeros((length,) + tuple(b.shape[1:]), dtype=b.dtype,
                       device=b.device)
    torch.index_select(b, 0, perm, out=bhat[: perm.shape[0]])
    return bhat


def segment_steps(layout: PackedLayout) -> np.ndarray:
    """``(S, 5)`` int64 table with one row ``(o, K, R_pad, val_off,
    diag_off)`` per wavefront, in execution order: one per plain segment,
    ``depth`` per chain (at its ``sub_offs``).  ``val_off`` indexes both the
    column and the value buffer."""
    rows = []
    for seg in layout.segments:
        offs = seg.sub_offs if seg.kind == "chain" else (seg.off,)
        for t, o in enumerate(offs):
            rows.append((int(o), seg.K, seg.R_pad,
                         seg.val_off + t * seg.K * seg.R_pad,
                         seg.diag_off + t * seg.R_pad))
    return np.ascontiguousarray(np.array(rows, dtype=np.int64).reshape(-1, 5))


def make_packed_levelset_solver(layout: PackedLayout, *, device):
    """Permuted-space level-set executor in plain torch ops: one
    gather/FMA/divide per wavefront (the level kernel's plain version,
    :func:`repro_torch.kernels.sptrsv_level.ref.level_walk_ref`), a Python
    loop of ``depth`` steps per chain.

    Returns ``solve(b, values)`` with ``values = (vals_flat, diag_flat)`` as
    tensors on ``device``.  ``b`` may be ``(n,)`` or ``(n, m)``; values are
    cast to ``b``'s dtype per solve."""
    dev = torch.device(device)
    n_pad = layout.n_pad
    cols_flat = torch.from_numpy(layout.cols_flat.astype(np.int64)).to(dev)
    perm = torch.from_numpy(layout.perm).to(dev)
    pos = torch.from_numpy(layout.pos).to(dev)
    steps = segment_steps(layout)

    def solve(b: torch.Tensor, values) -> torch.Tensor:
        vals_flat, diag_flat = values
        bhat = permute_rhs(b, perm, n_pad)
        x = torch.zeros_like(bhat)
        level_walk_ref(x, bhat, cols_flat, vals_flat.to(b.dtype),
                       diag_flat.to(b.dtype), steps)
        return x.index_select(0, pos)

    return solve
