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
(``strategy="levelset"``), the baseline the kernels are measured against,
the rewritten solve's RHS transform ``b' = E b`` on the SpMV kernel, and
the blocked (supernodal) layout and its executor, one blocked-walk kernel
launch per solve.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..kernels.spmv_ell.ops import device_cols, device_row_len, spmv
from ..kernels.sptrsv_level.ref import level_walk_ref
from ..kernels.sptrsv_level.table import LevelTable, make_level_table
from ..kernels.trsm_block.ops import blocked_walk, make_walk_table
from .codegen import Schedule, build_ell, serial_arrays, stack_sub_slabs
from .csr import CSRMatrix
from .rewrite import RewriteResult

__all__ = [
    "PackedSegment",
    "PackedLayout",
    "PackedStats",
    "build_packed_layout",
    "gather_src",
    "pack_values",
    "permute_rhs",
    "segment_table",
    "row_lengths",
    "level_table",
    "make_packed_levelset_solver",
    "make_packed_serial_solver",
    "make_packed_rhs_transform",
    "ell_packed_stats",
    "cast_value_buffers",
    "MIXED_VALS_DTYPE",
    "MIXED_DIAG_DTYPE",
    "PackedBlockSegment",
    "PackedBlockedLayout",
    "build_packed_blocked_layout",
    "pack_blocked_values",
    "walk_geometry",
    "make_packed_blocked_solver",
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
    # the sourced slots only: a padded layout is mostly fill
    out = np.full(src.shape, fill, dtype=dtype)
    real = src >= 0
    out[real] = data[src[real]]
    return out


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


def segment_table(layout: PackedLayout) -> tuple:
    """``(geometry, sub_offs)``: the ``(S, 7)`` int64 table with one row
    ``(o, K, R_pad, val_off, diag_off, depth, sub_off)`` per segment, in
    execution order (:data:`repro_torch.kernels.sptrsv_level.table.GEOMETRY`),
    and the ``(D,)`` int64 write offsets of every chain's sub-steps, chain
    by chain: a chain's row points at its first (``sub_off``); a plain
    segment has depth 1 and ``sub_off`` −1.  ``val_off`` indexes both the
    column and the value buffer, ``diag_off`` the diagonal and the row
    lengths."""
    rows, subs = [], []
    for seg in layout.segments:
        so = -1
        if seg.kind == "chain":
            so = sum(map(len, subs))
            subs.append(seg.sub_offs)
        rows.append((seg.off, seg.K, seg.R_pad, seg.val_off, seg.diag_off,
                     seg.depth, so))
    return (np.array(rows, dtype=np.int64).reshape(-1, 7),
            np.concatenate(subs).astype(np.int64) if subs
            else np.zeros(0, dtype=np.int64))


def row_lengths(layout: PackedLayout) -> np.ndarray:
    """Each packed row's count of real entries (``vals_src >= 0``), int32,
    indexed like ``diag_flat``.  Raises ``ValueError`` unless every slot
    past a row's length is a pad: no source, value 0, and the column of the
    row's first pad (the level kernel adds that one pad term instead of
    all of them).  It depends on the pattern only, so a value refresh
    leaves it as it is."""
    out = np.zeros(layout.diag_flat.size, dtype=np.int32)
    for seg in layout.segments:
        d, K, Rp = seg.depth, seg.K, seg.R_pad
        if K == 0:
            continue
        span = slice(seg.val_off, seg.val_off + d * K * Rp)
        src = layout.vals_src[span].reshape(d, K, Rp)
        cols = layout.cols_flat[span].reshape(d, K, Rp)
        vals = layout.vals_flat[span].reshape(d, K, Rp)
        n = (src >= 0).sum(axis=1)
        past = np.arange(K)[None, :, None] >= n[:, None, :]
        pad_col = np.take_along_axis(cols, np.minimum(n, K - 1)[:, None, :], 1)
        if ((src >= 0) & past).any() or (vals[past] != 0).any() \
                or (cols != pad_col)[past].any():
            raise ValueError(f"segment at {seg.off}: a slot past its row "
                             "length is not a pad")
        out[seg.diag_off: seg.diag_off + d * Rp] = n.ravel()
    return out


def level_table(layout: PackedLayout, device) -> LevelTable:
    """The level walk's table of ``layout`` on ``device``: one row per
    segment, the chains' sub-step offsets and the row lengths."""
    return make_level_table(*segment_table(layout), row_lengths(layout),
                            device)


def _unrolled_terms(layout: PackedLayout, seg: PackedSegment, device):
    """The real slots of a plain segment's ``R`` rows: ``(val index, column
    position, row)`` int64 tensors, in slot order — the terms its
    unrolled rows read (pad slots, ``vals_src < 0``, are skipped)."""
    K, Rp, R = seg.K, seg.R_pad, seg.R
    span = slice(seg.val_off, seg.val_off + K * Rp)
    src = layout.vals_src[span].reshape(K, Rp)[:, :R]
    k, r = np.nonzero(src >= 0)
    vidx = seg.val_off + k * Rp + r
    cidx = layout.cols_flat[vidx]
    return tuple(torch.from_numpy(a.astype(np.int64)).to(device)
                 for a in (vidx, cidx, r))


def make_packed_levelset_solver(layout: PackedLayout, *, device,
                                unroll_threshold: int = 0):
    """Permuted-space level-set executor in plain torch ops: one
    gather/FMA/divide per wavefront (the level kernel's plain version,
    :func:`repro_torch.kernels.sptrsv_level.ref.level_walk_ref`), a Python
    loop over a chain's ``depth`` sub-steps.

    ``unroll_threshold > 0`` is ``strategy="levelset_unroll"``: a plain
    segment of at most that many rows is computed from its rows' real
    entries only (the JAX package emits such a segment as scalar code with
    the pad slots left out), and writes its ``R`` rows, not ``R_pad``.

    Returns ``solve(b, values)`` with ``values = (vals_flat, diag_flat)`` as
    tensors on ``device``.  ``b`` may be ``(n,)`` or ``(n, m)``; values are
    cast to ``b``'s dtype per solve."""
    dev = torch.device(device)
    n_pad = layout.n_pad
    cols_flat = torch.from_numpy(layout.cols_flat.astype(np.int64)).to(dev)
    perm = torch.from_numpy(layout.perm).to(dev)
    pos = torch.from_numpy(layout.pos).to(dev)
    geometry, sub_offs = segment_table(layout)
    row_len = row_lengths(layout)
    # runs of level-walk segments between the unrolled ones, in order
    program, run = [], []
    for i, seg in enumerate(layout.segments):
        if seg.kind != "chain" and seg.R <= unroll_threshold:
            if run:
                program.append(make_level_table(geometry[run], sub_offs,
                                                row_len, dev))
                run = []
            program.append((seg, _unrolled_terms(layout, seg, dev)))
        else:
            run.append(i)
    if run:
        program.append(make_level_table(geometry[run], sub_offs, row_len, dev))

    def solve(b: torch.Tensor, values) -> torch.Tensor:
        vals_flat, diag_flat = values
        vf, df = vals_flat.to(b.dtype), diag_flat.to(b.dtype)
        bhat = permute_rhs(b, perm, n_pad)
        x = torch.zeros_like(bhat)
        for step in program:
            if isinstance(step, LevelTable):
                level_walk_ref(x, bhat, cols_flat, vf, df, step)
                continue
            seg, (vidx, cidx, ridx) = step
            o, R = seg.off, seg.R
            t = vf[vidx] * x[cidx] if x.dim() == 1 \
                else vf[vidx][:, None] * x[cidx]
            s = torch.zeros_like(x[o: o + R]).index_add_(0, ridx, t)
            d = df[seg.diag_off: seg.diag_off + R]
            x[o: o + R] = (bhat[o: o + R] - s) / (d if x.dim() == 1
                                                 else d[:, None])
        return x.index_select(0, pos)

    return solve


def make_packed_serial_solver(L: CSRMatrix, *, upper: bool = False, device):
    """Row-serial substitution (the paper's Algorithm 1) in torch ops: a
    Python loop over the rows in scan order, each row one gather, FMA-sum
    and divide of its ``K`` slots (pads included, as the JAX package's
    ``lax.scan`` reads them).  Every row is a handful of device operations,
    so a solve costs on the order of ``n`` launches: the correctness
    baseline, never the fast path.

    Returns ``(solve(b, values), values0, repack)``: ``values0`` are the
    scan-ordered ``(vals (n, K), diag (n,))`` tensors on ``device``;
    ``repack(data)`` rebuilds them, as numpy arrays, for new matrix values
    of the same pattern."""
    dev = torch.device(device)
    cols, vals, diag, val_src, diag_src, order = serial_arrays(L, upper=upper)
    cols_o = torch.from_numpy(cols[order].astype(np.int64)).to(dev)
    idx = torch.from_numpy(order.astype(np.int64)).to(dev)
    rows = order.tolist()
    dtype = vals.dtype
    del cols, vals  # repack rebuilds the values from the source maps alone

    def repack(data: np.ndarray):
        v = gather_src(data, val_src, 0.0, dtype)
        d = np.asarray(data)[diag_src].astype(dtype, copy=False)
        return np.ascontiguousarray(v[order]), np.ascontiguousarray(d[order])

    values0 = tuple(torch.from_numpy(a).to(dev) for a in repack(L.data))

    def solve(b: torch.Tensor, values) -> torch.Tensor:
        vals_o, diag_o = (v.to(b.dtype) for v in values)
        if b.dim() == 2:
            vals_o = vals_o[:, :, None]
        bo = b.index_select(0, idx)
        x = torch.zeros_like(b)
        for t, i in enumerate(rows):
            s = (vals_o[t] * x[cols_o[t]]).sum(0)
            x[i] = (bo[t] - s) / diag_o[t]
        return x

    return solve, values0, repack


# --------------------------------------------------------------------------
# Blocked (supernodal) packed layout
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class PackedBlockSegment:
    """Geometry of one super-level inside the packed blocked buffers.

    The segment's real rows own permuted positions ``[off, off + R)``; its
    lane space is ``B * T`` block-major lanes, of which ``lane_idx`` are the
    real ones (the rest are padding).  ``val_off`` indexes the flat panel
    buffers (``K * B * T`` entries), ``dinv_off`` the flat dense-block
    buffers (``B * T * T`` entries)."""

    off: int
    R: int
    B: int
    T: int
    K: int
    val_off: int
    dinv_off: int
    lane_idx: np.ndarray      # (R,) int32


@dataclasses.dataclass(frozen=True)
class PackedBlockedLayout:
    """Permuted-space packed form of a
    :class:`~repro_torch.core.coarsen.BlockSchedule`.

    Same contract as :class:`PackedLayout`: ``cols_flat`` holds permuted
    *positions*; ``vals_src`` (panel values) and ``diag_src`` (dense
    diagonal-block entries) map every packed value back into the target
    matrix's ``data`` array (−1 = padding / structural zero), so
    :func:`pack_blocked_values` re-packs both runtime buffers — including
    the batched block re-inversion — from new values alone.  ``pad_eye_flat``
    is the identity padding added before every inversion."""

    n: int
    nnz: int
    perm: np.ndarray
    pos: np.ndarray
    segments: tuple
    cols_flat: np.ndarray
    vals_flat: np.ndarray
    vals_src: np.ndarray
    dinv_flat: np.ndarray     # float64 inverted blocks, concatenated raveled
    diag_src: np.ndarray      # int64, aligned with dinv_flat
    pad_eye_flat: np.ndarray  # float64, aligned with dinv_flat

    def stats(self) -> PackedStats:
        item = self.vals_flat.itemsize
        pad = int((self.vals_src < 0).sum() + (self.diag_src < 0).sum())
        return PackedStats(
            permutation_applied=True,
            value_bytes=self.vals_flat.nbytes + self.dinv_flat.nbytes,
            index_bytes=self.cols_flat.nbytes,
            padded_value_bytes=pad * item,
            n_pad=self.n,
            num_segments=len(self.segments),
        )


def build_packed_blocked_layout(bsched) -> PackedBlockedLayout:
    """Lower a blocked schedule into permuted-space flat buffers: the
    blocked execution order (super-level by super-level, block-major)
    defines ``perm``; panel columns are remapped to positions once here."""
    n = bsched.n
    perm = bsched.perm()
    assert perm.size == n, (perm.size, n)
    pos = np.empty(n, dtype=np.int64)
    pos[perm] = np.arange(n, dtype=np.int64)
    pos32 = pos.astype(np.int32)

    segments = []
    cols_b, vals_b, vsrc_b, dinv_b, dsrc_b, eye_b = [], [], [], [], [], []
    off = voff = doff = 0
    dtype = (bsched.slabs[0].vals.dtype if bsched.slabs else np.float64)
    for slab in bsched.slabs:
        B, T, K, R = slab.B, slab.T, slab.K, slab.R
        lane_idx = np.nonzero(slab.lane_row < n)[0].astype(np.int32)
        segments.append(PackedBlockSegment(
            off=off, R=R, B=B, T=T, K=K, val_off=voff, dinv_off=doff,
            lane_idx=lane_idx))
        # padded panel lanes keep column 0 -> position pos[0]: its value is
        # 0 and x starts zero-filled, so the gather is a no-op everywhere
        cols_b.append(pos32[slab.cols].ravel())
        vals_b.append(slab.vals.ravel())
        vsrc_b.append(slab.val_src.ravel())
        dinv_b.append(slab.dinv.ravel())
        dsrc_b.append(slab.diag_src.ravel())
        eye_b.append(slab.pad_eye.ravel())
        off += R
        voff += K * B * T
        doff += B * T * T
    assert off == n, (off, n)

    def cat(blocks, dt):
        return (np.concatenate(blocks).astype(dt, copy=False) if blocks
                else np.zeros(0, dtype=dt))

    return PackedBlockedLayout(
        n=n, nnz=bsched.nnz, perm=perm, pos=pos, segments=tuple(segments),
        cols_flat=cat(cols_b, np.int32),
        vals_flat=cat(vals_b, dtype),
        vals_src=cat(vsrc_b, np.int64),
        dinv_flat=cat(dinv_b, np.float64),
        diag_src=cat(dsrc_b, np.int64),
        pad_eye_flat=cat(eye_b, np.float64),
    )


def pack_blocked_values(layout: PackedBlockedLayout, data: np.ndarray):
    """Re-pack the blocked value buffers for new ``data`` of the same
    pattern: one vectorized gather for the panel values, one gather +
    identity padding + batched ``np.linalg.inv`` (float64, host-side) for
    the dense diagonal blocks.  O(nnz + Σ B·T³) with no analysis.  Returns
    numpy ``(vals_flat, dinv_flat)`` shaped like the layout's."""
    vals = gather_src(data, layout.vals_src, 0.0, layout.vals_flat.dtype)
    dense = (gather_src(data, layout.diag_src, 0.0, np.float64)
             + layout.pad_eye_flat)
    dinv = np.empty_like(layout.dinv_flat)
    for seg in layout.segments:
        size = seg.B * seg.T * seg.T
        blk = dense[seg.dinv_off : seg.dinv_off + size].reshape(
            seg.B, seg.T, seg.T)
        try:
            inv = np.linalg.inv(blk)
        except np.linalg.LinAlgError:
            # A singular/non-finite diagonal block (zero pivot admitted via
            # refresh(validate=False)) must not abort the re-pack: invert
            # the healthy blocks, poison the broken ones with NaN so the
            # solve produces NaN rows a guarded solver's breakdown policy
            # can see and handle.
            inv = np.empty_like(blk)
            for i in range(blk.shape[0]):
                try:
                    inv[i] = np.linalg.inv(blk[i])
                except np.linalg.LinAlgError:
                    inv[i] = np.nan
        dinv[seg.dinv_off : seg.dinv_off + size] = inv.ravel()
    return vals, dinv


def walk_geometry(layout: PackedBlockedLayout) -> np.ndarray:
    """``(S, 8)`` int64 segment table of the layout for the blocked walk,
    rows ``(off, R, B, T, K, val_off, dinv_off, lane_off)`` in execution
    order (:data:`repro_torch.kernels.trsm_block.table.GEOMETRY`)."""
    rows, lane_off = [], 0
    for seg in layout.segments:
        rows.append((seg.off, seg.R, seg.B, seg.T, seg.K, seg.val_off,
                     seg.dinv_off, lane_off))
        lane_off += seg.B * seg.T
    return np.array(rows, dtype=np.int64).reshape(-1, 8)


def make_packed_blocked_solver(layout: PackedBlockedLayout, *, device):
    """Permuted-space blocked (supernodal) executor: one blocked-walk
    launch per solve
    (:func:`repro_torch.kernels.trsm_block.ops.blocked_walk`), which runs
    every super-level's panel SpMV ``s = Panel x``, the lane scatter of
    ``b - s``, the batched diagonal-block apply and the lane gather into
    ``x`` in order.

    Returns ``solve(b, values)`` with ``values = (vals_flat, dinv_flat)`` as
    tensors on ``device`` (from :func:`pack_blocked_values`); the walk reads
    them by pointer, so a refresh that copies into them needs no rebuild.
    ``b`` may be ``(n,)`` or ``(n, m)``; values are cast to ``b``'s dtype
    per solve."""
    dev = torch.device(device)
    # padded panel lanes keep column 0 -> position pos[0]: their value is 0
    # and x starts zero-filled, so the gather adds nothing
    cols_flat = device_cols(layout.cols_flat, layout.n, dev)
    perm = torch.from_numpy(layout.perm).to(dev)
    pos = torch.from_numpy(layout.pos).to(dev)
    table = make_walk_table(walk_geometry(layout),
                            [seg.lane_idx for seg in layout.segments], dev)

    def solve(b: torch.Tensor, values) -> torch.Tensor:
        vals_flat, dinv_flat = values
        dt = b.dtype
        bhat = b.index_select(0, perm)
        x = torch.zeros_like(bhat)
        blocked_walk(x, bhat, cols_flat, vals_flat.to(dt), dinv_flat.to(dt),
                     table)
        return x.index_select(0, pos)

    return solve


def ell_packed_stats(ell, diag: np.ndarray, *, n: int) -> PackedStats:
    """:class:`PackedStats` of a whole-matrix ELL layout (the sweep
    executor's ``D + N`` split): one segment, no permutation, the padding
    share read off the value-source map."""
    pad = int((ell.val_src < 0).sum())
    return PackedStats(
        permutation_applied=False,
        value_bytes=ell.vals.nbytes + diag.nbytes,
        index_bytes=ell.cols.nbytes,
        padded_value_bytes=pad * ell.vals.itemsize,
        n_pad=n,
        num_segments=1,
    )


# Mixed-precision storage (the guard's ``precision="mixed"``): bf16 for the
# O(nnz) off-diagonal / panel stream, f32 for the diagonal or inverted
# diagonal blocks — refinement against the full-precision residual stalls
# near 4e-3 per step with bf16 pivots, and the diagonal is O(n) of the bytes.
MIXED_VALS_DTYPE = torch.bfloat16
MIXED_DIAG_DTYPE = torch.float32


def cast_value_buffers(values) -> tuple:
    """A runtime value tuple in mixed-precision storage: the first buffer
    (off-diagonal / panel values) as :data:`MIXED_VALS_DTYPE`, every other
    one as :data:`MIXED_DIAG_DTYPE`, new tensors on the same device.  Every executor casts
    its buffers to the RHS dtype at solve time, so no kernel reads bf16;
    ``refresh`` copies new values into these buffers, which casts them."""
    vals, *rest = values
    return (vals.to(MIXED_VALS_DTYPE), *(r.to(MIXED_DIAG_DTYPE) for r in rest))


def make_packed_rhs_transform(res: RewriteResult, *, device):
    """``b' = E b`` on the SpMV kernel, with E's ELL values as a persistent
    buffer and its row lengths uploaded once beside the columns.

    Returns ``(transform(b, e_vals), e_vals0, repack)``: ``e_vals0`` is the
    ``(K, n)`` value tensor on ``device`` and ``repack(e_data)`` re-packs
    new E values (from
    :func:`repro_torch.core.rewrite.replay_rewrite_values`) as a numpy array
    of its shape.  E is in the original row order, so ``b`` is transformed
    before it is permuted.  When E is the identity (no rewrite survived the
    budgets) returns ``(None, None, None)``: a no-op SpMV would still cost a
    launch and a buffer per solve."""
    if res.stats.e_nnz_offdiag == 0:
        return None, None, None
    dev = torch.device(device)
    ell = build_ell(res.E)
    cols = device_cols(ell.cols, res.E.n, dev)
    # the kernel reads each row's real entries only (E's rows are mostly
    # one entry long; ELL pads them all to K)
    row_len = device_row_len(res.E.row_nnz(), ell.cols, dev)

    def transform(b: torch.Tensor, e_vals: torch.Tensor) -> torch.Tensor:
        return spmv(b, cols, e_vals.to(b.dtype), row_len)

    def repack(e_data: np.ndarray) -> np.ndarray:
        return gather_src(e_data, ell.val_src, 0.0, ell.vals.dtype)

    return transform, torch.from_numpy(ell.vals).to(dev), repack
