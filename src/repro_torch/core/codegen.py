"""Schedule builders: level sets packed into ELL slabs (paper §IV).

Each level is packed into an ELL *slab* — rows sorted by nnz, dependency
columns/values padded to the level's max row width, stored transposed
``(K, R)`` so neighbouring rows sit in neighbouring memory (GPU threads of a
warp read them coalesced).  The permuted-layout executors that consume a
:class:`Schedule` live in :mod:`repro_torch.core.packed` (plain torch ops)
and :mod:`repro_torch.kernels` (hand-written CUDA); the packing here is
host numpy, array for array the same as the JAX package's.

The scatter layout's executors (``layout="scatter"``) live here too, as in
the JAX package: every segment gathers ``b`` at its row ids, solves and
scatters into ``x`` by row id, with the values uploaded once at build
(the JAX package embeds them as trace-time constants).
:func:`make_serial_solver` is a host loop over rows,
:func:`make_levelset_solver` one gather/FMA/divide per level in plain
torch ops (a coarsened chain a loop over its sub-slabs, tiny levels from
their nonzero entries only), :func:`make_blocked_solver` one panel SpMV
launch and one batched block-apply launch per super-level, and
:func:`make_rhs_transform` the rewrite's ``b' = E b`` as one SpMV launch.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from ..kernels.spmv_ell.ops import device_cols, device_row_len, spmv
from ..kernels.sptrsv_level.ref import level_solve_ref
from .csr import CSRMatrix
from .levels import LevelSets, build_level_sets, compute_upper_levels
from .rewrite import RewriteResult

__all__ = [
    "LevelSlab",
    "Schedule",
    "EllMatrix",
    "DeviceEll",
    "build_schedule",
    "build_ell",
    "build_offdiag_ell",
    "device_ell",
    "ell_spmv",
    "serial_arrays",
    "slab_padded_flops",
    "stack_sub_slabs",
    "make_serial_solver",
    "make_levelset_solver",
    "make_blocked_solver",
    "make_rhs_transform",
]


@dataclasses.dataclass(frozen=True)
class LevelSlab:
    """One level's rows in padded ELL form, transposed ``(K, R)``.

    ``rows`` (R,) row ids;  ``cols``/``vals`` (K, R) with zero-padding
    (col 0 / val 0.0);  ``diag`` (R,).

    ``sub_rows`` is the slab's intra-slab dependency chain (schedule
    coarsening, :mod:`repro_torch.core.coarsen`): when non-empty it
    partitions the R rows into consecutive *sub-slabs* that must execute
    back-to-back in order — sub-slab ``t`` may depend on rows of sub-slabs
    ``< t``.  An empty tuple means the classic one-level slab (all rows
    mutually independent).

    ``val_src``/``diag_src`` map each packed value back to its index in the
    source matrix's ``data`` array (-1 for zero padding) — the symbolic side
    of value-only numeric refresh.
    """

    rows: np.ndarray
    cols: np.ndarray
    vals: np.ndarray
    diag: np.ndarray
    sub_rows: tuple = ()
    val_src: Optional[np.ndarray] = None   # (K, R) int64, -1 = padding
    diag_src: Optional[np.ndarray] = None  # (R,) int64

    @property
    def R(self) -> int:
        return self.rows.shape[0]

    @property
    def K(self) -> int:
        return self.cols.shape[0]

    @property
    def depth(self) -> int:
        """Length of the intra-slab dependency chain (1 = plain level)."""
        return len(self.sub_rows) if self.sub_rows else 1

    def sub_slabs(self):
        """Iterate the chain as plain (depth-1) :class:`LevelSlab` views."""
        if self.depth == 1:
            yield dataclasses.replace(self, sub_rows=())
            return
        off = 0
        for r in self.sub_rows:
            yield LevelSlab(
                rows=self.rows[off : off + r],
                cols=self.cols[:, off : off + r],
                vals=self.vals[:, off : off + r],
                diag=self.diag[off : off + r],
                val_src=None if self.val_src is None
                else self.val_src[:, off : off + r],
                diag_src=None if self.diag_src is None
                else self.diag_src[off : off + r],
            )
            off += r


@dataclasses.dataclass(frozen=True)
class Schedule:
    """Level-set execution schedule of a triangular matrix."""

    n: int
    slabs: List[LevelSlab]
    level_of_row: np.ndarray
    nnz: int

    @property
    def num_levels(self) -> int:
        return len(self.slabs)

    @property
    def num_segments(self) -> int:
        """Barrier-separated execution units: every slab — coarsened or not
        — is one segment."""
        return len(self.slabs)

    @property
    def total_depth(self) -> int:
        """Sum of intra-slab chain depths = wavefront count actually swept
        (equals the level count of the uncoarsened schedule)."""
        return sum(s.depth for s in self.slabs)

    def perm(self) -> np.ndarray:
        """Schedule-order row permutation: ``perm[p]`` = original row id at
        permuted position ``p``.  Each segment's output rows are a
        contiguous slice of the permuted space (see :meth:`row_offsets`)."""
        if not self.slabs:
            return np.zeros(0, dtype=np.int64)
        return np.concatenate([s.rows for s in self.slabs]).astype(np.int64)

    def row_offsets(self) -> np.ndarray:
        """(num_segments + 1,) permuted-space start offset of each segment."""
        return np.concatenate(
            [[0], np.cumsum([s.R for s in self.slabs])]).astype(np.int64)

    def padded_flops(self, unroll_threshold: int = 0) -> int:
        """FLOPs actually executed including padding waste."""
        return sum(slab_padded_flops(s, unroll_threshold) for s in self.slabs)


def slab_padded_flops(s: LevelSlab, unroll_threshold: int = 0) -> int:
    """Executed FLOPs of one slab: chains do ``depth`` uniform sub-steps
    padded to the widest sub-slab, slabs of at most ``unroll_threshold``
    rows count their true nnz, plain slabs pay the full ELL pad."""
    if s.depth > 1:
        rmax = max(s.sub_rows)
        return s.depth * (2 * s.K * rmax + rmax)
    if s.R <= unroll_threshold:
        return 2 * int(np.count_nonzero(s.vals)) + s.R
    return 2 * s.K * s.R + s.R


@dataclasses.dataclass(frozen=True)
class EllMatrix:
    """Whole-matrix ELL, transposed ``(K, n)``, with the value-source map
    (-1 padding) recorded for value-only refresh."""

    cols: np.ndarray  # (K, n)
    vals: np.ndarray  # (K, n)
    val_src: Optional[np.ndarray] = None  # (K, n) int64, -1 = padding

    @property
    def K(self) -> int:
        return self.cols.shape[0]


def _runs(starts: np.ndarray, lengths: np.ndarray):
    """The runs ``starts[r] + k`` for ``k < lengths[r]``, flattened in run
    order: each position, its run ``r`` and its offset ``k`` in the run —
    how the ELL packers place CSR rows without a loop per row."""
    lengths = np.asarray(lengths, dtype=np.int64)
    if lengths.size == 1:           # one run (a level of one row): no gathers
        k = np.arange(lengths[0])
        return int(starts[0]) + k, np.zeros(k.size, np.int64), k
    owner = np.repeat(np.arange(lengths.size), lengths)
    k = np.arange(int(lengths.sum())) - np.repeat(np.cumsum(lengths) - lengths,
                                                  lengths)
    return np.asarray(starts, dtype=np.int64)[owner] + k, owner, k


def _pack_rows(
    L: CSRMatrix, rows: np.ndarray, sort_by_nnz: bool, *, diag_first: bool = False
) -> LevelSlab:
    """Pack the given rows into one ELL slab.

    ``diag_first=False`` assumes lower-triangular storage (diagonal last in
    each row, the forward-solve layout); ``diag_first=True`` assumes
    upper-triangular storage (diagonal first — rows of ``L.transpose()``,
    the backward-solve layout).  Either way the slab comes out identical in
    shape, so every executor downstream is direction-agnostic."""
    row_nnz = L.indptr[rows + 1] - L.indptr[rows] - 1  # off-diagonal count
    if sort_by_nnz and rows.size > 1:
        order = np.argsort(row_nnz, kind="stable")
        rows = rows[order]
        row_nnz = row_nnz[order]
    K = max(int(row_nnz.max()) if rows.size else 0, 1)
    R = rows.size
    cols = np.zeros((K, R), dtype=np.int32)
    vals = np.zeros((K, R), dtype=L.dtype)
    val_src = np.full((K, R), -1, dtype=np.int64)
    lo = L.indptr[rows].astype(np.int64)
    diag_src = lo if diag_first else L.indptr[rows + 1].astype(np.int64) - 1
    diag = L.data[diag_src]
    src, r, k = _runs(lo + 1 if diag_first else lo, row_nnz)
    cols[k, r] = L.indices[src]
    vals[k, r] = L.data[src]
    val_src[k, r] = src
    return LevelSlab(rows=rows.astype(np.int32), cols=cols, vals=vals,
                     diag=diag, val_src=val_src, diag_src=diag_src)


def build_schedule(
    L: CSRMatrix,
    levels: Optional[LevelSets] = None,
    *,
    sort_by_nnz: bool = True,
    bucket_pad_ratio: float = 0.0,
    upper: bool = False,
) -> Schedule:
    """Pack each level into ELL slabs.

    ``bucket_pad_ratio`` > 1 splits a level into several slabs so that within
    a slab ``max_nnz <= ratio * max(min_nnz, 1)`` — the paper's "multiple
    functions per thick level", applied to padding.  Slabs of one level stay
    mutually independent — only level boundaries synchronize.

    ``upper=True`` packs an upper-triangular matrix (diagonal stored first
    per row) over its backward-substitution levels — the transpose-solve
    schedule.  Pass ``L.transpose()`` plus the reverse level sets derived
    from the forward analysis."""
    if levels is None:
        level = compute_upper_levels(L) if upper else None
        levels = build_level_sets(L, level=level)
    slabs = []
    for rows in levels.rows:
        if bucket_pad_ratio and bucket_pad_ratio > 1.0 and rows.size > 1:
            nnz = L.indptr[rows + 1] - L.indptr[rows] - 1
            order = np.argsort(nnz, kind="stable")
            rows_sorted = rows[order]
            nnz_sorted = nnz[order]
            start = 0
            while start < rows_sorted.size:
                kmin = max(int(nnz_sorted[start]), 1)
                end = int(np.searchsorted(
                    nnz_sorted, kmin * bucket_pad_ratio, side="right"))
                end = max(end, start + 1)
                slabs.append(_pack_rows(L, np.sort(rows_sorted[start:end]),
                                        sort_by_nnz, diag_first=upper))
                start = end
        else:
            slabs.append(_pack_rows(L, rows, sort_by_nnz, diag_first=upper))
    return Schedule(n=L.n, slabs=slabs, level_of_row=levels.level, nnz=L.nnz)


def build_ell(M: CSRMatrix) -> EllMatrix:
    """Whole matrix (diagonal included) as ELL, transposed (K, n), with the
    value-source map recorded for value-only refresh."""
    row_nnz = M.row_nnz()
    K = max(int(row_nnz.max()), 1)
    cols = np.zeros((K, M.n), dtype=np.int32)
    vals = np.zeros((K, M.n), dtype=M.dtype)
    val_src = np.full((K, M.n), -1, dtype=np.int64)
    src, i, k = _runs(M.indptr[:-1], row_nnz)
    cols[k, i] = M.indices[src]
    vals[k, i] = M.data[src]
    val_src[k, i] = src
    return EllMatrix(cols=cols, vals=vals, val_src=val_src)


def build_offdiag_ell(M: CSRMatrix, *, upper: bool = False):
    """Split a triangular matrix into its strictly-triangular ELL part ``N``
    and diagonal ``D`` — the ``L = D + N`` decomposition the sweep executor
    iterates on (:mod:`repro_torch.core.sweep`).

    Returns ``(ell, diag, diag_src)``: ``ell`` the off-diagonal part as a
    transposed ``(K, n)`` :class:`EllMatrix` with its value-source map,
    ``diag`` the ``(n,)`` diagonal, ``diag_src`` its indices into
    ``M.data``.  ``upper=True`` reads upper-triangular storage (diagonal
    first per row, e.g. ``L.transpose()``)."""
    row_nnz = M.row_nnz() - 1
    K = max(int(row_nnz.max()) if row_nnz.size else 0, 1)
    cols = np.zeros((K, M.n), dtype=np.int32)
    vals = np.zeros((K, M.n), dtype=M.dtype)
    val_src = np.full((K, M.n), -1, dtype=np.int64)
    src, i, k = _runs(M.indptr[:-1] + (1 if upper else 0), row_nnz)
    cols[k, i] = M.indices[src]
    vals[k, i] = M.data[src]
    val_src[k, i] = src
    diag = M.diagonal(first=upper)
    diag_src = (M.indptr[:-1] if upper else M.indptr[1:] - 1).astype(np.int64)
    return EllMatrix(cols=cols, vals=vals, val_src=val_src), diag, diag_src


@dataclasses.dataclass(frozen=True)
class DeviceEll:
    """An :class:`EllMatrix` on one torch device, as the SpMV kernel reads
    it: ``cols`` (int32 on a card, int64 on the CPU), ``vals`` and the row
    lengths (``None`` on the CPU, whose plain version walks every slot)."""

    cols: torch.Tensor
    vals: torch.Tensor
    row_len: Optional[torch.Tensor]


def device_ell(ell: EllMatrix, n_v: int, device) -> DeviceEll:
    """Upload ``ell`` once to ``device`` for :func:`ell_spmv` over vectors
    of ``n_v`` rows.  Its real entries come first in every column (the ELL
    builders' packing), so a row's length is its count of sourced slots."""
    dev = torch.device(device)
    return DeviceEll(cols=device_cols(ell.cols, n_v, dev),
                     vals=torch.from_numpy(ell.vals).to(dev),
                     row_len=device_row_len((ell.val_src >= 0).sum(0),
                                            ell.cols, dev))


def ell_spmv(ell: DeviceEll, v: torch.Tensor,
             vals: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``y = M v`` for ELL-packed ``M`` on ``v``'s device: one SpMV kernel
    launch on the card (each row stops at its length), the plain version on
    the CPU.  ``v`` may be ``(n,)`` or ``(n, m)``; ``vals`` (a runtime value
    buffer of ``ell.vals``'s shape) replaces the uploaded values, and is
    cast to ``v``'s dtype."""
    vals = ell.vals if vals is None else vals
    return spmv(v, ell.cols, vals.to(v.dtype), ell.row_len)


def serial_arrays(L: CSRMatrix, *, upper: bool = False):
    """Row-major serial-scan arrays plus their refresh source maps.

    Returns ``(cols (n, K), vals (n, K), diag (n,), val_src (n, K),
    diag_src (n,), order (n,))``: ``order`` is the scan order (reversed for
    backward substitution); ``val_src``/``diag_src`` index ``L.data``
    (-1 = padding), so a value-only refresh re-packs the scan operands with
    one vectorized gather."""
    row_nnz = L.row_nnz() - 1
    K = max(int(row_nnz.max()), 1)
    n = L.n
    cols = np.zeros((n, K), dtype=np.int32)
    vals = np.zeros((n, K), dtype=L.dtype)
    val_src = np.full((n, K), -1, dtype=np.int64)
    for i in range(n):
        lo, hi = int(L.indptr[i]), int(L.indptr[i + 1])
        k = hi - lo - 1
        sl = slice(lo + 1, hi) if upper else slice(lo, hi - 1)
        cols[i, :k] = L.indices[sl]
        vals[i, :k] = L.data[sl]
        val_src[i, :k] = np.arange(sl.start, sl.stop, dtype=np.int64)
    diag = L.diagonal(first=upper)
    diag_src = (L.indptr[:-1] if upper else L.indptr[1:] - 1).astype(np.int64)
    order = np.arange(n, dtype=np.int32)
    if upper:
        order = order[::-1]
    return cols, vals, diag, val_src, diag_src, order


def stack_sub_slabs(slab: LevelSlab, n: int, *, with_src: bool = False):
    """Uniform stacked arrays for a coarsened slab's chain: every sub-slab
    zero-padded to the widest one.

    Returns ``(rows, cols, vals, diag)`` of shapes ``(d, Rmax)``,
    ``(d, K, Rmax)``, ``(d, K, Rmax)``, ``(d, Rmax)``.  Padding rows carry
    the sentinel id ``n`` and divide by diag 1.  ``with_src=True`` appends
    the stacked ``(val_src, diag_src)`` refresh maps (-1 padding)."""
    d = slab.depth
    rmax = max(slab.sub_rows) if slab.sub_rows else slab.R
    rows = np.full((d, rmax), n, dtype=np.int32)
    cols = np.zeros((d, slab.K, rmax), dtype=np.int32)
    vals = np.zeros((d, slab.K, rmax), dtype=slab.vals.dtype)
    diag = np.ones((d, rmax), dtype=slab.diag.dtype)
    val_src = np.full((d, slab.K, rmax), -1, dtype=np.int64)
    diag_src = np.full((d, rmax), -1, dtype=np.int64)
    for t, sub in enumerate(slab.sub_slabs()):
        rows[t, : sub.R] = sub.rows
        cols[t, :, : sub.R] = sub.cols
        vals[t, :, : sub.R] = sub.vals
        diag[t, : sub.R] = sub.diag
        if with_src and sub.val_src is not None:
            val_src[t, :, : sub.R] = sub.val_src
            diag_src[t, : sub.R] = sub.diag_src
    if with_src:
        return rows, cols, vals, diag, val_src, diag_src
    return rows, cols, vals, diag


# --------------------------------------------------------------------------
# Scatter-layout executors
# --------------------------------------------------------------------------
def _upload(a: np.ndarray, device, dtype=None) -> torch.Tensor:
    a = np.ascontiguousarray(a if dtype is None else a.astype(dtype, copy=False))
    return torch.from_numpy(a).to(device)


def _coef(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A per-row coefficient broadcast over the batch axis of ``x``."""
    return a if x.dim() == 1 else a[:, None]


def make_serial_solver(L: CSRMatrix, *, upper: bool = False, device="cuda"):
    """Algorithm 1 of the paper: row-serial substitution as a host loop over
    the rows in scan order (reversed for ``upper=True``, the backward
    substitution of the transpose solve), each row one gather, FMA-sum and
    divide of its ``K`` slots, pads included, as the JAX package's
    ``lax.scan`` reads them.  ``b`` may be ``(n,)`` or ``(n, m)``; the
    values are cast to its dtype."""
    dev = torch.device(device)
    cols, vals, diag, _, _, order = serial_arrays(L, upper=upper)
    cols_o = _upload(cols[order], dev, np.int64)
    vals_o = _upload(vals[order], dev)
    diag_o = _upload(diag[order], dev)
    idx = _upload(order, dev, np.int64)
    rows = order.tolist()

    def solve(b: torch.Tensor) -> torch.Tensor:
        v, d = vals_o.to(b.dtype), diag_o.to(b.dtype)
        if b.dim() == 2:
            v = v[:, :, None]
        bo = b.index_select(0, idx)
        x = torch.zeros_like(b)
        for t, i in enumerate(rows):
            x[i] = (bo[t] - (v[t] * x[cols_o[t]]).sum(0)) / d[t]
        return x

    return solve


def _slab_tensors(rows, cols, vals, diag, device) -> tuple:
    return (_upload(rows, device, np.int64), _upload(cols, device, np.int64),
            _upload(vals, device), _upload(diag, device))


def _apply_slab(x, b, slab) -> None:
    """One level as a gather/FMA/divide segment, in place into ``x``:
    ``x[rows] = (b[rows] - sum_k vals[k] * x[cols[k]]) / diag``."""
    rows, cols, vals, diag = slab
    xl = level_solve_ref(x, b.index_select(0, rows), cols,
                         vals.to(x.dtype), diag.to(x.dtype))
    x.index_copy_(0, rows, xl)


def _unrolled_terms(slab: LevelSlab, device) -> tuple:
    """A tiny level's nonzero entries (the JAX package emits one scalar
    term per nonzero value, literal indices and values): ``(rows (R,),
    slot row (E,), column (E,), value (E,), diag (R,))``."""
    k, r = np.nonzero(slab.vals != 0)
    order = np.lexsort((k, r))          # row by row, slots in order
    k, r = k[order], r[order]
    return (_upload(slab.rows, device, np.int64), _upload(r, device, np.int64),
            _upload(slab.cols[k, r], device, np.int64),
            _upload(slab.vals[k, r], device), _upload(slab.diag, device))


def _apply_slab_unrolled(x, b, terms) -> None:
    """A tiny level from its nonzero entries only, in place into ``x``."""
    rows, ridx, cidx, vals, diag = terms
    t = _coef(vals.to(x.dtype), x) * x.index_select(0, cidx)
    s = torch.zeros((rows.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                    device=x.device).index_add_(0, ridx, t)
    xl = (b.index_select(0, rows) - s) / _coef(diag.to(x.dtype), x)
    x.index_copy_(0, rows, xl)


def _apply_slab_chain(x, b_ext, chain) -> None:
    """A coarsened slab: its ``depth`` dependent sub-slabs back to back,
    each a gather/FMA/divide over the stacked uniform arrays.  ``x`` is
    ``(n + 1[, m])`` with the scratch slot last (pad rows carry the row id
    ``n``, read ``b_ext[n] = 0``, divide by 1 and write the slot)."""
    rows, cols, vals, diag = chain
    vals, diag = vals.to(x.dtype), diag.to(x.dtype)
    for t in range(rows.shape[0]):
        xl = level_solve_ref(x, b_ext.index_select(0, rows[t]), cols[t],
                             vals[t], diag[t])
        x.index_copy_(0, rows[t], xl)


def make_levelset_solver(schedule: Schedule, *, unroll_threshold: int = 0,
                         device="cuda"):
    """Level-set executor in the scatter layout: one segment per level in
    level order, in plain torch ops.  ``unroll_threshold > 0`` computes
    levels of at most that many rows from their nonzero entries only (the
    JAX package's constant-embedded scalar code).  Coarsened slabs
    (``depth > 1``) run their sub-slab chain in order, with a scratch slot
    ``n`` for their pad rows (sliced off on return); chains are never
    unrolled.  ``b`` may be ``(n,)`` or ``(n, m)``."""
    dev = torch.device(device)
    n = schedule.n
    chained = any(s.depth > 1 for s in schedule.slabs)
    program = []
    for slab in schedule.slabs:
        if slab.depth > 1:
            program.append(("chain", _slab_tensors(
                *stack_sub_slabs(slab, n), dev)))
        elif slab.R <= unroll_threshold:
            program.append(("unrolled", _unrolled_terms(slab, dev)))
        else:
            program.append(("slab", _slab_tensors(
                slab.rows, slab.cols, slab.vals, slab.diag, dev)))

    def solve(b: torch.Tensor) -> torch.Tensor:
        tail = tuple(b.shape[1:])
        ext = 1 if chained else 0
        x = torch.zeros((n + ext,) + tail, dtype=b.dtype, device=b.device)
        b_ext = torch.cat([b, b.new_zeros((1,) + tail)]) if chained else b
        for kind, slab in program:
            if kind == "chain":
                _apply_slab_chain(x, b_ext, slab)
            elif kind == "unrolled":
                _apply_slab_unrolled(x, b, slab)
            else:
                _apply_slab(x, b, slab)
        return x[:n] if chained else x

    return solve


def make_blocked_solver(bsched, *, device="cuda"):
    """Blocked (supernodal) executor over a
    :class:`~repro_torch.core.coarsen.BlockSchedule`, scatter layout: per
    super-level one panel SpMV launch (the off-block update ``s = Panel
    x``) and one batched dense diagonal-block apply launch

        x_blk = D⁻¹_blk (b_blk − s_blk)

    through :func:`repro_torch.kernels.trsm_block.ops.make_block_apply`.
    ``b`` may be ``(n,)`` or ``(n, m)``.  Lanes are block-major with the
    sentinel row ``n`` for padding, so ``x`` carries one scratch slot, reset
    to zero after every super-level and sliced off on return."""
    from ..kernels.trsm_block.ops import make_block_apply

    apply_blocks = make_block_apply()
    dev = torch.device(device)
    n = bsched.n
    slabs = [(_upload(s.lane_row, dev, np.int64),
              device_cols(s.cols, n + 1, dev), _upload(s.vals, dev),
              _upload(s.dinv, dev), s.B, s.T) for s in bsched.slabs]
    cast = {}

    def solve(b: torch.Tensor) -> torch.Tensor:
        dt = b.dtype
        if dt not in cast:
            cast[dt] = [(v.to(dt), d.to(dt)) for _, _, v, d, _, _ in slabs]
        tail = tuple(b.shape[1:])
        b_ext = torch.cat([b, b.new_zeros((1,) + tail)])
        x = torch.zeros((n + 1,) + tail, dtype=dt, device=b.device)
        for (lane, cols, _, _, B, T), (vals, dinv) in zip(slabs, cast[dt]):
            rhs = b_ext.index_select(0, lane) - spmv(x, cols, vals)
            xb = apply_blocks(dinv, rhs.reshape((B, T) + tail))
            x.index_copy_(0, lane, xb.reshape((B * T,) + tail))
            x[n] = 0
        return x[:n]

    return solve


def make_rhs_transform(res: RewriteResult, *, device="cuda"):
    """``b' = E b`` — the per-solve RHS update of the rewriting method as one
    SpMV launch (each row stops at its length), batched ``B' = E B`` for
    ``B: (n, m)``.  Returns ``None`` when E is the identity (no rewrite
    survived the budgets)."""
    if res.stats.e_nnz_offdiag == 0:
        return None
    ell = device_ell(build_ell(res.E), res.E.n, device)

    def transform(b: torch.Tensor) -> torch.Tensor:
        return ell_spmv(ell, b)

    return transform
