"""The segment table of a level walk: what
:func:`repro_torch.kernels.sptrsv_level.ops.level_solve` reads besides the
value buffers, built once per solver; and the step table of the scatter
layout's solve (:func:`repro_torch.kernels.sptrsv_level.ops.make_solver`)."""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

__all__ = ["LevelTable", "make_level_table", "GEOMETRY", "WIDE_K",
           "ScatterTable", "make_scatter_table", "SCATTER_GEOMETRY"]

# the columns of a table row
GEOMETRY = ("o", "K", "R_pad", "val_off", "diag_off", "depth", "sub_off")
# a step with more ELL slots than this runs the kernel's warp-per-row
# variant (``kWideK`` of csrc/sptrsv_level.cu)
WIDE_K = 32


@dataclasses.dataclass(frozen=True, eq=False)
class LevelTable:
    """One row ``(o, K, R_pad, val_off, diag_off, depth, sub_off)`` per
    segment, in execution order: one launch each on the card.  A plain
    segment (``depth`` 1, ``sub_off`` −1) writes ``x[o : o + R_pad]`` from
    the ``(K, R_pad)`` slab at ``val_off`` and the diagonal at
    ``diag_off``; a chain runs ``depth`` such sub-steps, sub-step ``t`` at
    write offset ``sub_offs[sub_off + t]`` from the slabs ``t`` further on.

    ``row_len`` holds each row's count of real entries, indexed like the
    diagonal (int32; the kernel stops a row there); ``need`` the least
    length of each buffer the table reaches: ``x`` (rows of ``x`` and
    ``bhat``), ``vals`` (and ``cols``), ``diag``."""

    host: np.ndarray              # (S, 7) int64, C-contiguous
    sub_offs: np.ndarray          # (D,) int64
    sub_offs_dev: torch.Tensor    # the same on the table's device
    row_len: torch.Tensor         # int32 on the table's device
    need: dict

    @property
    def num_segments(self) -> int:
        return self.host.shape[0]

    @functools.cached_property
    def steps(self) -> np.ndarray:
        """``(S', 5)`` int64 rows ``(o, K, R_pad, val_off, diag_off)``, one
        per wavefront: every chain expanded into its sub-steps (the walk of
        the plain version)."""
        return _expand(self.host, self.sub_offs)

    def kinds(self) -> dict:
        """Launches of one walk by kernel variant: ``segment`` (a thread per
        row and column), ``segment_warp`` (a warp per row, K > WIDE_K),
        ``chain`` and ``chain_warp`` (one block walking a chain)."""
        chain = self.host[:, 6] >= 0
        wide = self.host[:, 1] > WIDE_K
        return {"segment": int((~chain & ~wide).sum()),
                "segment_warp": int((~chain & wide).sum()),
                "chain": int((chain & ~wide).sum()),
                "chain_warp": int((chain & wide).sum())}


def _expand(host: np.ndarray, sub_offs: np.ndarray) -> np.ndarray:
    rows = []
    for o, K, Rp, vo, do, depth, so in host.tolist():
        offs = [o] if so < 0 else sub_offs[so: so + depth].tolist()
        rows += [(int(ot), K, Rp, vo + t * K * Rp, do + t * Rp)
                 for t, ot in enumerate(offs)]
    return np.array(rows, dtype=np.int64).reshape(-1, 5)


def make_level_table(geometry: np.ndarray, sub_offs: np.ndarray,
                     row_len: np.ndarray, device) -> LevelTable:
    """The table of segment rows ``geometry`` (``(S, 7)``, the columns of
    :data:`GEOMETRY`), the chains' write offsets ``sub_offs`` and the row
    lengths ``row_len``.  Raises ``ValueError`` on a chain whose offsets
    lie outside ``sub_offs`` or do not start at its ``o``, a plain segment
    with a depth, or a row length outside ``[0, K]``."""
    dev = torch.device(device)
    host = np.ascontiguousarray(geometry, dtype=np.int64).reshape(-1, 7)
    sub_offs = np.ascontiguousarray(sub_offs, dtype=np.int64).reshape(-1)
    row_len = np.ascontiguousarray(row_len, dtype=np.int32).reshape(-1)
    o, K, Rp, voff, doff, depth, so = host.T
    chain = so >= 0
    if ((host[:, 1:6] < 0).any() or (depth < 1).any()
            or (~chain & (depth != 1)).any()
            or (so + depth > sub_offs.size)[chain].any()
            or (sub_offs[so[chain]] != o[chain]).any()):
        raise ValueError("segment table does not match its chains")
    steps = _expand(host, sub_offs)
    need = {"x": int((steps[:, 0] + steps[:, 2]).max()) if steps.size else 0,
            "vals": int((voff + depth * K * Rp).max()) if host.size else 0,
            "diag": int((doff + depth * Rp).max()) if host.size else 0}
    if row_len.size < need["diag"]:
        raise ValueError("row lengths do not cover the table")
    for do, k, rp, d in zip(doff.tolist(), K.tolist(), Rp.tolist(), depth.tolist()):
        lens = row_len[do: do + d * rp]
        if lens.size and (lens.min() < 0 or lens.max() > k):
            raise ValueError(f"row lengths outside [0, {k}]")
    return LevelTable(host=host, sub_offs=sub_offs,
                      sub_offs_dev=torch.from_numpy(sub_offs).to(dev),
                      row_len=torch.from_numpy(row_len).to(dev), need=need)


# the columns of a scatter step
SCATTER_GEOMETRY = ("K", "R_pad", "val_off", "diag_off")


@dataclasses.dataclass(frozen=True, eq=False)
class ScatterTable:
    """One row ``(K, R_pad, val_off, diag_off)`` per wavefront of a scatter
    solve, in execution order (a coarsened chain's sub-steps one by one):
    the step reads the ``(K, R_pad)`` column and value slabs at
    ``val_off``, its row ids and diagonal at ``diag_off``, solves into
    ``x[rows]`` and stores 0 in the scratch slot ``x[n]``.  ``need`` holds
    the least length of each buffer the table reaches (``vals`` and
    ``cols``, ``diag`` and ``rows``) and ``xl``, the widest step's rows."""

    host: np.ndarray              # (S, 4) int64, C-contiguous
    n: int
    need: dict

    @property
    def num_steps(self) -> int:
        return self.host.shape[0]


def make_scatter_table(geometry: np.ndarray, n: int) -> ScatterTable:
    """The table of scatter steps ``geometry`` (``(S, 4)``, the columns of
    :data:`SCATTER_GEOMETRY`) of a system of ``n`` rows.  Raises
    ``ValueError`` on a negative entry."""
    host = np.ascontiguousarray(geometry, dtype=np.int64).reshape(-1, 4)
    if (host < 0).any():
        raise ValueError("scatter step table has a negative entry")
    K, Rp, voff, doff = host.T
    need = {"vals": int((voff + K * Rp).max()) if host.size else 0,
            "diag": int((doff + Rp).max()) if host.size else 0,
            "xl": int(Rp.max()) if host.size else 0}
    return ScatterTable(host=host, n=int(n), need=need)
