"""The work table of the single-RHS fused walk: what
:func:`repro_torch.kernels.sptrsv_fused.cuda.fused_solve` reads besides the
layout's value buffers for a single right-hand side, built once per solver
from a :class:`~repro_torch.kernels.sptrsv_fused.ops.FusedLayout`.

The kernel hands out *groups* of rows by ticket: a warp takes the next
group, waits for each position its rows read to be written, and writes
them.  A group holds rows of one chunk (so of one span), so its rows never
read each other; groups of real rows come first, in position order, so a
group only waits on groups with earlier tickets; groups of pad rows follow.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..sptrsv_level.table import WIDE_K

__all__ = ["FusedTable", "fused_table", "GROUP_ROWS", "UNROLL", "WIDE_K"]

# rows of a group at most (the lanes of a warp)
GROUP_ROWS = 32
# terms a lane takes at a time in a group of several rows (``kNarrowUnroll``
# of csrc/sptrsv_fused.cu): a group grows while each of its rows' terms fit
# one such round of its lanes
UNROLL = 4
# ELL slots checked per slice of the build (bounds its temporaries)
_SLICE_SLOTS = 1 << 24
# lanes of each row in a group of r rows: 32 / r rounded up to a power of two
_LANES = [0] + [GROUP_ROWS >> (r - 1).bit_length() for r in range(1, GROUP_ROWS + 1)]


@dataclasses.dataclass(frozen=True, eq=False)
class FusedTable:
    """Groups ``(p0, rows)`` in ticket order: group ``g`` writes positions
    ``[p0, p0 + rows)``; groups ``[0, num_real)`` hold real rows in
    position order, the rest pad rows, which no row waits on.
    ``row_len`` holds each position's count of real ELL entries (they come
    first in its slots); ``pad_cols`` (2, n_pad) the distinct columns of a
    row's pad slots that the plain chunk walk reads already written (below
    the row's chunk), −1 past the last: the kernel adds ``0 * x̂[c]`` for
    each, so a non-finite ``x̂[c]`` gives the plain version's NaN.
    ``groups``, ``row_len`` and ``pad_cols`` are int32 tensors on the
    table's device; ``host_groups`` is the same groups in numpy."""

    n_pad: int
    num_real: int
    host_groups: np.ndarray       # (G, 2) int64
    groups: torch.Tensor          # (G, 2) int32
    row_len: torch.Tensor         # (n_pad,) int32
    pad_cols: torch.Tensor        # (2, n_pad) int32

    @property
    def num_groups(self) -> int:
        return self.host_groups.shape[0]


def _cut(nt: np.ndarray, wide: np.ndarray) -> list:
    """Group sizes over one run of independent rows with ``nt`` terms each:
    a row with ``wide`` set alone, else as many rows (up to GROUP_ROWS) as
    keep every row's terms within one UNROLL round of its lanes (32 /
    the rows rounded up to a power of two)."""
    sizes, i, n = [], 0, nt.size
    while i < n:
        r, most = 1, int(nt[i])
        if not wide[i]:
            while i + r < n and r < GROUP_ROWS and not wide[i + r]:
                m2 = max(most, int(nt[i + r]))
                if m2 > UNROLL * _LANES[r + 1]:
                    break
                most, r = m2, r + 1
        sizes.append(r)
        i += r
    return sizes


def fused_table(layout, device) -> FusedTable:
    """The walk's table of ``layout`` on ``device``.

    Raises ``ValueError`` unless the layout is one the walk can run
    without waiting forever: every slot past a row's real entries is a
    pad (no source, value 0); a row's pads read at most two positions;
    every term a row waits for (a real entry, or a pad below the row's
    chunk) reads a real row below the row's chunk, so of an earlier group.
    It depends on the pattern only, so a value refresh leaves it as it
    is."""
    n, n_pad, K, chunk = layout.n, layout.n_pad, layout.K, layout.chunk
    if layout.val_src is None:
        raise ValueError("the fused layout has no source map of its values")
    dev = torch.device(device)
    real = layout.perm_rows < n
    real_d = torch.from_numpy(real).to(dev)
    lim = torch.arange(n_pad, device=dev) // chunk * chunk
    # slices of whole ELL slots (contiguous rows of the (K, n_pad) arrays),
    # checked where the table goes: on the card for a CUDA table
    rows = max(1, _SLICE_SLOTS // max(n_pad, 1))
    slices = [slice(k, min(K, k + rows)) for k in range(0, K, rows)]

    def on_dev(a, ks):
        return torch.from_numpy(a[ks]).to(dev)

    has = [on_dev(layout.val_src, ks) >= 0 for ks in slices]  # real slots
    nlen = torch.zeros(n_pad, dtype=torch.int64, device=dev)
    for h in has:
        nlen += h.sum(dim=0)
    first = torch.from_numpy(layout.cols[np.minimum(nlen.cpu().numpy(), K - 1),
                                         np.arange(n_pad)] if K else
                             np.zeros(n_pad, np.int32)).to(dev).long()
    hi = torch.full((n_pad,), -1, dtype=torch.int64, device=dev)
    lo = torch.full((n_pad,), n_pad, dtype=torch.int64, device=dev)
    for ks, h in zip(slices, has):
        cols = on_dev(layout.cols, ks).long()
        past = torch.arange(ks.start, ks.stop, device=dev)[:, None] >= nlen
        if ((h & past).any()
                or ((on_dev(layout.vals, ks) != 0) & past).any()):
            raise ValueError(f"a slot past a row's length is not a pad "
                             f"(slots {ks.start}..{ks.stop})")
        if (((cols >= lim) | ~real_d[cols]) & ~past).any():
            raise ValueError(f"a real entry reads a position that is not a "
                             f"real row of an earlier chunk (slots "
                             f"{ks.start}..{ks.stop})")
        other = past & (cols != first)
        hi = torch.maximum(hi, torch.where(other, cols, -1).amax(dim=0))
        lo = torch.minimum(lo, torch.where(other, cols, n_pad).amin(dim=0))
    if ((hi >= 0) & (lo != hi)).any():
        raise ValueError("a row's pads read more than two positions")
    pads = torch.stack([torch.where(nlen < K, first, -1), hi])
    pads = torch.where(pads < lim, pads, -1)  # read as 0 by the plain walk
    if not real_d[pads[pads >= 0]].all():
        raise ValueError("a pad term reads a pad position")
    # the valid ones first
    pad_cols = pads.sort(dim=0, descending=True).values.int().cpu().numpy()
    row_len = nlen.int().cpu().numpy()
    npads = (pad_cols >= 0).sum(axis=0)
    nt = row_len + npads
    groups, pad_groups = [], []
    for off, r_pad in layout.spans:
        R = int(real[off: off + r_pad].sum())
        if not real[off: off + R].all():
            raise ValueError(f"span at {off}: its real rows do not come first")
        for c0 in range(off, off + R, chunk):
            c1 = min(off + R, c0 + chunk)
            p = c0
            for size in _cut(nt[c0:c1], row_len[c0:c1] > WIDE_K):
                groups.append((p, size))
                p += size
        pad_groups += [(p, min(GROUP_ROWS, off + r_pad - p))
                       for p in range(off + R, off + r_pad, GROUP_ROWS)]
    host = np.array(groups + pad_groups, dtype=np.int64).reshape(-1, 2)
    cover = np.zeros(n_pad + 1, dtype=np.int64)   # groups over each position
    np.add.at(cover, host[:, 0], 1)
    np.add.at(cover, host[:, 0] + host[:, 1], -1)
    if (np.cumsum(cover)[:n_pad] != 1).any():
        raise ValueError("the groups do not cover every position once")
    return FusedTable(
        n_pad=n_pad, num_real=len(groups), host_groups=host,
        groups=torch.from_numpy(host.astype(np.int32)).to(dev),
        row_len=torch.from_numpy(row_len).to(dev),
        pad_cols=torch.from_numpy(pad_cols).to(dev))
