"""The segment table of a blocked walk: what
:func:`repro_torch.kernels.trsm_block.ops.blocked_walk` reads besides the
value buffers, uploaded once per solver."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["WalkTable", "make_walk_table", "GEOMETRY"]

# the columns of a table row
GEOMETRY = ("off", "R", "B", "T", "K", "val_off", "dinv_off", "lane_off")


@dataclasses.dataclass(frozen=True, eq=False)
class WalkTable:
    """One row ``(off, R, B, T, K, val_off, dinv_off, lane_off)`` per segment,
    in execution order: the segment writes positions ``[off, off + R)``
    from ``B`` diagonal blocks of ``T`` lanes, its ``(K, B*T)`` panel starts
    at ``val_off``, its ``(B, T, T)`` inverted blocks at ``dinv_off``, its
    lanes at ``lane_off`` of ``lane_row``.

    ``lane_row`` maps a lane to its row in the segment (−1 on pad lanes;
    int32, the kernel's), ``row_lane`` a position to its lane in its segment
    (int64, the plain version's).  ``need`` holds the least length of each
    buffer the table reaches: ``x``, ``vals`` (and ``cols``), ``dinv``."""

    host: np.ndarray              # (S, 8) int64, C-contiguous
    dev: torch.Tensor             # the same on the table's device
    lane_row: torch.Tensor        # (sum B*T,) int32
    row_lane: torch.Tensor        # (n,) int64
    need: dict
    configs: dict = dataclasses.field(default_factory=dict, compare=False)

    @property
    def num_segments(self) -> int:
        return self.host.shape[0]


def make_walk_table(geometry: np.ndarray, lane_idx: list, device) -> WalkTable:
    """The table of a layout with segment rows ``geometry`` (``(S, 8)``, the
    columns of :data:`GEOMETRY`) and, per segment, ``lane_idx[s]`` the lane
    of each of its ``R`` rows (increasing).  Raises ``ValueError`` on a
    table that does not tile ``[0, n)`` or a lane outside its segment."""
    dev = torch.device(device)
    host = np.ascontiguousarray(geometry, dtype=np.int64).reshape(-1, 8)
    off, R, B, T, K, voff, doff, loff = host.T
    n = int(R.sum())
    BT = B * T
    if (host.shape[0] != len(lane_idx) or (host[:, 1:5] < 0).any()
            or (T < 1).any() or (K < 1).any()
            or not np.array_equal(off, np.concatenate([[0], np.cumsum(R)[:-1]]))
            or not np.array_equal(loff, np.concatenate([[0], np.cumsum(BT)[:-1]]))):
        raise ValueError("segment table does not tile its layout")
    lane_row = np.full(int(BT.sum()), -1, dtype=np.int32)
    row_lane = np.zeros(n, dtype=np.int64)
    for s, lanes in enumerate(lane_idx):
        lanes = np.asarray(lanes, dtype=np.int64)
        if lanes.shape != (R[s],) or (lanes.size and (
                lanes.min() < 0 or lanes.max() >= BT[s]
                or (np.diff(lanes) <= 0).any())):
            raise ValueError(f"segment {s}: lanes outside its {BT[s]} lanes")
        lane_row[loff[s] + lanes] = np.arange(R[s], dtype=np.int32)
        row_lane[off[s]: off[s] + R[s]] = lanes
    need = {"x": n,
            "vals": int((voff + K * BT).max()) if host.size else 0,
            "dinv": int((doff + BT * T).max()) if host.size else 0}
    return WalkTable(host=host, dev=torch.from_numpy(host).to(dev),
                     lane_row=torch.from_numpy(lane_row).to(dev),
                     row_lane=torch.from_numpy(row_lane).to(dev), need=need)
