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

Direction-agnostic: a backward (transpose) schedule runs through the same
kernel.
"""
from __future__ import annotations

import numpy as np
import torch

from ...core.codegen import Schedule
from ...core.packed import build_packed_layout, level_table, pack_values, permute_rhs
from ..backend import resolve_device
from . import cuda
from .ref import level_walk_ref
from .table import LevelTable

__all__ = ["make_packed_solver", "level_solve"]


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
