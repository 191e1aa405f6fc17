"""Plain torch versions of the level kernel: what the CUDA kernel computes,
in ordinary tensor ops.  The wrapper in :mod:`.ops` runs them for tensors on
the CPU; on the card they are the yardstick the kernel is held against."""
from __future__ import annotations

from .table import LevelTable, ScatterTable

__all__ = ["level_solve_ref", "level_walk_ref", "level_scatter_ref"]


def level_solve_ref(x_pad, bl, cols, vals, diag):
    """xl[r] = (bl[r] - sum_k vals[k,r] * x[cols[k,r]]) / diag[r]

    Handles both single-RHS (x_pad (n_pad,)) and batched (x_pad (n_pad, m))
    layouts, mirroring the kernel pair."""
    if x_pad.dim() == 2:
        s = (vals[..., None] * x_pad[cols]).sum(0)
        return (bl - s) / diag[:, None]
    s = (vals * x_pad[cols]).sum(0)
    return (bl - s) / diag


def level_walk_ref(x, bhat, cols, vals, diag, table: LevelTable) -> None:
    """A segment table run wavefront by wavefront with
    :func:`level_solve_ref`, in place into ``x``: every step
    ``(o, K, R_pad, val_off, diag_off)`` of :attr:`LevelTable.steps` (a
    chain's sub-steps in order) writes ``x[o : o + R_pad]`` — what
    :func:`repro_torch.kernels.sptrsv_level.cuda.level_walk` does on the
    card, one launch per segment."""
    for o, K, Rp, vo, do in table.steps.tolist():
        x[o: o + Rp] = level_solve_ref(
            x, bhat[o: o + Rp], cols[vo: vo + K * Rp].view(K, Rp),
            vals[vo: vo + K * Rp].view(K, Rp), diag[do: do + Rp])


def level_scatter_ref(x, b_ext, rows, cols, vals, diag,
                      table: ScatterTable) -> None:
    """A scatter solve's steps in place into ``x`` (``(n_pad[, m])``, the
    scratch slot at ``n``): every step ``(K, R_pad, val_off, diag_off)`` of
    ``table`` gathers ``bl = b_ext[rows]``, runs :func:`level_solve_ref`,
    stores ``x[rows] = xl`` and resets ``x[n] = 0`` — what
    :func:`repro_torch.kernels.sptrsv_level.cuda.level_scatter` does on the
    card, one launch per step.  ``rows`` and ``cols`` are int64."""
    for K, Rp, vo, do in table.host.tolist():
        r = rows[do: do + Rp]
        xl = level_solve_ref(x, b_ext.index_select(0, r),
                             cols[vo: vo + K * Rp].view(K, Rp),
                             vals[vo: vo + K * Rp].view(K, Rp), diag[do: do + Rp])
        x.index_copy_(0, r, xl)
        x[table.n] = 0
