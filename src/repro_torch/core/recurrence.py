"""Linear recurrences as bidiagonal SpTRSV — equation rewriting at work.

The gated linear recurrence used by RG-LRU / mLSTM-style layers,

    h_t = a_t * h_{t-1} + u_t ,        t = 1..T

is exactly a *lower-bidiagonal triangular solve*:

    [ 1                ] [h_1]   [u_1 (+ a_1 h_0)]
    [-a_2  1           ] [h_2]   [u_2]
    [     -a_3  1      ] [h_3] = [u_3]
    [          ...  1  ] [...]   [...]

whose dependency DAG is a pure chain — T levels, the worst case for
level-set SpTRSV (:func:`repro_torch.sparse.chain_matrix`).  Applying the
paper's **equation rewriting** to every row simultaneously — substitute row
t-1's equation into row t — breaks each odd dependency and lifts every row
one level:

    h_t = (a_t a_{t-1}) h_{t-2} + (a_t u_{t-1} + u_t)

i.e. one rewriting sweep squares the "gap": after k sweeps each row depends
on h_{t-2^k}; ceil(log2 T) sweeps empty *all* intermediate levels.  That is
recursive doubling, the parallel scan with the associative combine

    (a2, u2) ∘ (a1, u1) = (a1*a2, a2*u1 + u2)

So the paper's transformation, specialized to the chain matrix, *derives*
the parallel scan that makes RG-LRU / mLSTM training parallel.  The FLOP
increase the paper reports (+10% on lung2) appears here as the
O(T log T)-vs-O(T) work trade of the scan — paid to eliminate T−1
synchronization points, the same bargain.

:func:`linear_recurrence` has three executors (all tested equal):

* ``scan``      a loop over T of ``h = a_t h + u_t`` — paper Algorithm 1 on
                the chain
* ``doubling``  ``ceil(log2 T)`` rewriting sweeps in torch ops — equation
                rewriting to fixpoint; differentiable through autograd
* ``sptrsv``    materialize the bidiagonal matrix, rewrite it and solve it
                with the ``levelset`` solver — the literal paper pipeline
                (small T only; used by tests to close the loop)
"""
from __future__ import annotations

import numpy as np
import torch

from .csr import CSRMatrix, from_coo

__all__ = ["linear_recurrence", "recurrence_as_sptrsv"]

METHODS = ("scan", "doubling", "sptrsv")


def linear_recurrence(a: torch.Tensor, u: torch.Tensor,
                      h0: torch.Tensor | None = None, *,
                      method: str = "doubling", axis: int = 0) -> torch.Tensor:
    """``h_t = a_t h_{t-1} + u_t`` along ``axis``; returns every ``h_t``, in
    ``u``'s shape.  ``a`` and ``u`` have the same shape; ``h0`` (default 0)
    has the state's shape, ``u``'s with ``axis`` removed, and is folded into
    the first input, ``u_1 += a_1 h0``."""
    if method not in METHODS:
        raise ValueError(method)
    ax = axis % u.dim()
    if h0 is not None:
        first = u.select(ax, 0) + a.select(ax, 0) * h0
        u = torch.cat([first.unsqueeze(ax), u.narrow(ax, 1, u.shape[ax] - 1)],
                      ax)
    if method == "sptrsv":
        return _recurrence_via_solver(a, u, axis=ax)
    a_m, u_m = a.movedim(ax, 0), u.movedim(ax, 0)
    if method == "scan":
        h = torch.zeros_like(u_m[0])
        hs = []
        for t in range(u_m.shape[0]):
            h = a_m[t] * h + u_m[t]
            hs.append(h)
        return torch.stack(hs).movedim(0, ax)
    # doubling: sweep k substitutes row t - 2^k into row t, every row at
    # once, from the previous sweep's values (out of place, so autograd
    # sees each sweep)
    T, s = u_m.shape[0], 1
    while s < T:
        u_m = torch.cat([u_m[:s], a_m[s:] * u_m[:-s] + u_m[s:]])
        if 2 * s < T:
            a_m = torch.cat([a_m[:s], a_m[s:] * a_m[:-s]])
        s *= 2
    return u_m.movedim(0, ax)


def _recurrence_via_solver(a: torch.Tensor, u: torch.Tensor, *, axis: int):
    """Literal paper pipeline: build the bidiagonal L of each state lane,
    rewrite every chain row (``thin_threshold=1``) and solve with the
    ``levelset`` solver on ``u``'s device, in f64.  The gates are read on
    the host — this path exists to *prove the equivalence*, not for
    production (tests / small T)."""
    from .rewrite import RewriteConfig
    from .solver import SpTRSV

    a_m = a.detach().movedim(axis, 0)
    T = a_m.shape[0]
    flat_a = a_m.reshape(T, -1).cpu().double().numpy()
    u_m = u.movedim(axis, 0).reshape(T, -1).double()
    cfg = RewriteConfig(thin_threshold=1, max_row_nnz=T + 1,
                        max_fill_ratio=float(T))
    outs = [SpTRSV.build(recurrence_as_sptrsv(flat_a[:, j]), strategy="levelset",
                         rewrite=cfg, device=u.device).solve(u_m[:, j].contiguous())
            for j in range(flat_a.shape[1])]
    h = torch.stack(outs, -1).reshape((T,) + tuple(a_m.shape[1:])).to(u.dtype)
    return h.movedim(0, axis)


def recurrence_as_sptrsv(a: np.ndarray) -> CSRMatrix:
    """The bidiagonal CSR matrix (f64) of the recurrence with gates ``a``
    (T,): ones on the diagonal, ``-a_t`` at ``(t, t-1)`` — exposed so
    benchmarks and tests can inspect its level structure."""
    a = np.asarray(a)
    T = a.shape[0]
    rows = list(range(T)) + list(range(1, T))
    cols = list(range(T)) + list(range(0, T - 1))
    vals = [1.0] * T + (-a[1:]).tolist()
    return from_coo(rows, cols, np.asarray(vals, np.float64), (T, T))
