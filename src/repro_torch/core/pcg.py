"""Preconditioned conjugate gradients with an IC(0)/SpTRSV preconditioner —
the workload SpTRSV sits inside (the paper's "building block for several
numerical solutions").

``M⁻¹ r`` is two triangular solves with the incomplete-Cholesky factor,
``L y = r`` then ``Lᵀ z = y``, from one shared analysis
(:meth:`SpTRSV.build_pair`).  ``A p`` is one SpMV kernel launch on ``A``'s
ELL (:func:`repro_torch.core.codegen.ell_spmv`).  The scalars that steer
the loop (``pᵀAp``, the residual norm) are read on the host each
iteration, as the JAX package does.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from .codegen import build_ell, device_ell, ell_spmv
from .csr import CSRMatrix
from .rewrite import RewriteConfig
from .solver import SpTRSV
from .sweep import SweepConfig

__all__ = [
    "PCGResult",
    "BatchedPCGResult",
    "make_ic_preconditioner",
    "make_ic_preconditioner_batched",
    "pcg",
    "pcg_batched",
]


@dataclasses.dataclass
class PCGResult:
    x: torch.Tensor
    iters: int
    residual: float
    converged: bool


@dataclasses.dataclass
class BatchedPCGResult:
    """m independent PCG solves sharing one matrix and preconditioner:
    ``x`` (n, m); ``iters``/``residual``/``converged`` per column (``iters``
    where the column first met the tolerance, ``maxiter`` if never)."""

    x: torch.Tensor
    iters: np.ndarray
    residual: np.ndarray
    converged: np.ndarray


def make_ic_preconditioner(
    L: CSRMatrix,
    *,
    strategy: str = "levelset",
    rewrite: Optional[RewriteConfig] = RewriteConfig(thin_threshold=2),
    sweeps: Optional[int] = None,
    sweep_tol: Optional[float] = None,
    device="cuda",
    guard=None,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Given the lower factor ``L`` (``A ≈ L Lᵀ``), ``z = (L Lᵀ)⁻¹ r`` from
    one :meth:`SpTRSV.build_pair` of ``strategy`` (any of the port's,
    ``"auto"`` included) on ``device``.

    ``sweeps=k`` is the inexact mode: each triangular solve becomes ``k``
    unverified Jacobi sweeps (``strategy="sweep"``, ``fallback=None``), a
    fixed linear operator (the backward apply is the forward one's
    transpose, so ``M⁻¹`` stays symmetric); ``rewrite`` is ignored there.
    ``guard`` (True or a :class:`~repro_torch.core.guard.GuardConfig`)
    wraps both solves in the guarded layer; a loose ``residual_tol`` gives
    the tolerance-aware inexact mode (pair it, like ``sweeps``, with
    ``pcg(..., stall_window=...)``)."""
    if sweeps is not None:
        fwd, bwd = SpTRSV.build_pair(
            L, strategy="sweep", rewrite=None, device=device,
            sweep=SweepConfig(k=sweeps, residual_tol=sweep_tol,
                              fallback=None),
            guard=guard)
    else:
        fwd, bwd = SpTRSV.build_pair(L, strategy=strategy, rewrite=rewrite,
                                     device=device, guard=guard)

    def apply(r: torch.Tensor) -> torch.Tensor:
        return bwd.solve(fwd.solve(r))

    apply.solvers = (fwd, bwd)
    return apply


def make_ic_preconditioner_batched(L: CSRMatrix, **options):
    """Batched ``Z = (L Lᵀ)⁻¹ R`` for ``R: (n, m)``: the executors take
    ``(n, m)`` right-hand sides, so this is :func:`make_ic_preconditioner`
    under the name batched call sites use."""
    return make_ic_preconditioner(L, **options)


def _matvec(A: CSRMatrix, like: torch.Tensor) -> Callable:
    ell = device_ell(build_ell(A), A.n, like.device)
    return lambda v: ell_spmv(ell, v)


def pcg(A: CSRMatrix, b: torch.Tensor, M_inv: Optional[Callable] = None,
        *, tol: float = 1e-8, maxiter: int = 500,
        stall_window: int = 0) -> PCGResult:
    """PCG on SPD ``A`` (host loop, one host read of ``pᵀAp`` and of the
    residual norm per iteration).  ``stall_window`` > 0 stops the loop,
    not converged, once the residual norm has not improved on its best by
    0.1% for that many iterations (for inexact preconditioners)."""
    matvec = _matvec(A, b)
    x = torch.zeros_like(b)
    r = b - matvec(x)
    res = float(torch.linalg.norm(r))
    b_norm = float(torch.linalg.norm(b))
    if b_norm == 0.0:
        b_norm = 1.0
    if res <= tol * b_norm:
        return PCGResult(x, 0, res, True)
    z = M_inv(r) if M_inv else r
    p = z
    rz = torch.dot(r, z)
    best_res = res
    stall = 0
    for it in range(maxiter):
        Ap = matvec(p)
        pap = torch.dot(p, Ap)
        if float(pap) == 0.0:
            # Lanczos breakdown: the last finite iterate, not converged
            return PCGResult(x, it, res, False)
        alpha = rz / pap
        x = x + alpha * p
        r = r - alpha * Ap
        res = float(torch.linalg.norm(r))
        if res <= tol * b_norm:
            return PCGResult(x, it + 1, res, True)
        if stall_window > 0:
            if res < 0.999 * best_res:
                best_res, stall = res, 0
            else:
                stall += 1
                if stall >= stall_window:
                    return PCGResult(x, it + 1, res, False)
        z = M_inv(r) if M_inv else r
        rz_new = torch.dot(r, z)
        p = z + (rz_new / rz) * p
        rz = rz_new
    return PCGResult(x, maxiter, res, False)


def pcg_batched(A: CSRMatrix, B: torch.Tensor,
                M_inv: Optional[Callable] = None, *, tol: float = 1e-8,
                maxiter: int = 500) -> BatchedPCGResult:
    """m independent PCG solves ``A x_j = B[:, j]`` advanced in lockstep:
    one batched SpMV and one batched preconditioner apply per iteration
    serve every column; per-column α/β keep each recurrence that of its
    own run, and converged columns freeze."""
    if B.dim() != 2:
        raise ValueError(f"pcg_batched expects B: (n, m); got {tuple(B.shape)}")
    m = B.shape[1]
    matvec = _matvec(A, B)
    X = torch.zeros_like(B)
    R = B - matvec(X)
    Z = M_inv(R) if M_inv else R
    P = Z
    rz = (R * Z).sum(0)
    b_norm = torch.linalg.norm(B, dim=0).cpu().numpy()
    b_norm = np.where(b_norm == 0.0, 1.0, b_norm)
    iters = np.full((m,), maxiter, dtype=np.int64)
    done = np.zeros((m,), dtype=bool)
    res = torch.linalg.norm(R, dim=0).cpu().numpy()
    done |= res <= tol * b_norm
    iters[done] = 0
    zero = torch.zeros((), dtype=B.dtype, device=B.device)
    one = torch.ones((), dtype=B.dtype, device=B.device)
    for it in range(maxiter):
        if done.all():
            break
        AP = matvec(P)
        pap = (P * AP).sum(0)
        active = torch.from_numpy(~done).to(B.device)
        # frozen columns get α = 0, their pᵀAp guarded against 0
        alpha = torch.where(active, rz / torch.where(pap == 0, one, pap), zero)
        X = X + alpha[None, :] * P
        R = R - alpha[None, :] * AP
        res = torch.linalg.norm(R, dim=0).cpu().numpy()
        newly = (~done) & (res <= tol * b_norm)
        iters[newly] = it + 1
        done |= newly
        if done.all():
            break
        Z = M_inv(R) if M_inv else R
        rz_new = (R * Z).sum(0)
        beta = torch.where(torch.from_numpy(~done).to(B.device),
                           rz_new / torch.where(rz == 0, one, rz), zero)
        P = Z + beta[None, :] * P
        rz = rz_new
    return BatchedPCGResult(x=X, iters=iters, residual=res,
                            converged=done.copy())
