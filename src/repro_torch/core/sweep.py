"""Sync-free speculative solve-then-correct SpTRSV (``strategy="sweep"``).

**Speculate.**  Split ``L = D + N`` (diagonal + strictly-triangular part)
and run ``k`` Jacobi-style triangular sweeps

    x ← D⁻¹ (b − N x),        x₀ = D⁻¹ b

each sweep one whole-matrix update: one SpMV kernel launch on the
off-diagonal ELL (each row stops at its length) and two elementwise ops,
with no per-level structure.  ``D⁻¹N`` is strictly triangular, hence
nilpotent: after ``depth`` sweeps the solve is exact in exact arithmetic,
and with ``q = ‖D⁻¹N‖_∞ < 1`` the error shrinks by ``q`` per sweep.

**Verify.**  After the k-th sweep, :func:`residual_terms` evaluates the
componentwise residual ratio ``max_i |b − L x|_i / (|N||x| + |D||x| +
|b|)_i`` with two SpMV launches (``vals·x`` and ``|vals|·|x|``; exact,
since ``|v·x| = |v|·|x|`` in IEEE arithmetic).  Reading the ratio on the
host is the solve's one synchronisation.

**Correct.**  Columns whose ratio exceeds ``residual_tol`` are re-solved by
an exact strategy (``SweepConfig.fallback``, built lazily) and spliced in.
``fallback=None`` skips verification: the inexact preconditioner mode
(:func:`repro_torch.core.pcg.make_ic_preconditioner` with ``sweeps=k``).

The JAX package runs the ``k`` sweeps as one jitted dispatch; the port runs
``k + 1`` SpMV launches (the last for the verification) plus elementwise
ops — its real cost, reported beside the other strategies.
"""
from __future__ import annotations

import dataclasses
import logging
import math
from typing import Callable, Optional

import numpy as np
import torch

from .codegen import EllMatrix, build_offdiag_ell, device_ell, ell_spmv
from .csr import CSRMatrix
from .packed import gather_src

__all__ = [
    "SweepConfig",
    "SweepStats",
    "SweepLayout",
    "SWEEP_FALLBACK_STRATEGIES",
    "build_sweep_layout",
    "pack_sweep_values",
    "contraction_factor",
    "planned_sweeps",
    "default_residual_tol",
    "residual_terms",
    "make_sweep_executor",
    "make_sweep_solver",
]

logger = logging.getLogger(__name__)

# Exact strategies a non-converged speculative solve may fall back to.
SWEEP_FALLBACK_STRATEGIES = (
    "serial", "levelset", "levelset_unroll", "pallas_level", "pallas_fused")

# Default componentwise residual tolerance in units of the dtype's eps: a
# converged fixed point sits near (K+2)·eps, 128·eps accepts it with margin.
DEFAULT_TOL_EPS_FACTOR = 128.0

# Headroom of the contraction-based sweep-count certificate: the verified
# ratio behaves like C·q^k with C in the tens on observed inputs.
PLAN_MARGIN = 256.0


def default_residual_tol(dtype) -> float:
    """Componentwise residual acceptance threshold for ``dtype`` solves (a
    numpy or torch floating dtype)."""
    if isinstance(dtype, torch.dtype):
        return DEFAULT_TOL_EPS_FACTOR * float(torch.finfo(dtype).eps)
    return DEFAULT_TOL_EPS_FACTOR * float(np.finfo(np.dtype(dtype)).eps)


@dataclasses.dataclass(frozen=True)
class SweepConfig:
    """Knobs of the speculative solve-then-correct executor.

    ``k``             number of Jacobi-style triangular sweeps (also the cap
                      the ``auto`` planner prices sweeps under)
    ``residual_tol``  componentwise residual-ratio acceptance threshold;
                      ``None`` → :func:`default_residual_tol` of the solve
                      dtype
    ``fallback``      exact strategy that re-solves non-converged columns
                      (one of :data:`SWEEP_FALLBACK_STRATEGIES`); ``None``
                      disables verification and correction
    """

    k: int = 32
    residual_tol: Optional[float] = None
    fallback: Optional[str] = "levelset"

    def __post_init__(self):
        if self.k < 1:
            raise ValueError(f"SweepConfig.k must be >= 1, got {self.k}")
        if self.fallback is not None \
                and self.fallback not in SWEEP_FALLBACK_STRATEGIES:
            raise ValueError(
                f"SweepConfig.fallback must be None or one of "
                f"{SWEEP_FALLBACK_STRATEGIES}, got {self.fallback!r}")


@dataclasses.dataclass
class SweepStats:
    """Per-solver speculation accounting, mutated by the solve wrapper:
    ``fallback_solves`` solves where a column failed verification,
    ``fallback_columns`` the corrected columns, ``last_residual_ratio`` the
    worst ratio of the most recent verified solve."""

    k: int
    solves: int = 0
    fallback_solves: int = 0
    fallback_columns: int = 0
    last_residual_ratio: float = 0.0

    def report(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class SweepLayout:
    """``L = D + N`` in ELL form with refresh source maps: ``ell`` the
    strictly-triangular part transposed ``(K, n)``, ``diag`` the diagonal,
    ``diag_src`` its indices into the source matrix's ``data``."""

    n: int
    nnz: int
    ell: EllMatrix
    diag: np.ndarray
    diag_src: np.ndarray

    @property
    def K(self) -> int:
        return self.ell.K


def build_sweep_layout(L: CSRMatrix, *, upper: bool = False) -> SweepLayout:
    """The sweep executor's ``D + N`` split of a triangular system (row
    order, no level analysis)."""
    ell, diag, diag_src = build_offdiag_ell(L, upper=upper)
    return SweepLayout(n=L.n, nnz=L.nnz, ell=ell, diag=diag,
                       diag_src=diag_src)


def pack_sweep_values(layout: SweepLayout, data: np.ndarray):
    """``(vals (K, n), diag (n,))`` numpy buffers for new ``data`` of the
    same pattern (two masked gathers)."""
    vals = gather_src(data, layout.ell.val_src, 0.0, layout.ell.vals.dtype)
    diag = np.asarray(data)[layout.diag_src].astype(
        layout.diag.dtype, copy=False)
    return vals, diag


def contraction_factor(L: CSRMatrix, *, upper: bool = False) -> float:
    """``q = ‖D⁻¹N‖_∞ = max_i Σ_{j≠i} |a_ij| / |a_ii|``: the per-sweep error
    contraction of the Jacobi triangular iteration."""
    if L.n == 0:
        return 0.0
    d = np.abs(L.diagonal(first=upper))
    rows = np.repeat(np.arange(L.n), L.row_nnz())
    offsum = np.bincount(rows, weights=np.abs(L.data), minlength=L.n) - d
    return float((offsum / d).max())


def planned_sweeps(contraction: float, depth: int, tol: float,
                   cap: int) -> Optional[int]:
    """Sweep count the model certifies reaches componentwise ``tol``:
    ``depth`` (nilpotency), improved to ``⌈log(tol / C) / log q⌉`` when
    ``q < 1`` (``C`` = :data:`PLAN_MARGIN`); ``None`` when neither lands
    within ``cap``."""
    k = int(depth)
    if 0.0 < contraction < 1.0:
        k_conv = int(math.ceil(math.log(tol / PLAN_MARGIN)
                               / math.log(contraction)))
        k = min(k, max(k_conv, 1))
    return k if 1 <= k <= cap else None


def _coef(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A per-row coefficient broadcast over the batch axis of ``x``."""
    return a if x.dim() == 1 else a[:, None]


def residual_terms(b: torch.Tensor, x: torch.Tensor, vals: torch.Tensor,
                   diag: torch.Tensor, ell):
    """Componentwise backward-error terms of ``x`` for ``(D + N) x = b``
    against the ``D + N`` split (``ell`` a
    :class:`~repro_torch.core.codegen.DeviceEll` of ``N``'s pattern,
    ``vals``/``diag`` its runtime value buffers).

    Returns ``(r, ratio)``: the residual ``r = b − N x − D x`` and the
    per-column worst ratio ``max_i |r|_i / (|N||x| + |D||x| + |b|)_i``
    (0-d for one RHS).  A column holding a non-finite ``x`` reports
    ``inf``.  ``N x`` and ``|N||x|`` are two SpMV launches."""
    dt = b.dtype
    vf = vals.to(dt)
    dx = _coef(diag.to(dt), b) * x
    s = ell_spmv(ell, x, vf)
    a = ell_spmv(ell, x.abs(), vf.abs())
    r = b - s - dx
    denom = a + dx.abs() + b.abs()
    pos = denom > 0
    ratio = torch.where(pos, r.abs() / torch.where(pos, denom,
                                                   torch.ones_like(denom)),
                        torch.zeros_like(denom)).amax(0)
    bad = ~torch.isfinite(x).all(0)
    return r, torch.where(bad, torch.full_like(ratio, math.inf), ratio)


def make_sweep_executor(layout: SweepLayout, k: int, *, verify: bool = True,
                        runtime_values: bool = True, device) -> Callable:
    """Returns ``run(b, values)``: ``k`` sweeps over ``values = (vals,
    diag)`` (runtime buffers of the layout's shapes), then with ``verify``
    the residual ratio — ``(x, ratio)`` — else just ``x``.  With
    ``runtime_values=False`` (the scatter layout) the layout's values are
    uploaded once here and ``run(b)`` takes no buffers."""
    ell = device_ell(layout.ell, layout.n, device)
    fixed = None
    if not runtime_values:
        fixed = (ell.vals, torch.from_numpy(layout.diag).to(device))

    def run(b: torch.Tensor, values=None):
        vals, diag = fixed if values is None else values
        vf = vals.to(b.dtype)
        d = _coef(diag.to(b.dtype), b)
        x = b / d
        for _ in range(k - 1):
            x = (b - ell_spmv(ell, x, vf)) / d
        if not verify:
            return x
        _, ratio = residual_terms(b, x, vals, diag, ell)
        return x, ratio

    return run


def make_sweep_solver(layout: SweepLayout, config: SweepConfig, *,
                      fallback: Optional[Callable[[], Callable]] = None,
                      runtime_values: bool = True, device):
    """The speculative solve-then-correct wrapper.

    ``fallback`` is a zero-argument provider of an exact ``solve(b)``
    (built lazily), required unless ``config.fallback is None``.  Returns
    ``(solve(b, values), stats, run)``: ``stats`` the live
    :class:`SweepStats`, ``run`` the executor.  With
    ``runtime_values=False`` (the scatter layout) the values are fixed at
    build and ``solve(b)`` takes none."""
    verify = config.fallback is not None
    if verify and fallback is None:
        raise ValueError("a verified sweep solver needs a fallback provider")
    run = make_sweep_executor(layout, config.k, verify=verify,
                              runtime_values=runtime_values, device=device)
    stats = SweepStats(k=config.k)

    def solve(b: torch.Tensor, values=None) -> torch.Tensor:
        out = run(b, values)
        stats.solves += 1
        if not verify:
            return out
        x, ratio = out
        tol = (config.residual_tol if config.residual_tol is not None
               else default_residual_tol(b.dtype))
        ratio_h = np.atleast_1d(ratio.cpu().numpy())
        stats.last_residual_ratio = float(ratio_h.max())
        ok = ratio_h <= tol
        if bool(np.all(ok)):
            return x
        nbad = int(ratio_h.size - np.count_nonzero(ok))
        stats.fallback_solves += 1
        stats.fallback_columns += nbad
        logger.info(
            "sweep: %d/%d column(s) above residual tol %.1e after k=%d "
            "sweeps (worst %.1e) — correcting via %r",
            nbad, ratio_h.size, tol, config.k, stats.last_residual_ratio,
            config.fallback)
        xf = fallback()(b)
        if x.dim() == 1:
            return xf
        # keep the verified columns, splice the exact ones in
        return torch.where(torch.from_numpy(ok).to(x.device)[None, :], x, xf)

    return solve, stats, run
