"""Guarded execution layer: verify → refine → fallback for every strategy.

**Verify.**  One componentwise residual pass per solve against the
ORIGINAL (pre-rewrite) system — the sweep executor's ``L = D + N`` split
and backward-error ratio (:func:`repro_torch.core.sweep.residual_terms`,
two SpMV kernel launches on the card).  Reading the ratio on the host is
the guard's one synchronisation per solve (and per refinement step).

**Refine.**  Iterative refinement ``x += solve(r)`` up to
``GuardConfig.refine_steps``: the residual is computed in the work dtype
(f64 for an f64 RHS) even when the inner solve runs in f32, which is what
lets a bf16-storage solve recover f64 accuracy.  A step is kept only if
the worst finite ratio improves.

**Breakdown policies** (``on_breakdown``): columns still above tolerance
are handled by ``"refine"`` (best effort, recorded in the stats),
``"fallback"`` (re-solved by a lazily built exact solver, pivot-repaired
when the value scan raised an alarm, and spliced in) or ``"raise"``
(:class:`GuardBreakdownError`).  An O(nnz) value scan at build and refresh
time feeds the same policies.

**Mixed precision** (``precision="mixed"``): the solver stores its
off-diagonal value buffer in bf16 and its diagonal in f32
(:func:`repro_torch.core.packed.cast_value_buffers`); inner solves run in
f32 (every executor casts its buffers to the RHS dtype, so the kernels
never read bf16) and refinement against the f64 residual recovers the
accuracy.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Callable, Optional

import numpy as np
import torch

from .codegen import device_ell
from .csr import CSRMatrix
from .sweep import (build_sweep_layout, default_residual_tol,
                    pack_sweep_values, residual_terms)

__all__ = [
    "GuardConfig",
    "GuardStats",
    "GuardBreakdownError",
    "GUARD_BREAKDOWN_POLICIES",
    "GUARD_FALLBACK_STRATEGIES",
    "GUARD_PRECISIONS",
    "scan_values",
    "repair_pivots",
    "SolveGuard",
]

logger = logging.getLogger(__name__)

GUARD_BREAKDOWN_POLICIES = ("refine", "fallback", "raise")
GUARD_PRECISIONS = ("native", "mixed")
# Exact strategies the guard may fall back to (as in the JAX package).
GUARD_FALLBACK_STRATEGIES = ("serial", "levelset", "levelset_unroll")


class GuardBreakdownError(RuntimeError):
    """Raised under ``on_breakdown="raise"`` when a guarded build, refresh
    or solve hits a breakdown.  ``columns`` lists the failing RHS columns
    (at solve time); ``ratio`` is the worst residual ratio observed."""

    def __init__(self, message: str, *, columns=None, ratio=None):
        super().__init__(message)
        self.columns = columns
        self.ratio = ratio


@dataclasses.dataclass(frozen=True)
class GuardConfig:
    """Knobs of the guarded execution layer.

    ``residual_tol``  componentwise residual-ratio threshold; ``None`` →
                      ``128·eps`` of the RHS dtype
    ``refine_steps``  max refinement steps (inner solves) per solve
    ``on_breakdown``  ``"refine"`` / ``"fallback"`` / ``"raise"``
    ``fallback``      exact strategy the ``"fallback"`` policy builds
                      (one of :data:`GUARD_FALLBACK_STRATEGIES`)
    ``precision``     ``"native"`` or ``"mixed"`` (bf16 off-diagonal and
                      f32 diagonal storage, f32 inner solves)
    ``pivot_tol``     relative pivot alarm threshold of the value scan
    """

    residual_tol: Optional[float] = None
    refine_steps: int = 2
    on_breakdown: str = "refine"
    fallback: str = "levelset"
    precision: str = "native"
    pivot_tol: float = 0.0

    def __post_init__(self):
        for ok, what in (
                (self.refine_steps >= 0, f"refine_steps={self.refine_steps}"),
                (self.on_breakdown in GUARD_BREAKDOWN_POLICIES,
                 f"on_breakdown={self.on_breakdown!r}"),
                (self.fallback in GUARD_FALLBACK_STRATEGIES,
                 f"fallback={self.fallback!r}"),
                (self.precision in GUARD_PRECISIONS,
                 f"precision={self.precision!r}"),
                (self.pivot_tol >= 0.0, f"pivot_tol={self.pivot_tol}")):
            if not ok:
                raise ValueError(f"GuardConfig: invalid {what}")


@dataclasses.dataclass
class GuardStats:
    """Live guard accounting (mutated by :meth:`SolveGuard.solve`): the JAX
    package's fields and meanings."""

    precision: str = "native"
    solves: int = 0
    verified: int = 0
    refine_steps_total: int = 0
    last_refine_steps: int = 0
    fallback_solves: int = 0
    fallback_columns: int = 0
    breakdown_columns: int = 0
    raised: int = 0
    pivot_alarms: int = 0
    last_residual_ratio: float = 0.0

    def report(self) -> dict:
        return dataclasses.asdict(self)


def scan_values(data, diag_src, *, pivot_tol: float = 0.0):
    """O(nnz) value health scan: ``(nonfinite, bad_pivots)`` counts.  A
    pivot is bad when non-finite, exactly zero, or (with ``pivot_tol > 0``)
    at or below ``pivot_tol`` times the largest finite pivot magnitude."""
    data = np.asarray(data)
    nonfinite = int(data.size - np.count_nonzero(np.isfinite(data)))
    d = data[np.asarray(diag_src)]
    dabs = np.abs(d)
    fin = np.isfinite(d)
    ref = float(dabs[fin].max()) if fin.any() else 0.0
    floor = pivot_tol * ref
    bad = int(np.count_nonzero(~fin | (dabs <= floor) | (d == 0)))
    return nonfinite, bad


def repair_pivots(data, diag_src, *, pivot_tol: float = 0.0):
    """Static pivot perturbation: non-finite, zero and sub-tolerance pivots
    become ``±floor`` (``max(pivot_tol, √eps) · max finite |pivot|``, the
    original sign, positive for zero/NaN), non-finite off-diagonal values
    become 0.  Returns ``(repaired_data, n_repaired)``."""
    data = np.array(data, copy=True)
    diag_src = np.asarray(diag_src)
    bad_vals = ~np.isfinite(data)
    data[bad_vals] = 0.0
    d = data[diag_src]
    dabs = np.abs(d)
    pos = dabs[dabs > 0]
    ref = float(pos.max()) if pos.size else 1.0
    eps = float(np.finfo(data.dtype).eps) if np.issubdtype(
        data.dtype, np.floating) else float(np.finfo(np.float64).eps)
    floor = max(pivot_tol, np.sqrt(eps)) * ref
    bad = dabs <= floor
    sign = np.where(d < 0, -1.0, 1.0)
    data[diag_src[bad]] = (sign * floor)[bad]
    n_rep = int(bad.sum()) + int(bad_vals.sum() - bad_vals[diag_src].sum())
    return data, n_rep


def _worst_finite(ratio_h: np.ndarray) -> float:
    """Worst ratio over the finite-ratio columns (refinement loop control)."""
    fin = ratio_h[np.isfinite(ratio_h)]
    return float(fin.max()) if fin.size else 0.0


def _ratio_host(ratio: torch.Tensor) -> np.ndarray:
    return np.atleast_1d(ratio.cpu().numpy())


class SolveGuard:
    """Wraps ``inner_solve(b) -> x`` with residual verification, iterative
    refinement and breakdown handling (see the module docstring).

    ``system``           the ORIGINAL triangular system the result must
                         satisfy (``upper`` when solved as ``Lᵀ``)
    ``inner_solve``      the wrapped solve pipeline (RHS transform included)
    ``fallback_builder`` ``builder(data) -> solve`` of an exact solver for
                         the same pattern; required for ``"fallback"``
    ``device``           where the residual buffers live
    """

    def __init__(self, system: CSRMatrix, *, upper: bool,
                 config: GuardConfig, inner_solve: Callable,
                 fallback_builder: Optional[Callable] = None, device):
        self.config = config
        self.stats = GuardStats(precision=config.precision)
        self._inner = inner_solve
        self._fallback_builder = fallback_builder
        self._fb: Optional[Callable] = None
        self._layout = build_sweep_layout(system, upper=upper)
        self._ell = device_ell(self._layout.ell, system.n, device)
        self._values = (self._ell.vals,
                        torch.from_numpy(self._layout.diag).to(device))
        self._sys_data = np.asarray(system.data)
        self._pivot_alarm = False
        self._scan("build")

    def _check(self, b, x):
        vals, diag = self._values
        return residual_terms(b, x, vals, diag, self._ell)

    def _scan(self, where: str) -> None:
        nonfinite, bad_pivots = scan_values(
            self._sys_data, self._layout.diag_src,
            pivot_tol=self.config.pivot_tol)
        self._pivot_alarm = bool(nonfinite or bad_pivots)
        if not self._pivot_alarm:
            return
        self.stats.pivot_alarms += 1
        msg = (f"{nonfinite} non-finite value(s) and {bad_pivots} "
               f"zero/sub-tolerance pivot(s) detected at {where}")
        if self.config.on_breakdown == "raise":
            self.stats.raised += 1
            raise GuardBreakdownError(f"guard: {msg}")
        logger.warning("guard: %s — policy %r handles it at solve time",
                       msg, self.config.on_breakdown)

    def refresh(self, sys_data) -> None:
        """Re-pack the full-precision residual buffers in place, drop the
        lazy fallback and re-run the value scan (``SpTRSV.refresh`` calls
        this)."""
        self._sys_data = np.asarray(sys_data)
        for buf, new in zip(self._values,
                            pack_sweep_values(self._layout, self._sys_data)):
            buf.copy_(torch.from_numpy(np.ascontiguousarray(new)))
        self._fb = None
        self._scan("refresh")

    def _fallback_solve(self) -> Callable:
        if self._fb is None:
            data = self._sys_data
            if self._pivot_alarm:
                data, n_rep = repair_pivots(
                    data, self._layout.diag_src,
                    pivot_tol=self.config.pivot_tol)
                logger.warning(
                    "guard: building exact fallback with %d repaired "
                    "pivot/value(s)", n_rep)
            self._fb = self._fallback_builder(data)
        return self._fb

    def solve(self, b: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        stats = self.stats
        work_dt = b.dtype
        tol = (cfg.residual_tol if cfg.residual_tol is not None
               else default_residual_tol(work_dt))
        if cfg.precision == "mixed":
            def run(v):
                return self._inner(v.to(torch.float32)).to(work_dt)
        else:
            run = self._inner

        x = run(b)
        r, ratio = self._check(b, x)
        stats.solves += 1
        ratio_h = _ratio_host(ratio)
        worst = _worst_finite(ratio_h)
        steps = 0
        while ((worst > tol or not np.all(np.isfinite(ratio_h)))
               and steps < cfg.refine_steps):
            x2 = x + run(r)
            r2, ratio2 = self._check(b, x2)
            ratio2_h = _ratio_host(ratio2)
            steps += 1
            w2 = _worst_finite(ratio2_h)
            improved = (w2 < worst
                        or (np.count_nonzero(np.isfinite(ratio2_h))
                            > np.count_nonzero(np.isfinite(ratio_h))))
            if not improved:
                break
            x, r, ratio_h, worst = x2, r2, ratio2_h, w2
        stats.refine_steps_total += steps
        stats.last_refine_steps = steps
        stats.last_residual_ratio = float(
            np.max(np.nan_to_num(ratio_h, nan=np.inf)))
        ok = ratio_h <= tol  # NaN/inf compare False
        if bool(np.all(ok)):
            stats.verified += 1
            return x
        nbad = int(ok.size - np.count_nonzero(ok))
        if cfg.on_breakdown == "raise":
            stats.raised += 1
            raise GuardBreakdownError(
                f"guard: {nbad}/{ok.size} column(s) above residual tol "
                f"{tol:.1e} after {steps} refinement step(s) "
                f"(worst {stats.last_residual_ratio:.1e})",
                columns=np.flatnonzero(~ok), ratio=stats.last_residual_ratio)
        if cfg.on_breakdown == "fallback" and self._fallback_builder is not None:
            xf = self._fallback_solve()(b).to(work_dt)
            stats.fallback_solves += 1
            stats.fallback_columns += nbad
            if x.dim() == 1:
                x = xf
            else:
                x = torch.where(torch.from_numpy(ok).to(x.device)[None, :],
                                x, xf)
            _, ratio3 = self._check(b, x)
            ratio_h = _ratio_host(ratio3)
            stats.last_residual_ratio = float(
                np.max(np.nan_to_num(ratio_h, nan=np.inf)))
            ok = ratio_h <= tol
            if bool(np.all(ok)):
                stats.verified += 1
                return x
            nbad = int(ok.size - np.count_nonzero(ok))
        stats.breakdown_columns += nbad
        logger.warning(
            "guard: %d/%d column(s) above residual tol %.1e after policy "
            "%r (worst %.1e) — returning best effort",
            nbad, ok.size, tol, cfg.on_breakdown, stats.last_residual_ratio)
        return x
