"""Public SpTRSV API of the port — analysis, schedule, packed layout and
executor tied together, on an explicit torch device.

    solver = SpTRSV.build(L, strategy="pallas_level", device="cuda")
    x = solver.solve(b)          # b: (n,) tensor on the solver's device
    X = solver.solve(B)          # B: (n, m) — m systems in one pass
    bwd = SpTRSV.build(L, transpose=True, device="cuda")   # Lᵀ x = b
    fwd, bwd = SpTRSV.build_pair(L, device="cuda")         # one analysis
    solver.refresh(new_data)     # same pattern, new values, in place

Strategies ported so far (all in ``layout="permuted"``):

``levelset``       the packed level-set executor in plain torch ops — the
                   JAX package's default, kept as the baseline
``pallas_level``   one CUDA level-kernel launch per segment
                   (:mod:`repro_torch.kernels.sptrsv_level`): a wavefront,
                   or a coarsened chain walked by one thread block
``pallas_fused``   the whole solve as one CUDA launch
                   (:mod:`repro_torch.kernels.sptrsv_fused`): for one RHS
                   a synchronisation-free walk in which each row waits
                   only for the rows it reads, for a batch a cooperative
                   grid with a barrier per wavefront span
``blocked``        supernodal: the whole solve as one CUDA launch that
                   walks every super-level's panel update and batched
                   dense diagonal-block apply in order
                   (:mod:`repro_torch.kernels.trsm_block`, the blocked walk)

``rewrite=RewriteConfig(...)`` applies the paper's equation rewriting
before any of them: the solve runs on the rewritten ``L'`` after the RHS
transform ``b' = E b``, one SpMV launch per solve.

On ``device="cpu"`` the kernel strategies run their kernels' plain torch
versions.  Every other strategy or option of the JAX package raises
``NotImplementedError`` naming its ROADMAP item.

Value buffers are persistent device tensors: :meth:`SpTRSV.refresh`
re-packs new values with one vectorized gather and ``copy_``s them into the
same tensors, so their addresses stay fixed.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Callable, Optional

import numpy as np
import torch

from ..kernels.backend import resolve_device
from .analysis import MatrixAnalysis, analyze
from .coarsen import (BlockSchedule, CoarsenConfig, build_block_schedule,
                      coarsen_schedule)
from .codegen import Schedule, build_schedule
from .csr import CSRMatrix
from .levels import (LevelSets, SupernodeConfig, Supernodes, build_level_sets,
                     build_reverse_level_sets, detect_supernodes)
from .packed import (PackedStats, build_packed_blocked_layout,
                     build_packed_layout, make_packed_blocked_solver,
                     make_packed_levelset_solver, make_packed_rhs_transform,
                     pack_blocked_values, pack_values)
from .rewrite import (RewriteConfig, RewriteReplayError, RewriteResult,
                      replay_rewrite_values, rewrite_matrix)

__all__ = ["SpTRSV", "STRATEGIES", "LAYOUTS"]

logger = logging.getLogger(__name__)

STRATEGIES = ("levelset", "pallas_level", "pallas_fused", "blocked")
LAYOUTS = ("permuted",)

# What the JAX package offers and the port does not yet: ROADMAP queue A.
_UNPORTED_STRATEGIES = {
    "serial": "A2", "levelset_unroll": "A2", "auto": "A6", "sweep": "A7",
    "distributed": "A10",
}


def _not_ported(what: str, item: str):
    raise NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP {item})")


def _as_coarsen_config(coarsen) -> Optional[CoarsenConfig]:
    """None/False → off, True → default config, a CoarsenConfig → itself."""
    if coarsen is None or coarsen is False:
        return None
    if coarsen is True:
        return CoarsenConfig()
    if not isinstance(coarsen, CoarsenConfig):
        raise TypeError(f"coarsen must be a bool or CoarsenConfig, got {coarsen!r}")
    return coarsen


def _as_rewrite_config(rewrite) -> Optional[RewriteConfig]:
    """None → no rewriting, a RewriteConfig → itself."""
    if rewrite is not None and not isinstance(rewrite, RewriteConfig):
        raise TypeError(f"rewrite must be a RewriteConfig, got {rewrite!r}")
    return rewrite


def _as_supernode_config(supernodes) -> SupernodeConfig:
    """None/True/False → the default detection config (as in the JAX
    package, where ``False`` only keeps ``blocked`` out of the ``auto``
    planner), a SupernodeConfig → itself."""
    if supernodes is None or supernodes is True or supernodes is False:
        return SupernodeConfig()
    if not isinstance(supernodes, SupernodeConfig):
        raise TypeError(
            f"supernodes must be a bool or SupernodeConfig, got {supernodes!r}")
    return supernodes


def _build_options(*, strategy: str = "levelset", unroll_threshold: int = 4,
                   bucket_pad_ratio: float = 0.0, coarsen=None,
                   layout: str = "permuted", device="cuda", rewrite=None,
                   guard=None, sweep=None, supernodes=None,
                   block_kernel: str = "auto", mesh=None) -> dict:
    """Check the options of :meth:`SpTRSV.build` / :meth:`SpTRSV.build_pair`
    and return the keyword arguments of ``SpTRSV._build_system``.  Options
    of the JAX package that are not ported raise ``NotImplementedError``
    naming their ROADMAP item; unknown values raise ``ValueError``."""
    if strategy in _UNPORTED_STRATEGIES:
        _not_ported(f"strategy={strategy!r}", _UNPORTED_STRATEGIES[strategy])
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown strategy {strategy!r}; ported: {STRATEGIES}")
    if layout == "scatter":
        _not_ported("layout='scatter'", "A2")
    if layout not in LAYOUTS:
        raise ValueError(f"unknown layout {layout!r}; ported: {LAYOUTS}")
    for value, name, item in ((guard, "guard=", "A7"), (sweep, "sweep=", "A7"),
                              (mesh, "mesh=", "A10")):
        if value is not None:
            _not_ported(name, item)
    if block_kernel != "auto":
        # the JAX option picks Pallas or dot_general; the port always runs
        # the kernel on the card and its plain version on the CPU
        raise ValueError(f"block_kernel={block_kernel!r}: the port takes "
                         "'auto' only")
    return dict(strategy=strategy, unroll_threshold=unroll_threshold,
                bucket_pad_ratio=bucket_pad_ratio,
                coarsen=_as_coarsen_config(coarsen),
                rewrite=_as_rewrite_config(rewrite),
                supernodes=_as_supernode_config(supernodes),
                device=resolve_device(device))


def _scan_values(data: np.ndarray, diag_src: np.ndarray):
    """O(nnz) value health scan: ``(nonfinite, bad_pivots)`` counts; a pivot
    is bad when non-finite or exactly zero."""
    nonfinite = int(data.size - np.count_nonzero(np.isfinite(data)))
    d = data[diag_src]
    bad = int(np.count_nonzero(~np.isfinite(d) | (d == 0)))
    return nonfinite, bad


@dataclasses.dataclass
class _RefreshCtx:
    """Cached symbolic state for value-only refresh: ``source`` is the
    user's factor (pattern reference), ``values_map`` reorders its data into
    the solved system's storage (the CSC permutation for transpose solvers),
    ``repack`` turns system (or rewritten ``L'``) data into the executor's
    value arrays.  Rewritten solvers also keep the rewrite (its plan and
    the ``L'``/``E`` patterns), ``e_repack`` for E's values, and
    ``rebuild(data)``, the cold build a plan that does not transfer falls
    back to."""

    source: CSRMatrix
    system: CSRMatrix
    values_map: Optional[np.ndarray]
    repack: Callable
    rewrite: Optional[RewriteResult] = None
    e_repack: Optional[Callable] = None
    rebuild: Optional[Callable] = None


@dataclasses.dataclass
class SpTRSV:
    """A matrix-specialized triangular solver on one torch device.

    ``transpose=True`` solvers execute the backward sweep ``Lᵀ x = b``; the
    executor is the same, only the schedule (backward level sets,
    column-packed slabs) differs.  ``schedule`` is ``None`` for
    ``blocked``, which runs ``block_schedule``."""

    n: int
    strategy: str
    analysis: MatrixAnalysis
    schedule: Optional[Schedule]
    device: torch.device
    _solve_fn: Callable
    _values: tuple
    _refresh_ctx: _RefreshCtx
    transpose: bool = False
    layout: str = "permuted"
    packed_stats: Optional[PackedStats] = None
    block_schedule: Optional[BlockSchedule] = None
    supernodes: Optional[Supernodes] = None
    rewrite_result: Optional[RewriteResult] = None
    _rhs_fn: Optional[Callable] = None
    _e_values: Optional[torch.Tensor] = None

    @staticmethod
    def build(L: CSRMatrix, *, transpose: bool = False, **options) -> "SpTRSV":
        """Build a solver for ``L x = b`` (or ``Lᵀ x = b`` with
        ``transpose=True``).  ``L`` is always the lower-triangular factor.

        Options: ``strategy`` (``"levelset"``, ``"pallas_level"``,
        ``"pallas_fused"``, ``"blocked"``), ``device`` (``"cuda"``, the
        default, or ``"cpu"``), ``rewrite`` (a :class:`RewriteConfig`:
        equation rewriting before the schedule is built, for every
        strategy), ``coarsen`` (True / :class:`CoarsenConfig`: merge
        adjacent levels into chained super-level slabs; ``pallas_fused``
        walks every wavefront anyway), ``supernodes`` (a
        :class:`SupernodeConfig` for ``blocked``; ``block_kernel`` takes
        ``"auto"`` only), ``unroll_threshold`` (enters only the coarsening
        cost model, as in the JAX package), ``bucket_pad_ratio`` (> 1 splits
        levels into nnz buckets) and ``layout="permuted"``.  ``guard``,
        ``sweep`` and ``mesh`` are not ported yet and raise
        ``NotImplementedError`` when given."""
        opts = _build_options(**options)
        if not L.is_lower_triangular():
            raise ValueError("SpTRSV requires lower-triangular L with nonzero diagonal")
        if transpose:
            system, levels = L.transpose(), build_reverse_level_sets(L)
            values_map = np.argsort(L.indices, kind="stable")
        else:
            system, levels = L, build_level_sets(L)
            values_map = None
        return SpTRSV._build_system(system, levels, upper=transpose, source=L,
                                    values_map=values_map, **opts)

    @staticmethod
    def build_pair(L: CSRMatrix, **options) -> tuple["SpTRSV", "SpTRSV"]:
        """Build ``(forward, backward)`` solvers — ``L y = b`` and
        ``Lᵀ z = y`` — from one shared symbolic analysis: the backward level
        sets are derived from the forward wavefronts.  Takes the options of
        :meth:`build`."""
        opts = _build_options(**options)
        if not L.is_lower_triangular():
            raise ValueError("SpTRSV requires lower-triangular L with nonzero diagonal")
        levels = build_level_sets(L)
        fwd = SpTRSV._build_system(L, levels, upper=False, source=L,
                                   values_map=None, **opts)
        bwd = SpTRSV._build_system(
            L.transpose(), build_reverse_level_sets(L, forward=levels),
            upper=True, source=L,
            values_map=np.argsort(L.indices, kind="stable"), **opts)
        return fwd, bwd

    @staticmethod
    def _build_system(
        system: CSRMatrix,
        levels: LevelSets,
        *,
        upper: bool,
        strategy: str,
        unroll_threshold: int,
        bucket_pad_ratio: float,
        coarsen: Optional[CoarsenConfig],
        rewrite: Optional[RewriteConfig],
        supernodes: SupernodeConfig,
        device: torch.device,
        source: CSRMatrix,
        values_map: Optional[np.ndarray],
    ) -> "SpTRSV":
        """``system`` is the triangular matrix actually solved (``L``
        forward, ``L.transpose()`` backward) with its level sets analyzed;
        ``source``/``values_map`` record where its values came from.  With
        ``rewrite`` the executor runs on the rewritten ``target`` (``L'``)
        and the solve first applies ``b' = E b``."""
        build_kwargs = dict(
            upper=upper, strategy=strategy, unroll_threshold=unroll_threshold,
            bucket_pad_ratio=bucket_pad_ratio, coarsen=coarsen,
            rewrite=rewrite, supernodes=supernodes, device=device)
        analysis = analyze(system, levels, upper=upper)
        rres = None
        target, target_levels = system, levels
        rhs_fn = e_values = e_repack = None
        if rewrite is not None:
            rres = rewrite_matrix(system, levels, rewrite, upper=upper)
            target, target_levels = rres.L, rres.levels
            rhs_fn, e_values, e_repack = make_packed_rhs_transform(
                rres, device=device)
        schedule = block_schedule = None
        if strategy != "blocked":
            schedule = build_schedule(target, target_levels, upper=upper,
                                      bucket_pad_ratio=bucket_pad_ratio)
            if coarsen is not None and strategy != "pallas_fused":
                schedule = coarsen_schedule(schedule, coarsen,
                                            unroll_threshold=unroll_threshold)
        if strategy == "blocked":
            # detection and packing run on the (possibly rewritten) target,
            # so blocked composes with rewriting like every other executor
            block_schedule = build_block_schedule(
                target, detect_supernodes(target, upper=upper,
                                          config=supernodes), upper=upper)
            blay = build_packed_blocked_layout(block_schedule)
            fn = make_packed_blocked_solver(blay, device=device)
            values = tuple(torch.from_numpy(a).to(device)
                           for a in pack_blocked_values(blay, target.data))
            repack = lambda data, _bl=blay: pack_blocked_values(_bl, data)  # noqa: E731
            packed_stats = blay.stats()
        elif strategy == "levelset":
            playout = build_packed_layout(schedule)
            fn = make_packed_levelset_solver(playout, device=device)
            values = (torch.from_numpy(playout.vals_flat).to(device),
                      torch.from_numpy(playout.diag_flat).to(device))
            repack = lambda data, _pl=playout: pack_values(_pl, data)  # noqa: E731
            packed_stats = playout.stats()
        elif strategy == "pallas_level":
            from ..kernels.sptrsv_level import ops as level_ops

            fn, values, repack, playout = level_ops.make_packed_solver(
                schedule, device=device)
            packed_stats = playout.stats()
        else:  # pallas_fused
            from ..kernels.sptrsv_fused import ops as fused_ops

            fn, values, repack, flay = fused_ops.make_packed_solver(
                schedule, device=device)
            packed_stats = PackedStats(
                permutation_applied=True,
                value_bytes=int(flay.vals.nbytes + flay.diag.nbytes),
                index_bytes=int(flay.cols.nbytes),
                padded_value_bytes=int(
                    ((flay.val_src < 0).sum() + (flay.diag_src < 0).sum())
                    * flay.vals.itemsize),
                n_pad=flay.n_pad,
                num_segments=1,
            )

        def rebuild(data: np.ndarray) -> "SpTRSV":
            sys_data = data[values_map] if values_map is not None else data
            return SpTRSV._build_system(
                CSRMatrix(system.indptr, system.indices,
                          sys_data.astype(system.dtype, copy=False),
                          system.shape),
                levels, source=CSRMatrix(
                    source.indptr, source.indices,
                    data.astype(source.dtype, copy=False), source.shape),
                values_map=values_map, **build_kwargs)

        return SpTRSV(
            n=system.n, strategy=strategy, analysis=analysis,
            schedule=schedule, device=device, _solve_fn=fn, _values=values,
            _refresh_ctx=_RefreshCtx(
                source=source, system=system, values_map=values_map,
                repack=repack, rewrite=rres, e_repack=e_repack,
                rebuild=rebuild),
            transpose=upper, packed_stats=packed_stats,
            block_schedule=block_schedule,
            supernodes=(block_schedule.supernodes
                        if block_schedule is not None else None),
            rewrite_result=rres, _rhs_fn=rhs_fn, _e_values=e_values)

    @property
    def dtype(self) -> np.dtype:
        """Numeric dtype of the solved system's stored values."""
        return self._refresh_ctx.system.dtype

    @property
    def pattern_hash(self) -> str:
        """Sparsity-pattern digest of the source factor
        (:meth:`CSRMatrix.pattern_hash`)."""
        return self._refresh_ctx.source.pattern_hash()

    def solve(self, b: torch.Tensor) -> torch.Tensor:
        """Solve ``L x = b`` (or ``Lᵀ x = b``).  ``b`` is a floating tensor
        on the solver's device, ``(n,)`` or ``(n, m)``; the matrix values
        are cast to ``b``'s dtype for the solve."""
        if not torch.is_tensor(b):
            raise TypeError(f"b must be a torch tensor, got {type(b).__name__}")
        if b.dim() not in (1, 2) or b.shape[0] != self.n:
            raise ValueError(
                f"b must be ({self.n},) or ({self.n}, m); got {tuple(b.shape)}")
        if b.device.type != self.device.type:
            raise ValueError(f"b is on {b.device}; the solver runs on {self.device}")
        if not b.is_floating_point():
            raise ValueError(f"b must be floating point, got {b.dtype}")
        b = b.contiguous()
        if self._rhs_fn is not None:
            b = self._rhs_fn(b, self._e_values)
        return self._solve_fn(b, self._values)

    def solve_batched(self, B: torch.Tensor) -> torch.Tensor:
        """Explicitly-batched alias: ``B: (n, m)`` → ``X: (n, m)``."""
        if B.dim() != 2:
            raise ValueError(f"solve_batched expects (n, m); got {tuple(B.shape)}")
        return self.solve(B)

    def refresh(self, new_values, *, validate: bool = True) -> "SpTRSV":
        """Value-only numeric refresh: new matrix values of the same
        sparsity pattern, reusing the whole symbolic state.

        ``new_values`` is the new ``data`` array aligned with the original
        factor's CSR storage (or a :class:`CSRMatrix` with the identical
        pattern).  Transpose solvers reorder it through the cached CSC map;
        rewritten solvers replay the recorded elimination plan
        (:func:`repro_torch.core.rewrite.replay_rewrite_values`) for new
        ``L'``/``E`` values in the cached patterns.  The packed value arrays
        are re-packed (gathers; ``blocked`` re-inverts its dense blocks on
        the host) and copied into the existing device tensors.  A plan that
        does not transfer to the new values (a zero pivot, or fill outside
        the cached pattern) falls back to a cold rebuild, whose buffers are
        new.  ``validate`` (default on) raises ``ValueError`` on non-finite
        values or zero pivots.  Returns ``self``."""
        ctx = self._refresh_ctx
        if isinstance(new_values, CSRMatrix):
            src = ctx.source
            if (new_values.nnz != src.nnz
                    or not np.array_equal(new_values.indptr, src.indptr)
                    or not np.array_equal(new_values.indices, src.indices)):
                raise ValueError(
                    "refresh requires the identical sparsity pattern; "
                    "rebuild for structural changes")
            data = np.asarray(new_values.data)
        else:
            data = np.asarray(new_values)
        if data.shape != ctx.source.data.shape:
            raise ValueError(
                f"new values must have shape {ctx.source.data.shape} "
                f"(one per stored nonzero); got {data.shape}")
        if validate:
            nonfinite, zero_piv = _scan_values(data, ctx.source.indptr[1:] - 1)
            if nonfinite or zero_piv:
                raise ValueError(
                    f"refresh: new values contain {nonfinite} non-finite "
                    f"entry(ies) and {zero_piv} zero/non-finite diagonal "
                    f"pivot(s); pass validate=False to accept them anyway")
        sys_data = (data[ctx.values_map] if ctx.values_map is not None
                    else data).astype(ctx.system.dtype, copy=False)
        target_data = sys_data
        if ctx.rewrite is not None:
            rw = ctx.rewrite
            try:
                target_data, e_data = replay_rewrite_values(
                    CSRMatrix(ctx.system.indptr, ctx.system.indices, sys_data,
                              ctx.system.shape), rw.plan, rw.L, rw.E)
            except RewriteReplayError as err:
                logger.warning("SpTRSV.refresh: rewrite plan did not transfer "
                               "(%s) — falling back to a cold rebuild", err)
                self.__dict__.update(ctx.rebuild(data).__dict__)
                return self
            if ctx.e_repack is not None:
                self._e_values.copy_(torch.from_numpy(ctx.e_repack(e_data)))
            self.rewrite_result = dataclasses.replace(
                rw, L=CSRMatrix(rw.L.indptr, rw.L.indices, target_data,
                                rw.L.shape),
                E=CSRMatrix(rw.E.indptr, rw.E.indices, e_data, rw.E.shape))
        for buf, new in zip(self._values, ctx.repack(target_data)):
            buf.copy_(torch.from_numpy(np.ascontiguousarray(new)))
        self._refresh_ctx = dataclasses.replace(
            ctx, source=CSRMatrix(ctx.source.indptr, ctx.source.indices,
                                  data, ctx.source.shape))
        return self

    def stats(self) -> dict:
        """Execution-layout and schedule statistics — the JAX package's
        ``stats()`` keys; options not ported report ``None``."""
        ps = self.packed_stats
        sn = self.supernodes
        an = self.analysis
        rs = self.rewrite_result.stats if self.rewrite_result else None
        return {
            "strategy": self.strategy,
            "layout": self.layout,
            "backend": self.device.type,
            "transpose": self.transpose,
            "n": self.n,
            "nnz": self.analysis.nnz,
            "segments": (self.schedule.num_segments if self.schedule is not None
                         else self.block_schedule.num_segments),
            "supernode_count": (sn.num_supernodes if sn is not None
                                else an.supernode_count),
            "mean_block_size": (sn.mean_block_size if sn is not None
                                else an.mean_block_size),
            "dense_block_fraction": (sn.dense_block_fraction if sn is not None
                                     else an.dense_block_fraction),
            "permutation_applied": bool(ps and ps.permutation_applied),
            "packed_value_bytes": ps.value_bytes,
            "packed_index_bytes": ps.index_bytes,
            "packed_bytes": ps.value_bytes + ps.index_bytes,
            "pattern_hash": self.pattern_hash,
            "padded_value_bytes": ps.padded_value_bytes,
            "n_pad": ps.n_pad,
            "refreshable_in_place": True,
            "rewrite": rs.summary() if rs else None,
            "rewrite_policy": rs.policy if rs else None,
            "critical_path_flops": self.analysis.critical_path_flops,
            "plan": None,
            "planned_transform": None,
            "sweep": None,
            "planned_sweeps": None,
            "guard": None,
            "guard_precision": None,
            "guard_refine_steps": None,
            "guard_fallbacks": None,
            "guard_residual": None,
            "guard_pivot_alarms": None,
        }
