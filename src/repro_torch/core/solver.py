"""Public SpTRSV API of the port — analysis, schedule, packed layout and
executor tied together, on an explicit torch device.

    solver = SpTRSV.build(L, strategy="pallas_level", device="cuda")
    x = solver.solve(b)          # b: (n,) tensor on the solver's device
    X = solver.solve(B)          # B: (n, m) — m systems in one pass
    bwd = SpTRSV.build(L, transpose=True, device="cuda")   # Lᵀ x = b
    fwd, bwd = SpTRSV.build_pair(L, device="cuda")         # one analysis
    solver.refresh(new_data)     # same pattern, new values, in place

Strategies (each in ``layout="permuted"``, the default, or
``layout="scatter"``):

``serial``          row-serial substitution (the paper's Algorithm 1) as a
                    Python loop over rows in torch ops: the correctness
                    baseline, a few launches per row
``levelset``        the packed level-set executor in plain torch ops — the
                    JAX package's default, kept as the baseline
``levelset_unroll`` the same, with segments of at most ``unroll_threshold``
                    rows computed from their real entries only
``pallas_level``    one CUDA level-kernel launch per segment
                    (:mod:`repro_torch.kernels.sptrsv_level`): a wavefront,
                    or a coarsened chain walked by one thread block
``pallas_fused``    the whole solve as one CUDA launch
                    (:mod:`repro_torch.kernels.sptrsv_fused`): for one RHS
                    a synchronisation-free walk in which each row waits
                    only for the rows it reads, for a batch a cooperative
                    grid with a barrier per wavefront span
``distributed``     the level solve split over the ranks of one mesh
                    dimension (:mod:`repro_torch.core.dist`,
                    ``mesh=make_mesh((ndev,), ("data",))``): each segment's
                    rows are sharded and one collective per segment
                    (``dist_strategy="all_gather"`` or ``"psum"``)
                    exchanges the solved values; coarsened chains run on
                    every rank with none.  SPMD: every rank builds the same
                    solver and calls ``solve`` with the same ``b``
``blocked``         supernodal: the whole solve as one CUDA launch that
                    walks every super-level's panel update and batched
                    dense diagonal-block apply in order
                    (:mod:`repro_torch.kernels.trsm_block`, the blocked walk)
``sweep``           sync-free speculative solve-then-correct
                    (:mod:`repro_torch.core.sweep`): ``k`` Jacobi sweeps,
                    each one SpMV launch, a verified residual and an exact
                    fallback for the columns that miss
                    (``sweep=SweepConfig(k, residual_tol, fallback)``)
``auto``            the transform planner
                    (:func:`repro_torch.core.coarsen.plan_strategy`): picks
                    the strategy and the transform (rewrite policy ×
                    coarsening) from the device's calibration row
                    (:mod:`repro_torch.core.calibrate`); the decision is
                    ``solver.plan``.  Like the JAX planner it never picks
                    ``pallas_level``.

``rewrite=RewriteConfig(...)`` applies the paper's equation rewriting
before any of them: the solve runs on the rewritten ``L'`` after the RHS
transform ``b' = E b``, one SpMV launch per solve.  ``guard=True`` or a
:class:`~repro_torch.core.guard.GuardConfig` wraps any of them in the
guarded execution layer (verify against the original system, refine,
breakdown policy; ``precision="mixed"`` stores bf16 off-diagonal values).
:meth:`SpTRSV.build_cold` builds the cheapest exact pair (``serial``).

On ``device="cpu"`` the kernel strategies run their kernels' plain torch
versions, and ``distributed`` needs a gloo mesh; on the card an NCCL one.

``layout="permuted"`` runs the solve in schedule-order permuted space with
the values in persistent device tensors: :meth:`SpTRSV.refresh` re-packs
new values with one vectorized gather and ``copy_``s them into the same
tensors, so their addresses stay fixed.  ``layout="scatter"`` is the JAX
package's per-segment scatter layout (:mod:`repro_torch.core.codegen`'s
executors, and each kernel module's ``make_solver``): every segment gathers
``b`` at its row ids and scatters its solution into ``x`` by row id, the
values are fixed when the solver is built, and ``refresh`` falls back to a
cold rebuild.  ``pallas_level`` then runs the TPU level kernel's own step
(``sptrsv_level_scatter``, one launch per wavefront) and ``blocked`` a panel
SpMV and a batched block apply (``trsm_block_apply``) per super-level.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Callable, Optional

import numpy as np
import torch

from ..kernels.backend import resolve_device
from .analysis import MatrixAnalysis, analyze
from .coarsen import (SEGMENT_COST, BlockSchedule, CoarsenConfig, PlanDecision,
                      RewriteCandidate, SweepCandidate, blocked_candidate,
                      build_block_schedule, coarsen_schedule, plan_strategy,
                      should_consider_rewrite)
from .codegen import (Schedule, build_schedule, make_blocked_solver,
                      make_levelset_solver, make_rhs_transform,
                      make_serial_solver)
from .csr import CSRMatrix
from .dist import (axis_size, build_packed_dist_layout,
                   make_distributed_solver, make_packed_distributed_solver,
                   shard_schedule)
from .guard import GuardConfig, SolveGuard, scan_values
from .levels import (LevelSets, SupernodeConfig, Supernodes, build_level_sets,
                     build_reverse_level_sets, detect_supernodes)
from .packed import (PackedStats, build_packed_blocked_layout,
                     build_packed_layout, cast_value_buffers, ell_packed_stats,
                     make_packed_blocked_solver, make_packed_levelset_solver,
                     make_packed_rhs_transform, make_packed_serial_solver,
                     pack_blocked_values, pack_values)
from .rewrite import (RewriteConfig, RewriteReplayError, RewriteResult,
                      replay_rewrite_values, rewrite_matrix)
from .sweep import (SweepConfig, SweepStats, build_sweep_layout,
                    contraction_factor, default_residual_tol,
                    make_sweep_solver, pack_sweep_values, planned_sweeps)

__all__ = ["SpTRSV", "STRATEGIES", "LAYOUTS"]

logger = logging.getLogger(__name__)

STRATEGIES = ("serial", "levelset", "levelset_unroll", "pallas_level",
              "pallas_fused", "distributed", "sweep", "blocked", "auto")
LAYOUTS = ("permuted", "scatter")


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
    """None/True/False → the default detection config (``False`` also keeps
    ``blocked`` out of the ``auto`` planner), a SupernodeConfig → itself."""
    if supernodes is None or supernodes is True or supernodes is False:
        return SupernodeConfig()
    if not isinstance(supernodes, SupernodeConfig):
        raise TypeError(
            f"supernodes must be a bool or SupernodeConfig, got {supernodes!r}")
    return supernodes


def _as_guard_config(guard) -> Optional[GuardConfig]:
    """None/False → unguarded, True → default config, a GuardConfig →
    itself."""
    if guard is None or guard is False:
        return None
    if guard is True:
        return GuardConfig()
    if not isinstance(guard, GuardConfig):
        raise TypeError(f"guard must be a bool or GuardConfig, got {guard!r}")
    return guard


def _as_sweep_config(sweep) -> Optional[SweepConfig]:
    """None/False → off (``strategy="sweep"`` still gets the default;
    ``False`` also keeps sweeps out of the ``auto`` planner), True → default
    config, a SweepConfig → itself."""
    if sweep is None or sweep is False:
        return None
    if sweep is True:
        return SweepConfig()
    if not isinstance(sweep, SweepConfig):
        raise TypeError(f"sweep must be a bool or SweepConfig, got {sweep!r}")
    return sweep


def _build_options(*, strategy: str = "levelset", unroll_threshold: int = 4,
                   bucket_pad_ratio: float = 0.0, coarsen=None,
                   layout: str = "permuted", device="cuda", rewrite=None,
                   guard=None, sweep=None, supernodes=None,
                   block_kernel: str = "auto", mesh=None,
                   mesh_axis: str = "data",
                   dist_strategy: str = "all_gather") -> dict:
    """Check the options of :meth:`SpTRSV.build` / :meth:`SpTRSV.build_pair`
    and return the keyword arguments of ``SpTRSV._build_system``.  Unknown
    or ill-typed values raise ``ValueError`` / ``TypeError``, and so does
    ``strategy="distributed"`` without a mesh (its mesh, axis and
    ``dist_strategy`` are checked where the solver is built,
    :mod:`repro_torch.core.dist`).  ``coarsen``, ``sweep`` and
    ``supernodes`` pass through as given, because ``False`` differs from
    ``None`` for the ``auto`` planner."""
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown strategy {strategy!r}; ported: {STRATEGIES}")
    if layout not in LAYOUTS:
        raise ValueError(f"unknown layout {layout!r}; ported: {LAYOUTS}")
    if strategy == "distributed" and mesh is None:
        raise ValueError("strategy='distributed' needs a mesh "
                         "(repro_torch.launch.mesh.make_mesh)")
    if block_kernel != "auto":
        # the JAX option picks Pallas or dot_general; the port always runs
        # the kernel on the card and its plain version on the CPU
        raise ValueError(f"block_kernel={block_kernel!r}: the port takes "
                         "'auto' only")
    _as_coarsen_config(coarsen)
    _as_sweep_config(sweep)
    _as_supernode_config(supernodes)
    return dict(strategy=strategy, unroll_threshold=unroll_threshold,
                bucket_pad_ratio=bucket_pad_ratio, coarsen=coarsen,
                layout=layout,
                rewrite=_as_rewrite_config(rewrite),
                guard=_as_guard_config(guard), sweep=sweep,
                supernodes=supernodes, device=resolve_device(device), mesh=mesh,
                mesh_axis=mesh_axis, dist_strategy=dist_strategy)


@dataclasses.dataclass
class _RefreshCtx:
    """Cached symbolic state for value-only refresh: ``source`` is the
    user's factor (pattern reference), ``values_map`` reorders its data into
    the solved system's storage (the CSC permutation for transpose solvers),
    ``repack`` turns system (or rewritten ``L'``) data into the executor's
    value arrays (``None`` in the scatter layout, whose values are fixed at
    build).  Rewritten solvers also keep the rewrite (its plan and the
    ``L'``/``E`` patterns), ``e_repack`` for E's values, and
    ``rebuild(data)``, the cold build a plan that does not transfer (or a
    scatter solver) falls back to."""

    source: CSRMatrix
    system: CSRMatrix
    values_map: Optional[np.ndarray]
    repack: Optional[Callable]
    rewrite: Optional[RewriteResult] = None
    e_repack: Optional[Callable] = None
    rebuild: Optional[Callable] = None


@dataclasses.dataclass
class SpTRSV:
    """A matrix-specialized triangular solver on one torch device.

    ``transpose=True`` solvers execute the backward sweep ``Lᵀ x = b``; the
    executor is the same, only the schedule (backward level sets,
    column-packed slabs) differs.  ``schedule`` is ``None`` for
    ``blocked`` (which runs ``block_schedule``), ``serial`` and ``sweep``."""

    n: int
    strategy: str
    analysis: MatrixAnalysis
    schedule: Optional[Schedule]
    device: torch.device
    _solve_fn: Callable
    _values: Optional[tuple]                  # None: values fixed at build
    _refresh_ctx: _RefreshCtx
    transpose: bool = False
    layout: str = "permuted"
    packed_stats: Optional[PackedStats] = None
    block_schedule: Optional[BlockSchedule] = None
    supernodes: Optional[Supernodes] = None
    rewrite_result: Optional[RewriteResult] = None
    plan: Optional[PlanDecision] = None       # strategy="auto" only
    sweep_stats: Optional[SweepStats] = None  # strategy="sweep" only
    guard: Optional[SolveGuard] = None        # guard=
    _rhs_fn: Optional[Callable] = None
    _e_values: Optional[torch.Tensor] = None
    _sweep_exec: Optional[Callable] = None

    @staticmethod
    def build(L: CSRMatrix, *, transpose: bool = False, **options) -> "SpTRSV":
        """Build a solver for ``L x = b`` (or ``Lᵀ x = b`` with
        ``transpose=True``).  ``L`` is always the lower-triangular factor.

        Options: ``strategy`` (see the module docstring; default
        ``"levelset"``), ``device`` (``"cuda"``, the default, or ``"cpu"``),
        ``rewrite`` (a :class:`RewriteConfig`: equation rewriting before the
        schedule is built, for every strategy; with ``auto`` left ``None``
        the planner weighs the ``thin`` and ``critical_path`` policies),
        ``coarsen`` (True / :class:`CoarsenConfig`: merge adjacent levels
        into chained super-level slabs; ``False`` keeps coarsening out of
        ``auto``), ``sweep`` (True / :class:`SweepConfig`: the sweep
        executor's ``k``, tolerance and fallback; caps the sweeps ``auto``
        may certify, ``False`` keeps them out), ``guard`` (True /
        :class:`GuardConfig`: verify every solve against the original
        system, refine, apply the breakdown policy; ``precision="mixed"``
        stores bf16 off-diagonal and f32 diagonal buffers), ``supernodes``
        (a :class:`SupernodeConfig` for ``blocked``; ``False`` keeps it out
        of ``auto``; ``block_kernel`` takes ``"auto"`` only),
        ``unroll_threshold`` (``levelset_unroll``'s segment width, and the
        coarsening cost model's), ``bucket_pad_ratio`` (> 1 splits levels
        into nnz buckets) and ``layout`` (``"permuted"``, the default, or
        ``"scatter"``: see the module docstring; ``guard`` with
        ``precision="mixed"`` needs ``"permuted"``).  ``distributed`` takes
        ``mesh`` (a :class:`~torch.distributed.device_mesh.DeviceMesh` on
        ``device``'s type), ``mesh_axis`` (the dimension to shard over,
        default ``"data"``) and ``dist_strategy`` (``"all_gather"``, the
        default, or ``"psum"``); other strategies ignore them."""
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
    def build_cold(L: CSRMatrix, *, transpose_too: bool = False,
                   **options) -> tuple["SpTRSV", Optional["SpTRSV"]]:
        """The cheapest build for a pattern never seen before: the
        ``serial`` executor, no planner probes, no rewrite candidates, no
        supernode detection, no schedule packing.  Returns ``(forward,
        backward)``; ``backward`` is ``None`` unless ``transpose_too``
        (then both come from one analysis through :meth:`build_pair`).
        Other options (``guard=``, ``device=``, ...) pass through;
        ``strategy`` is pinned to ``"serial"``."""
        options.pop("strategy", None)
        if transpose_too:
            return SpTRSV.build_pair(L, strategy="serial", **options)
        return SpTRSV.build(L, strategy="serial", **options), None

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
        coarsen,
        rewrite: Optional[RewriteConfig],
        guard: Optional[GuardConfig],
        sweep,
        supernodes,
        device: torch.device,
        source: CSRMatrix,
        values_map: Optional[np.ndarray],
        layout: str = "permuted",
        mesh=None,
        mesh_axis: str = "data",
        dist_strategy: str = "all_gather",
    ) -> "SpTRSV":
        """``system`` is the triangular matrix actually solved (``L``
        forward, ``L.transpose()`` backward) with its level sets analyzed;
        ``source``/``values_map`` record where its values came from.  With
        ``rewrite`` (or a rewrite the planner adopts) the executor runs on
        the rewritten ``target`` (``L'``) and the solve first applies
        ``b' = E b``."""
        build_kwargs = dict(
            upper=upper, strategy=strategy, unroll_threshold=unroll_threshold,
            bucket_pad_ratio=bucket_pad_ratio, coarsen=coarsen,
            rewrite=rewrite, guard=guard, sweep=sweep, supernodes=supernodes,
            device=device, layout=layout, mesh=mesh, mesh_axis=mesh_axis,
            dist_strategy=dist_strategy)
        if guard is not None and guard.precision == "mixed" \
                and layout != "permuted":
            raise ValueError(
                "guard precision='mixed' requires layout='permuted' — "
                "mixed storage lowers the runtime value buffers, and the "
                "scatter layout embeds values as trace-time constants")
        permuted = layout == "permuted"
        analysis = analyze(system, levels, upper=upper)
        ccfg = _as_coarsen_config(coarsen)
        scfg = _as_sweep_config(sweep)
        sncfg = _as_supernode_config(supernodes)
        if strategy == "sweep" and scfg is None:
            scfg = SweepConfig()
        rres = None
        target, target_levels = system, levels
        if rewrite is not None:
            rres = rewrite_matrix(system, levels, rewrite, upper=upper)
            target, target_levels = rres.L, rres.levels

        memo: dict = {}

        def _schedule() -> Schedule:
            if "base" not in memo:
                memo["base"] = build_schedule(
                    target, target_levels, upper=upper,
                    bucket_pad_ratio=bucket_pad_ratio)
            return memo["base"]

        def _coarsened(cfg: CoarsenConfig) -> Schedule:
            if "coarse" not in memo:
                memo["coarse"] = coarsen_schedule(
                    _schedule(), cfg, unroll_threshold=unroll_threshold)
            return memo["coarse"]

        def _supernodes() -> Supernodes:
            # detection and packing run on the (possibly rewritten) target,
            # so blocked composes with rewriting like every other executor
            if "sn" not in memo:
                memo["sn"] = detect_supernodes(target, upper=upper,
                                               config=sncfg)
            return memo["sn"]

        def _block_schedule() -> BlockSchedule:
            if "blocked" not in memo:
                memo["blocked"] = build_block_schedule(
                    target, _supernodes(), upper=upper)
            return memo["blocked"]

        plan = None
        if strategy == "auto":
            plan_ccfg = ccfg if ccfg is not None else (
                None if coarsen is False else CoarsenConfig())
            # rewrite candidates are built and priced like everything else
            # when the caller left the rewrite open and the schedule is
            # barrier-dominated
            cands, cand_artifacts = {}, {}
            if rewrite is None and should_consider_rewrite(analysis):
                for policy in ("thin", "critical_path"):
                    rr = rewrite_matrix(system, levels,
                                        RewriteConfig(policy=policy),
                                        upper=upper)
                    if rr.stats.rows_rewritten == 0:
                        continue
                    sched_r = build_schedule(
                        rr.L, rr.levels, upper=upper,
                        bucket_pad_ratio=bucket_pad_ratio)
                    co_r = (coarsen_schedule(sched_r, plan_ccfg,
                                             unroll_threshold=unroll_threshold)
                            if plan_ccfg is not None else None)
                    # b' = E b: one padded ELL SpMV plus one launch
                    k_e = int(np.diff(rr.E.indptr).max())
                    cands[policy] = RewriteCandidate(
                        schedule=sched_r, coarsened=co_r,
                        rhs_cost=2.0 * k_e * system.n + SEGMENT_COST)
                    cand_artifacts[policy] = (rr, sched_r, co_r)
            sweep_cand = None
            if sweep is not False:
                scfg0 = scfg if scfg is not None else SweepConfig()
                q = contraction_factor(target, upper=upper)
                tol = (scfg0.residual_tol if scfg0.residual_tol is not None
                       else default_residual_tol(target.dtype))
                k_plan = planned_sweeps(q, target_levels.num_levels, tol,
                                        scfg0.k)
                if k_plan is not None:
                    row_off = target.row_nnz() - 1
                    sweep_cand = SweepCandidate(
                        k=k_plan,
                        ell_k=max(int(row_off.max()) if row_off.size else 0,
                                  1),
                        n=target.n, contraction=q)
            blocked_cand = None
            if supernodes is not False and _supernodes().mean_block_size >= 1.5:
                blocked_cand = blocked_candidate(_block_schedule())
            plan = plan_strategy(
                analysis, _schedule(),
                _coarsened(plan_ccfg) if plan_ccfg is not None else None,
                unroll_threshold=unroll_threshold, device=device,
                rewritten=cands or None, sweep=sweep_cand,
                blocked=blocked_cand,
                precision=guard.precision if guard is not None else "native")
            strategy = plan.strategy
            if strategy == "sweep":
                scfg = dataclasses.replace(
                    scfg if scfg is not None else SweepConfig(),
                    k=plan.sweep_k)
            if plan.rewrite is not None:
                # adopt the winning rewrite: already built for pricing
                rres, sched_r, co_r = cand_artifacts[plan.rewrite]
                target, target_levels = rres.L, rres.levels
                memo.clear()
                memo["base"] = sched_r
                if co_r is not None:
                    memo["coarse"] = co_r
            if ccfg is not None and strategy in ("levelset", "levelset_unroll"):
                # an explicit coarsen config is a directive: record it
                plan = dataclasses.replace(plan, coarsen=True)
            elif plan.coarsen:
                ccfg = plan_ccfg

        rhs_fn = e_values = e_repack = None
        if rres is not None and permuted:
            rhs_fn, e_values, e_repack = make_packed_rhs_transform(
                rres, device=device)
        elif rres is not None:
            rhs_fn = make_rhs_transform(rres, device=device)

        def _maybe_coarsen(sched: Schedule) -> Schedule:
            return _coarsened(ccfg) if ccfg is not None else sched

        def _upload(arrays) -> tuple:
            return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                         for a in arrays)

        schedule = block_schedule = sweep_stats = sweep_exec = None
        values = repack = packed_stats = None
        if strategy == "serial":
            if permuted:
                fn, values, repack = make_packed_serial_solver(
                    target, upper=upper, device=device)
                packed_stats = PackedStats(
                    permutation_applied=False,
                    value_bytes=sum(int(v.nbytes) for v in values),
                    index_bytes=0, padded_value_bytes=0, n_pad=system.n,
                    num_segments=1)
            else:
                fn = make_serial_solver(target, upper=upper, device=device)
        elif strategy in ("levelset", "levelset_unroll"):
            schedule = _maybe_coarsen(_schedule())
            ut = unroll_threshold if strategy == "levelset_unroll" else 0
            if permuted:
                playout = build_packed_layout(schedule)
                fn = make_packed_levelset_solver(playout, device=device,
                                                 unroll_threshold=ut)
                values = _upload((playout.vals_flat, playout.diag_flat))
                repack = lambda data, _pl=playout: pack_values(_pl, data)  # noqa: E731
                packed_stats = playout.stats()
            else:
                fn = make_levelset_solver(schedule, unroll_threshold=ut,
                                          device=device)
        elif strategy == "pallas_level":
            from ..kernels.sptrsv_level import ops as level_ops

            schedule = _maybe_coarsen(_schedule())
            if permuted:
                fn, values, repack, playout = level_ops.make_packed_solver(
                    schedule, device=device)
                packed_stats = playout.stats()
            else:
                fn = level_ops.make_solver(schedule, device=device)
        elif strategy == "pallas_fused":
            from ..kernels.sptrsv_fused import ops as fused_ops

            # one launch walks every wavefront; coarsening would only
            # re-partition it
            schedule = _schedule()
            if permuted:
                fn, values, repack, flay = fused_ops.make_packed_solver(
                    schedule, device=device)
                packed_stats = PackedStats(
                    permutation_applied=True,
                    value_bytes=int(flay.vals.nbytes + flay.diag.nbytes),
                    index_bytes=int(flay.cols.nbytes),
                    padded_value_bytes=int(
                        (flay.vals.size - repack.sourced
                         + (flay.diag_src < 0).sum()) * flay.vals.itemsize),
                    n_pad=flay.n_pad,
                    num_segments=1,
                )
            else:
                fn = fused_ops.make_solver(schedule, device=device)
        elif strategy == "distributed":
            schedule = _maybe_coarsen(_schedule())
            ndev = axis_size(mesh, mesh_axis)
            if permuted:
                playout = build_packed_dist_layout(schedule, ndev)
                fn, values, repack = make_packed_distributed_solver(
                    playout, mesh, mesh_axis, strategy=dist_strategy,
                    device=device)
                packed_stats = playout.stats()
            else:
                fn = make_distributed_solver(
                    shard_schedule(schedule, ndev), mesh, mesh_axis,
                    strategy=dist_strategy, device=device)
        elif strategy == "blocked":
            block_schedule = _block_schedule()
            if permuted:
                blay = build_packed_blocked_layout(block_schedule)
                fn = make_packed_blocked_solver(blay, device=device)
                values = _upload(pack_blocked_values(blay, target.data))
                repack = lambda data, _bl=blay: pack_blocked_values(_bl, data)  # noqa: E731
                packed_stats = blay.stats()
            else:
                fn = make_blocked_solver(block_schedule, device=device)
        else:  # sweep
            # whole-matrix D + N split, k sweeps, no schedule; the exact
            # fallback is built on first use (in this layout) and kept in
            # step by refresh
            slayout = build_sweep_layout(target, upper=upper)
            cur_target = [target]
            fb_holder: dict = {}

            def _fallback():
                if "s" not in fb_holder:
                    fb_holder["s"] = SpTRSV._build_system(
                        cur_target[0], target_levels, upper=upper,
                        strategy=scfg.fallback, rewrite=None, guard=None,
                        sweep=None, supernodes=None,
                        unroll_threshold=unroll_threshold,
                        bucket_pad_ratio=bucket_pad_ratio, coarsen=coarsen,
                        device=device, source=cur_target[0], values_map=None,
                        layout=layout)
                return fb_holder["s"].solve

            fn, sweep_stats, sweep_exec = make_sweep_solver(
                slayout, scfg,
                fallback=_fallback if scfg.fallback is not None else None,
                runtime_values=permuted, device=device)
            if permuted:
                values = _upload((slayout.ell.vals, slayout.diag))

                def repack(target_data, _sl=slayout, _t=target):
                    cur_target[0] = CSRMatrix(
                        _t.indptr, _t.indices,
                        np.asarray(target_data).astype(_t.dtype, copy=False),
                        _t.shape)
                    if "s" in fb_holder:
                        fb_holder["s"].refresh(cur_target[0].data)
                    return pack_sweep_values(_sl, target_data)

                packed_stats = ell_packed_stats(slayout.ell, slayout.diag,
                                                n=system.n)

        if guard is not None and guard.precision == "mixed":
            # bf16 off-diagonal and f32 diagonal storage; the executors cast
            # to the RHS dtype per solve, and refresh's copy_ casts into them
            values = cast_value_buffers(values)

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

        solver = SpTRSV(
            n=system.n, strategy=strategy, analysis=analysis,
            schedule=schedule, device=device, _solve_fn=fn, _values=values,
            _refresh_ctx=_RefreshCtx(
                source=source, system=system, values_map=values_map,
                repack=repack, rewrite=rres, e_repack=e_repack,
                rebuild=rebuild),
            transpose=upper, layout=layout, packed_stats=packed_stats,
            block_schedule=block_schedule,
            supernodes=(block_schedule.supernodes
                        if block_schedule is not None else None),
            rewrite_result=rres, plan=plan, sweep_stats=sweep_stats,
            _rhs_fn=rhs_fn, _e_values=e_values, _sweep_exec=sweep_exec)
        if guard is not None:
            # verified against the ORIGINAL (pre-rewrite) system, with the
            # exact fallback built on that system; the inner solve reads the
            # live value buffers, so refresh keeps the guard coherent
            def _guard_fallback(data, _sys=system, _lv=levels):
                sys2 = CSRMatrix(_sys.indptr, _sys.indices,
                                 np.asarray(data).astype(_sys.dtype, copy=False),
                                 _sys.shape)
                return SpTRSV._build_system(
                    sys2, _lv, upper=upper, strategy=guard.fallback,
                    rewrite=None, guard=None, sweep=None, supernodes=None,
                    coarsen=None, unroll_threshold=unroll_threshold,
                    bucket_pad_ratio=bucket_pad_ratio, device=device,
                    source=sys2, values_map=None, layout=layout).solve

            solver.guard = SolveGuard(
                system, upper=upper, config=guard,
                inner_solve=solver._solve_raw,
                fallback_builder=_guard_fallback, device=device)
        return solver

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
        are cast to ``b``'s dtype for the solve.  A guarded solver verifies
        the result against the original system, refines it and applies its
        breakdown policy (:meth:`repro_torch.core.guard.SolveGuard.solve`)."""
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
        if self.guard is not None:
            return self.guard.solve(b)
        return self._solve_raw(b)

    def _solve_raw(self, b: torch.Tensor) -> torch.Tensor:
        """The unguarded pipeline (RHS transform + executor) on the live
        value buffers — what the guard wraps and refines."""
        if self._rhs_fn is not None:
            b = (self._rhs_fn(b, self._e_values)
                 if self._e_values is not None else self._rhs_fn(b))
        if self._values is None:
            return self._solve_fn(b)
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
        the host) and copied into the existing device tensors (a mixed
        precision solver's bf16/f32 buffers cast them).  A ``sweep``
        solver's lazily built fallback and a guard's residual buffers are
        refreshed with them.  A scatter-layout solver (values fixed at
        build), and a plan that does not transfer to the new values (a zero
        pivot, or fill outside the cached pattern), fall back to a cold
        rebuild, whose buffers are new.  ``validate`` (default on)
        raises ``ValueError`` on non-finite values or zero pivots; pass
        ``validate=False`` to let a guarded solver's breakdown policy handle
        them.  Returns ``self``."""
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
            nonfinite, zero_piv = scan_values(data, ctx.source.indptr[1:] - 1)
            if nonfinite or zero_piv:
                raise ValueError(
                    f"refresh: new values contain {nonfinite} non-finite "
                    f"entry(ies) and {zero_piv} zero/non-finite diagonal "
                    f"pivot(s); pass validate=False to accept them anyway "
                    f"(a guarded solver then applies its breakdown policy "
                    f"at solve time)")
        def _cold(reason: str) -> "SpTRSV":
            logger.warning("SpTRSV.refresh: %s — falling back to a cold "
                           "rebuild", reason)
            self.__dict__.update(ctx.rebuild(data).__dict__)
            return self

        if ctx.repack is None:
            return _cold(f"layout={self.layout!r} embeds values as "
                         "trace-time constants")
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
                return _cold(f"rewrite plan did not transfer ({err})")
            if ctx.e_repack is not None:
                self._e_values.copy_(torch.from_numpy(ctx.e_repack(e_data)))
            self.rewrite_result = dataclasses.replace(
                rw, L=CSRMatrix(rw.L.indptr, rw.L.indices, target_data,
                                rw.L.shape),
                E=CSRMatrix(rw.E.indptr, rw.E.indices, e_data, rw.E.shape))
        if hasattr(ctx.repack, "into"):
            ctx.repack.into(self._values, target_data)
        else:
            for buf, new in zip(self._values, ctx.repack(target_data)):
                buf.copy_(torch.from_numpy(np.ascontiguousarray(new)))
        self._refresh_ctx = dataclasses.replace(
            ctx, source=CSRMatrix(ctx.source.indptr, ctx.source.indices,
                                  data, ctx.source.shape))
        if self.guard is not None:
            self.guard.refresh(sys_data)
        return self

    def stats(self) -> dict:
        """Execution-layout and schedule statistics — the JAX package's
        ``stats()`` keys."""
        ps = self.packed_stats
        sn = self.supernodes
        an = self.analysis
        rs = self.rewrite_result.stats if self.rewrite_result else None
        gs = self.guard.stats if self.guard is not None else None
        return {
            "strategy": self.strategy,
            "layout": self.layout,
            "backend": self.device.type,
            "transpose": self.transpose,
            "n": self.n,
            "nnz": self.analysis.nnz,
            "segments": (self.schedule.num_segments if self.schedule is not None
                         else self.block_schedule.num_segments
                         if self.block_schedule is not None else 1),
            "supernode_count": (sn.num_supernodes if sn is not None
                                else an.supernode_count),
            "mean_block_size": (sn.mean_block_size if sn is not None
                                else an.mean_block_size),
            "dense_block_fraction": (sn.dense_block_fraction if sn is not None
                                     else an.dense_block_fraction),
            "permutation_applied": bool(ps and ps.permutation_applied),
            "packed_value_bytes": ps.value_bytes if ps else None,
            "packed_index_bytes": ps.index_bytes if ps else None,
            "packed_bytes": ps.value_bytes + ps.index_bytes if ps else None,
            "pattern_hash": self.pattern_hash,
            "padded_value_bytes": ps.padded_value_bytes if ps else None,
            "n_pad": ps.n_pad if ps else None,
            "refreshable_in_place": self._refresh_ctx.repack is not None,
            "rewrite": rs.summary() if rs else None,
            "rewrite_policy": rs.policy if rs else None,
            "critical_path_flops": self.analysis.critical_path_flops,
            "plan": self.plan.reason if self.plan else None,
            "planned_transform": (
                {"rewrite": self.plan.rewrite, "coarsen": self.plan.coarsen}
                if self.plan else None),
            "sweep": (self.sweep_stats.report()
                      if self.sweep_stats is not None else None),
            "planned_sweeps": self.plan.sweep_k if self.plan else None,
            "guard": gs.report() if gs else None,
            "guard_precision": gs.precision if gs else None,
            "guard_refine_steps": gs.refine_steps_total if gs else None,
            "guard_fallbacks": gs.fallback_solves if gs else None,
            "guard_residual": gs.last_residual_ratio if gs else None,
            "guard_pivot_alarms": gs.pivot_alarms if gs else None,
        }
