"""``tripre`` — the triangular-solve-preconditioned optimizer: the JAX
package's ``optim/tripre.py`` on the port's solver.

Per 2-D parameter W (d_in × d_out), a Gram accumulator ``G ← β G +
(1-β) g gᵀ / big`` over the smaller dimension ``d``; at a refresh, an
incomplete Cholesky of ``G + λI`` on a band (:func:`banded_ichol`, host
numpy) and two SpTRSVs built from its factor, ``L y = m`` and ``Lᵀ z =
y`` (:func:`make_banded_solvers`): ``repro_torch.core.SpTRSV`` with
``strategy="levelset"`` and equation rewriting, as the reference.  On the
card each rewritten solve runs its ``b' = E b`` on the ELL SpMV kernel.
The momentum ``(d, big)`` is solved as one batched ``(n, m)`` right-hand
side, where the JAX package maps the solve over its columns.

Eligible means 2-D, over whatever tree the optimizer is given: over the
port's per-layer tree that is every block matrix, which is what "per 2-D
parameter" promises.  The JAX package's model tree stacks a scanned
layer's matrices into 3-D leaves, which its ``tripre`` leaves
unpreconditioned (ROADMAP C-ref 13); the port does not copy that.

The reference's band-restricted incomplete Cholesky can break down on a
Gram it meets only over the per-layer tree (a pivot at its ``1e-12``
floor, then entries that overflow: ROADMAP C-ref 15).  :func:`factor`
then raises the diagonal shift tenfold until no pivot breaks down; where
the reference's factor holds, it is the reference's.

The factors live in a host-side cache keyed by the leaf's path, refreshed
every ``refresh_every`` steps; the optimizer's ``stats`` keep, per leaf,
the factor's size, shift and levels before and after the rewrite, and the
seconds of each refresh.

Sharded parameters (DTensors, the sharded Trainer's) are updated whole:
each leaf's gradient, parameter and momentum are gathered, every rank
computes the same update (the factor needs the whole Gram) and keeps its
blocks; the Gram is a plain tensor, whole on every rank.
"""
from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch

from ..tree import leaves, leaves_with_path, unflatten
from .optimizers import Optimizer

__all__ = ["tripre", "banded_ichol", "factor", "make_banded_solvers"]

# the reference's diagonal shift, and the most times factor() raises it
SHIFT, SHIFT_TRIES = 1e-3, 8


def banded_ichol(G: np.ndarray, band: int, shift: float = 1e-3) -> np.ndarray:
    """Incomplete Cholesky restricted to a band; returns dense banded L."""
    n = G.shape[0]
    A = G + shift * np.eye(n) * max(np.trace(G) / n, 1.0)
    L = np.zeros_like(A)
    for i in range(n):
        lo = max(0, i - band)
        for j in range(lo, i + 1):
            s = A[i, j] - L[i, lo:j] @ L[j, lo:j]
            if j < i:
                L[i, j] = s / L[j, j] if L[j, j] != 0 else 0.0
            else:
                L[i, i] = np.sqrt(max(s, 1e-12))
    return L


def factor(G: np.ndarray, band: int) -> tuple[np.ndarray, float]:
    """:func:`banded_ichol` of ``G`` with the reference's shift, or, where a
    pivot breaks down there (a diagonal at the ``1e-6`` floor, or an entry
    that is not finite), with the shift raised tenfold until none does
    (at most ``SHIFT_TRIES`` times): ``(L, shift)``."""
    shift = SHIFT
    with np.errstate(over="ignore", invalid="ignore"):
        for _ in range(SHIFT_TRIES):
            L = banded_ichol(G, band, shift)
            if np.isfinite(L).all() and np.diag(L).min() > 1e-6:
                break
            shift *= 10
    return L, shift


def make_banded_solvers(L_np: np.ndarray, *, use_rewrite: bool = True,
                        device="cuda"):
    """Solvers of the banded factor ``L_np`` on ``device`` by the paper's
    pipeline (level sets, equation rewriting, the level-set executor):
    ``(solve, fwd, bwd)``, ``solve(g)`` = ``L⁻ᵀ L⁻¹ g`` for ``g`` ``(n,)``
    or ``(n, m)``.  The upper solve is a lower solve of the reversed
    system."""
    from ..core.csr import from_dense
    from ..core.rewrite import RewriteConfig
    from ..core.solver import SpTRSV

    L = from_dense(L_np)
    P = np.arange(L_np.shape[0])[::-1]
    Lt_rev = from_dense(L_np.T[np.ix_(P, P)].copy())
    rw = RewriteConfig(thin_threshold=2, max_fill_ratio=4.0) if use_rewrite else None
    fwd = SpTRSV.build(L, strategy="levelset", rewrite=rw, device=device)
    bwd = SpTRSV.build(Lt_rev, strategy="levelset", rewrite=rw, device=device)

    def solve(g: torch.Tensor) -> torch.Tensor:
        y = fwd.solve(g.contiguous())
        return bwd.solve(y.flip(0).contiguous()).flip(0)

    return solve, fwd, bwd


def _sharded_update(one, key, g, p, m, G):
    """``one`` on a sharded leaf: its gradient, parameter and momentum
    gathered whole, the update computed whole on every rank (the same on
    each: the factor needs the whole Gram), each rank keeping its blocks;
    the Gram whole on every rank."""
    from ..models.sharding import shard, spec_of

    p_new, m_new, G = one(key, g.full_tensor(), p.full_tensor(), m.full_tensor(), G)
    spec, mesh = spec_of(p), p.device_mesh
    return shard(p_new, spec, mesh), shard(m_new, spec, mesh), G


def _levels(s) -> dict:
    """The factor's levels before and after its rewrite."""
    rr = s.rewrite_result
    before = s.analysis.num_levels if rr is None else rr.stats.levels_before
    return {"levels_before": int(before),
            "levels_after": int(s.analysis.num_levels if rr is None
                                else rr.stats.levels_after)}


def tripre(lr=3e-4, b1=0.9, beta_g=0.95, band: int = 8,
           refresh_every: int = 20, max_dim: int = 4096,
           weight_decay: float = 0.0,
           schedule: Optional[Callable] = None) -> Optimizer:
    """Momentum + banded-Gram triangular preconditioning.

    State: momentum ``m`` (like params), Gram ``G`` per eligible 2-D param
    (``d × d`` on the smaller side, ``d <= max_dim``; ``(0, 0)`` for the
    others), step counter.  The factors' solvers live in a host-side cache
    keyed by the leaf's path, rebuilt every ``refresh_every`` steps on the
    gradient's device.  Not a graph-capturable update: the refresh
    factorizes on the host, as the reference's.
    """
    cache: dict = {}
    stats: dict = {"factors": {}, "refresh_s": []}

    def eligible(p):
        return p.dim() == 2 and min(p.shape) <= max_dim

    def init(params):
        def gram(p):
            d = min(p.shape) if eligible(p) else 0
            local = p.to_local() if hasattr(p, "to_local") else p
            return local.new_zeros((d, d), dtype=torch.float32)
        flat = leaves(params)
        return {"m": unflatten(params, [torch.zeros_like(p, dtype=torch.float32)
                                        for p in flat]),
                "G": unflatten(params, [gram(p) for p in flat]),
                "step": torch.zeros((), dtype=torch.int32, device=flat[0].device)}

    def update(grads, state, params):
        step = int(state["step"]) + 1
        lr_t = float(schedule(torch.tensor(step)) if schedule else lr)
        refreshed = 0.0

        def one(key, g, p, m, G):
            """One leaf's ``(new p, m, G)``."""
            nonlocal refreshed
            g = g.float()
            m = b1 * m + (1 - b1) * g
            u = m
            if eligible(p):
                wide = p.shape[0] <= p.shape[1]
                gm = g if wide else g.T                     # (d, big)
                G = beta_g * G + (1 - beta_g) * (gm @ gm.T) / gm.shape[1]
                if step % refresh_every == 1 or key not in cache:
                    t0 = time.perf_counter()
                    L_np, shift = factor(G.cpu().numpy(), band)
                    solve, fwd, bwd = make_banded_solvers(L_np, device=g.device)
                    cache[key] = solve
                    refreshed += time.perf_counter() - t0
                    stats["factors"][key] = {"n": L_np.shape[0], "shift": shift,
                                             **_levels(fwd), "transpose": _levels(bwd)}
                um = cache[key](m if wide else m.T)
                u = um if wide else um.T
                # trust region: rescale to the momentum's norm
                u = u * (torch.linalg.vector_norm(m)
                         / torch.clamp(torch.linalg.vector_norm(u), min=1e-12))
            if weight_decay:
                u = u + weight_decay * p.float()
            return (p.float() - lr_t * u).to(p.dtype), m, G

        flat_p, flat_m, flat_G = (leaves(t) for t in (params, state["m"], state["G"]))
        new = [_sharded_update(one, key, g, p, m, G) if hasattr(p, "full_tensor")
               else one(key, g, p, m, G)
               for (key, g), p, m, G in zip(leaves_with_path(grads), flat_p,
                                             flat_m, flat_G)]
        if refreshed:
            stats["refresh_s"].append(refreshed)
        new_p, new_m, new_G = ([n[i] for n in new] for i in range(3))
        return (unflatten(params, new_p),
                {"m": unflatten(params, new_m), "G": unflatten(params, new_G),
                 "step": torch.full((), step, dtype=torch.int32,
                                    device=state["step"].device)})

    return Optimizer(init, update, "tripre", stats)
