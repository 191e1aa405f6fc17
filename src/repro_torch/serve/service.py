"""Multi-tenant solve service: the front-end that composes the registry
and the per-factor engines (the JAX package's ``serve/service.py``).

Composition (one process, three layers):

* :class:`repro_torch.serve.SolverRegistry` — which factors are resident, LRU +
  byte-budget eviction, cold serial pairs + background planned builds;
* :class:`repro_torch.serve.SolveEngine` — one per resident pattern, drains its
  admission queue as power-of-base-bucketed multi-RHS batches per
  direction (the per-factor worker);
* :class:`SolveService` (this module) — tenant bookkeeping on top:
  ``register`` admits a tenant's factor, ``submit`` enqueues RHS vectors,
  ``step``/``run`` continuously batch queued requests *across tenants* —
  two tenants sharing a (pattern, dtype) land in the same engine queue and
  are answered by one batched dispatch — and ``stats`` aggregates
  per-tenant counters, registry counters, and solve/build latency
  histograms into one dashboard dict.

Sharing semantics: the registry holds one *numeric* factor per (pattern,
dtype) at a time.  Tenants sharing a key share values — a ``refresh``
applies to all of them, after the queue drains (in-flight requests are
answered against the values they were submitted against).  Failures stay
per-request: one tenant's breakdown (e.g. a guarded solver's
``GuardBreakdownError`` on a bad RHS) is carried on that request's
``error`` and never poisons co-batched neighbours.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np

from ..core import CSRMatrix
from .engine import SolveRequest
from .metrics import LatencyHistogram
from .registry import SolverEntry, SolverRegistry

__all__ = ["SolveService", "TenantState"]


@dataclasses.dataclass
class TenantState:
    """Per-tenant bookkeeping: the registry key + factor the tenant is
    currently bound to, its outstanding requests, and counters."""

    name: str
    key: Optional[str] = None
    factor: Optional[CSRMatrix] = None   # host CSR; shares entry's arrays
    outstanding: List[SolveRequest] = dataclasses.field(default_factory=list)
    submitted: int = 0
    completed: int = 0
    failed: int = 0
    refreshes: int = 0
    registrations: int = 0

    def stats(self) -> dict:
        return {
            "key": self.key,
            "queue_depth": len(self.outstanding),
            "submitted": self.submitted,
            "completed": self.completed,
            "failed": self.failed,
            "refreshes": self.refreshes,
            "registrations": self.registrations,
        }


class SolveService:
    """Multi-tenant continuous-batching front-end over a
    :class:`SolverRegistry`.

    Pass an existing ``registry`` or any :class:`SolverRegistry` keyword
    arguments (``strategy=``, ``max_bytes=``, ``background=``,
    ``device=``, ...) to
    build one.  The service is single-front-end-threaded by design — one
    thread calls ``register``/``submit``/``step`` — while planned builds
    run on the registry's background workers."""

    def __init__(self, *, registry: Optional[SolverRegistry] = None,
                 **registry_kwargs):
        if registry is not None and registry_kwargs:
            raise ValueError(
                "pass either a registry or registry kwargs, not both: "
                f"{sorted(registry_kwargs)}")
        self.registry = registry if registry is not None \
            else SolverRegistry(**registry_kwargs)
        self._tenants: Dict[str, TenantState] = {}
        self.solve_hist = LatencyHistogram()
        self.steps = 0
        self.batches_completed = 0

    # -- tenant lifecycle --------------------------------------------------
    def _tenant(self, name: str) -> TenantState:
        st = self._tenants.get(name)
        if st is None:
            st = self._tenants[name] = TenantState(name)
        return st

    def register(self, tenant: str, L: CSRMatrix) -> str:
        """Bind ``tenant`` to a factor and admit it to the registry
        (pattern hit → O(nnz) value refresh; miss → cold pair now +
        background planned build).  Returns the registry key.  Re-register
        to rotate a tenant onto a different factor."""
        st = self._tenant(tenant)
        entry = self.registry.get(L)
        st.key = entry.key
        st.factor = entry.pattern
        st.registrations += 1
        return entry.key

    def refresh(self, tenant: str, new_values, *,
                validate: bool = True) -> None:
        """Same-pattern numeric refresh of the tenant's factor (O(nnz)
        onto the built solvers; the entry queue drains first).
        Visible to every tenant sharing the key — see the module
        docstring's sharing semantics."""
        st = self._tenants.get(tenant)
        if st is None or st.key is None:
            raise ValueError(f"tenant {tenant!r} has no registered factor")
        entry = self._entry(st)
        entry.refresh(new_values, validate=validate)
        st.factor = entry.pattern
        st.refreshes += 1

    def _entry(self, st: TenantState) -> SolverEntry:
        """The tenant's resident entry — re-admitted through the registry
        (cold path + background rebuild) if it was evicted while idle."""
        entry = self.registry.lookup(st.key)
        if entry is None:
            entry = self.registry.get(st.factor)
            st.key = entry.key
            st.factor = entry.pattern
        return entry

    # -- request path ------------------------------------------------------
    def submit(self, tenant: str, b: np.ndarray, *,
               transpose: bool = False) -> SolveRequest:
        """Enqueue one RHS for the tenant's current factor.  The request
        joins the shared per-(pattern, dtype) engine queue and is answered
        by the next drained batch — by the cold serial pair if the planned
        build has not promoted yet."""
        st = self._tenants.get(tenant)
        if st is None or st.key is None:
            raise ValueError(f"tenant {tenant!r} has no registered factor — "
                             "call register(tenant, L) first")
        entry = self._entry(st)
        req = entry.engine.submit(b, transpose=transpose, tenant=tenant)
        st.outstanding.append(req)
        st.submitted += 1
        return req

    def _sweep_completed(self) -> None:
        for st in self._tenants.values():
            if not st.outstanding:
                continue
            still = []
            for r in st.outstanding:
                if not r.done:
                    still.append(r)
                elif r.error is None:
                    st.completed += 1
                else:
                    st.failed += 1
            st.outstanding = still

    def step(self) -> int:
        """One continuous-batching round: every entry with queued requests
        drains one batch per direction (requests from different tenants
        co-batched).  Records per-batch solve latency; returns requests
        completed this round."""
        total = 0
        for key in self.registry.keys():
            entry = self.registry.lookup(key)
            if entry is None or not entry.engine.queue:
                continue
            with entry.lock:     # exclude concurrent refresh/promotion
                t0 = time.perf_counter()
                done = entry.engine.step()
                if done:
                    self.solve_hist.record(time.perf_counter() - t0)
                    self.batches_completed += 1
            total += done
        self.steps += 1
        self._sweep_completed()
        return total

    def run(self, max_steps: int = 10_000) -> int:
        """Drain every queue; returns total requests completed."""
        total = 0
        for _ in range(max_steps):
            done = self.step()
            total += done
            if not done:
                break
        return total

    def queue_depth(self) -> int:
        return sum(len(st.outstanding) for st in self._tenants.values())

    # -- observability -----------------------------------------------------
    def stats(self) -> dict:
        """One dashboard dict: service-wide counters + solve-latency
        histogram, the registry's hit/miss/promotion/eviction/build view,
        and per-tenant counters."""
        tenants = {name: st.stats() for name, st in self._tenants.items()}
        return {
            "tenants": len(tenants),
            "queue_depth": self.queue_depth(),
            "submitted": sum(t["submitted"] for t in tenants.values()),
            "completed": sum(t["completed"] for t in tenants.values()),
            "failed": sum(t["failed"] for t in tenants.values()),
            "steps": self.steps,
            "batches_completed": self.batches_completed,
            "solve_latency": self.solve_hist.summary(),
            "registry": self.registry.stats(),
            "per_tenant": tenants,
        }
