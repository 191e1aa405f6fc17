"""Pattern-keyed solver registry — the memory tier of the multi-tenant
solve service (the JAX package's ``serve/registry.py``).

The paper's economics (expensive per-matrix analysis amortized over many
solves of the same factor) only pay off at fleet scale if the serving tier
can hold *many* built factors at once and route streams of same-pattern
numeric refreshes onto already-built solvers.  That routing is what
:class:`SolverRegistry` does:

* **Key** — :meth:`repro_torch.core.CSRMatrix.pattern_hash` (structure
  only) plus the value dtype: two tenants sharing a sparsity pattern and
  dtype share one solver pair and one admission queue.
* **Hit** — the factor's *values* are swapped onto the resident pair with
  one O(nnz) ``refresh`` (queue drained first, kernel tables and device
  buffers reused — no analysis, no re-pack of the schedule).
* **Miss** — a cheap ``strategy="serial"`` pair (:meth:`repro_torch.core.
  SpTRSV.build_cold`) is stood up inline so cold traffic is answered
  immediately, while the planned (``strategy="auto"``) build runs on a
  background worker thread and is **promoted atomically** onto the entry's
  engine when it lands (:meth:`repro_torch.serve.SolveEngine.swap_solvers`).
  Values refreshed while the build is in flight are re-applied to the
  built pair before the swap, so promotion never resurrects stale
  numerics.  On the card the worker waits for its own current stream
  before the swap (and after that catch-up refresh), so the serving
  thread never reads a value buffer still being copied.
* **Eviction** — LRU, bounded both by entry count and by resident packed
  bytes (each solver's ``stats()["packed_bytes"]``).  Entries with queued
  requests and the entry just touched are never evicted; an in-flight
  background build whose entry was evicted is discarded on completion.

Torch has no thread-local dtype switch (the JAX registry re-applies
``jax.enable_x64`` on its worker): a built pair's dtype is the factor's.
"""
from __future__ import annotations

import logging
import threading
import time
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

from ..core import CSRMatrix, SpTRSV
from ..kernels.backend import resolve_device
from .engine import SolveEngine
from .metrics import LatencyHistogram

__all__ = ["SolverEntry", "SolverRegistry", "pattern_key"]

logger = logging.getLogger(__name__)


def pattern_key(L: CSRMatrix) -> str:
    """Registry key of a factor: sparsity-pattern digest + value dtype.

    The dtype is part of the key because the built solvers are
    dtype-specialized — an f32 and an f64 tenant sharing a pattern still
    need distinct solver pairs."""
    return f"{L.pattern_hash()}:{np.dtype(L.dtype).name}"


def _settle(solvers) -> None:
    """Wait for the calling thread's current stream on the solvers' card,
    so buffers it filled are complete before another thread reads them."""
    dev = solvers[0].device
    if dev.type == "cuda":
        torch.cuda.current_stream(dev).synchronize()


class SolverEntry:
    """One resident factor: a :class:`SolveEngine` over the current solver
    pair, the latest values, and the cold/ready promotion state.

    ``state`` is ``"cold"`` (serving through the serial pair while the
    planned build is pending/in flight) or ``"ready"`` (planned pair
    promoted).  ``ready_event`` fires at promotion — or at build failure,
    with ``build_error`` set — so callers can wait deterministically."""

    def __init__(self, key: str, L: CSRMatrix, engine: SolveEngine, *,
                 cold_build_seconds: float):
        self.key = key
        self.pattern = L            # values updated on every refresh
        self.engine = engine
        self.state = "cold"
        self.lock = threading.RLock()
        self.version = 0            # bumps on every value refresh
        self.evicted = False
        self.ready_event = threading.Event()
        self.build_error: Optional[Exception] = None
        self.cold_build_seconds = cold_build_seconds
        self.planned_build_seconds: Optional[float] = None
        self.value_refreshes = 0
        self.cold_completed = 0     # requests answered before promotion
        self.last_used = time.monotonic()

    @property
    def packed_bytes(self) -> int:
        """Resident packed-buffer footprint of the entry's current pair —
        what the registry's byte budget charges."""
        total = 0
        for s in (self.engine.solver, self.engine.solver_t):
            if s is None:
                continue
            pb = s.stats()["packed_bytes"]
            total += int(pb) if pb else 0
        return total

    def refresh(self, new_values, *, validate: bool = True) -> None:
        """O(nnz) value swap onto the resident pair (drains the engine
        queue first — see :meth:`SolveEngine.refresh`) and record the new
        values as the entry's latest, so an in-flight background build
        re-applies them before promotion."""
        data = (np.asarray(new_values.data)
                if isinstance(new_values, CSRMatrix)
                else np.asarray(new_values))
        with self.lock:
            self.engine.refresh(data, validate=validate)
            p = self.pattern
            self.pattern = CSRMatrix(p.indptr, p.indices,
                                     data.astype(p.dtype, copy=False),
                                     p.shape)
            self.version += 1
            self.value_refreshes += 1

    def wait_ready(self, timeout: Optional[float] = None) -> bool:
        """Block until the planned build promoted (or failed — then the
        entry keeps serving through the cold pair and ``build_error`` says
        why).  Returns the event state."""
        return self.ready_event.wait(timeout)

    def stats(self) -> dict:
        with self.lock:
            return {
                "state": self.state,
                "packed_bytes": self.packed_bytes,
                "queue_depth": len(self.engine.queue),
                "solved": self.engine.solved,
                "failed": self.engine.failed,
                "cold_completed": (self.cold_completed
                                   if self.state == "ready"
                                   else self.engine.solved
                                   + self.engine.failed),
                "value_refreshes": self.value_refreshes,
                "cold_build_s": self.cold_build_seconds,
                "planned_build_s": self.planned_build_seconds,
                "strategy": self.engine.solver.strategy,
                "build_error": (repr(self.build_error)
                                if self.build_error else None),
            }


class SolverRegistry:
    """LRU registry of built :class:`SpTRSV` pairs keyed by sparsity
    pattern (+ dtype).  See the module docstring for the hit/miss/eviction
    contract.

    ``max_entries`` / ``max_bytes`` bound residency (``None`` = unbounded);
    ``background=False`` runs the planned build inline on admission (the
    deterministic mode tests use); ``build_gate`` is an optional
    :class:`threading.Event` every background worker waits on before
    building — a test/benchmark hook that makes "cold traffic answered
    while the build is in flight" reproducible instead of a race.
    ``device`` (default ``"cuda"``) is where every solver is built and
    run; ``**build_kwargs`` (``guard=``, ``coarsen=``, ...) apply to the
    cold and the planned build alike."""

    def __init__(self, *, strategy: str = "auto",
                 transpose_too: bool = True,
                 max_entries: Optional[int] = None,
                 max_bytes: Optional[int] = None,
                 max_batch: int = 64, bucket_base: int = 2,
                 background: bool = True,
                 build_gate: Optional[threading.Event] = None,
                 device="cuda",
                 **build_kwargs):
        if max_entries is not None and max_entries < 1:
            raise ValueError(f"max_entries must be >= 1; got {max_entries}")
        if max_bytes is not None and max_bytes < 0:
            raise ValueError(f"max_bytes must be >= 0; got {max_bytes}")
        self.strategy = strategy
        self.transpose_too = transpose_too
        self.max_entries = max_entries
        self.max_bytes = max_bytes
        self.max_batch = max_batch
        self.bucket_base = bucket_base
        self.background = background
        self.build_gate = build_gate
        self.device = resolve_device(device)
        self.build_kwargs = dict(build_kwargs, device=self.device)
        self._entries: "OrderedDict[str, SolverEntry]" = OrderedDict()
        self._lock = threading.Lock()
        self._threads: list = []
        self.hits = 0
        self.misses = 0
        self.promotions = 0
        self.evictions = 0
        self.build_failures = 0
        self.cold_build_hist = LatencyHistogram()
        self.planned_build_hist = LatencyHistogram()

    # -- admission ---------------------------------------------------------
    def get(self, L: CSRMatrix) -> SolverEntry:
        """Admit a factor: pattern hit → O(nnz) value refresh onto the
        resident pair (skipped when the values are bit-identical); miss →
        inline cold serial pair + background planned build.  Returns the
        (possibly brand-new) entry, marked most-recently-used."""
        key = pattern_key(L)
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                self._entries.move_to_end(key)
                entry.last_used = time.monotonic()
                self.hits += 1
        if entry is not None:
            if not np.array_equal(entry.pattern.data, L.data):
                entry.refresh(L.data)
            return entry
        return self._admit_miss(key, L)

    def lookup(self, key: str) -> Optional[SolverEntry]:
        """Fetch a resident entry by key without admission side effects
        (no refresh, no build, no hit/miss accounting; LRU order *is*
        touched — a lookup is a use)."""
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                self._entries.move_to_end(key)
                entry.last_used = time.monotonic()
            return entry

    def _admit_miss(self, key: str, L: CSRMatrix) -> SolverEntry:
        # cold pair inline — this is what answers the first request NOW;
        # the serial build is O(nnz) analysis and no schedule packing
        t0 = time.perf_counter()
        fwd, bwd = SpTRSV.build_cold(L, transpose_too=self.transpose_too,
                                     **self.build_kwargs)
        cold_s = time.perf_counter() - t0
        engine = SolveEngine(fwd, bwd, max_batch=self.max_batch,
                             bucket_base=self.bucket_base)
        entry = SolverEntry(key, L, engine, cold_build_seconds=cold_s)
        with self._lock:
            raced = self._entries.get(key)
            if raced is not None:      # another thread admitted it first
                self._entries.move_to_end(key)
                self.hits += 1
                return raced
            self._entries[key] = entry
            self.misses += 1
            self.cold_build_hist.record(cold_s)
            self._evict_to_budget(protect=key)
        if self.strategy == "serial":
            # the planned build IS the cold build — promote in place
            with entry.lock:
                entry.state = "ready"
                entry.planned_build_seconds = cold_s
            entry.ready_event.set()
            with self._lock:
                self.promotions += 1
        elif self.background:
            t = threading.Thread(target=self._build_and_promote,
                                 args=(entry,), daemon=True,
                                 name=f"solver-build-{key[:12]}")
            with self._lock:
                self._threads.append(t)
            t.start()
        else:
            self._build_and_promote(entry)
        return entry

    # -- background build + atomic promotion -------------------------------
    def _build_planned(self, L: CSRMatrix):
        """The planned (expensive) build — split out so tests can
        monkeypatch it to stall or fail deterministically."""
        if self.transpose_too:
            return SpTRSV.build_pair(L, strategy=self.strategy,
                                     **self.build_kwargs)
        return (SpTRSV.build(L, strategy=self.strategy,
                             **self.build_kwargs), None)

    def _build_and_promote(self, entry: SolverEntry) -> None:
        if self.build_gate is not None:
            self.build_gate.wait()
        with entry.lock:
            snapshot, built_version = entry.pattern, entry.version
        t0 = time.perf_counter()
        try:
            fwd, bwd = self._build_planned(snapshot)
            while True:
                # the built (or just refreshed) value buffers are complete
                # before the serving thread can read them
                _settle((fwd, bwd))
                # promotion and budget re-enforcement are one atomic unit
                # under the registry lock (lock order: registry -> entry,
                # same as admission/eviction) so an observer never reads a
                # transiently over-budget resident footprint
                with self._lock:
                    with entry.lock:
                        if entry.evicted:
                            logger.info(
                                "registry: discarding planned build for "
                                "evicted entry %s", entry.key)
                            return
                        if entry.version == built_version:
                            # atomic promotion: the engine's next drained
                            # batch runs on the planned solvers; queued
                            # requests are preserved, answers are
                            # value-identical
                            entry.engine.swap_solvers(fwd, bwd)
                            entry.cold_completed = (entry.engine.solved
                                                    + entry.engine.failed)
                            entry.state = "ready"
                            entry.planned_build_seconds = (
                                time.perf_counter() - t0)
                            self.promotions += 1
                            self.planned_build_hist.record(
                                entry.planned_build_seconds)
                            self._evict_to_budget(protect=entry.key)
                            break
                        snapshot, built_version = (entry.pattern,
                                                   entry.version)
                # values moved while we built: O(nnz) refresh of the built
                # pair OUTSIDE the locks, then re-check
                fwd.refresh(snapshot.data)
                if bwd is not None:
                    bwd.refresh(snapshot.data)
        except Exception as exc:   # noqa: BLE001 — keep serving cold
            logger.warning("registry: planned build for %s failed (%r); "
                           "entry keeps serving through the cold serial "
                           "pair", entry.key, exc)
            entry.build_error = exc
            with self._lock:
                self.build_failures += 1
            entry.ready_event.set()
            return
        entry.ready_event.set()

    # -- eviction ----------------------------------------------------------
    def resident_bytes(self) -> int:
        with self._lock:
            return sum(e.packed_bytes for e in self._entries.values())

    def _evict_to_budget(self, *, protect: str) -> None:
        """Evict LRU entries until both budgets hold.  Never evicts the
        just-touched entry (``protect``) or an entry with queued requests —
        so the resident total can exceed ``max_bytes`` only when a single
        protected/busy entry does on its own.  Caller holds ``_lock``."""
        def over():
            if (self.max_entries is not None
                    and len(self._entries) > self.max_entries):
                return True
            return (self.max_bytes is not None
                    and sum(e.packed_bytes for e in self._entries.values())
                    > self.max_bytes)

        while over():
            victim = None
            for key, e in self._entries.items():   # iteration = LRU order
                if key == protect or len(e.engine.queue):
                    continue
                victim = key
                break
            if victim is None:
                logger.warning(
                    "registry: over budget but every other entry has "
                    "queued work — deferring eviction")
                return
            e = self._entries.pop(victim)
            with e.lock:
                e.evicted = True
            self.evictions += 1
            logger.info("registry: evicted %s (%d bytes)", victim,
                        e.packed_bytes)

    # -- bookkeeping -------------------------------------------------------
    def wait_idle(self, timeout: Optional[float] = None) -> bool:
        """Join every background build thread (tests/benchmarks).  Returns
        False if any thread is still alive after ``timeout``."""
        with self._lock:
            threads = list(self._threads)
        deadline = (time.monotonic() + timeout) if timeout is not None \
            else None
        for t in threads:
            t.join(None if deadline is None
                   else max(0.0, deadline - time.monotonic()))
            if t.is_alive():
                return False
        with self._lock:
            self._threads = [t for t in self._threads if t.is_alive()]
        return True

    def keys(self) -> list:
        with self._lock:
            return list(self._entries.keys())

    def stats(self) -> dict:
        """Registry-wide counters + per-entry state, one dict for the
        dashboard: hit/miss/promotion/eviction counts, resident byte
        footprint vs budget, build-latency histograms, and each entry's
        :meth:`SolverEntry.stats`."""
        with self._lock:
            entries = {k: e for k, e in self._entries.items()}
            out = {
                "hits": self.hits,
                "misses": self.misses,
                "promotions": self.promotions,
                "evictions": self.evictions,
                "build_failures": self.build_failures,
                "entries": len(entries),
                "max_entries": self.max_entries,
                "max_bytes": self.max_bytes,
                "cold_build": self.cold_build_hist.summary(),
                "planned_build": self.planned_build_hist.summary(),
            }
        per_entry = {k: e.stats() for k, e in entries.items()}
        out["resident_packed_bytes"] = sum(
            s["packed_bytes"] for s in per_entry.values())
        out["per_entry"] = per_entry
        return out
