"""Serving tier: single-factor micro-batching engines plus the
multi-tenant solve service (the JAX package's ``serve``).

* :mod:`repro_torch.serve.engine` — :class:`SolveEngine`, the per-factor
  worker (power-of-base bucketed multi-RHS batching, per-request failure
  isolation, atomic solver promotion) and the LLM :class:`ServeEngine`;
* :mod:`repro_torch.serve.registry` — :class:`SolverRegistry`, the LRU of
  built solver pairs keyed by sparsity-pattern hash (+ dtype) with
  byte-budget eviction, cold serial pairs, and background planned builds;
* :mod:`repro_torch.serve.service` — :class:`SolveService`, the
  multi-tenant continuous-batching front-end composing the two;
* :mod:`repro_torch.serve.metrics` — :class:`LatencyHistogram`.
"""
from .engine import ServeEngine, Request, SolveEngine, SolveRequest
from .metrics import LatencyHistogram
from .registry import SolverEntry, SolverRegistry, pattern_key
from .service import SolveService, TenantState

__all__ = [
    "ServeEngine",
    "Request",
    "SolveEngine",
    "SolveRequest",
    "LatencyHistogram",
    "SolverEntry",
    "SolverRegistry",
    "pattern_key",
    "SolveService",
    "TenantState",
]
