"""Serving-tier metrics primitives.

One class, deliberately tiny: a fixed-bucket log2 latency histogram that
both the :class:`repro_torch.serve.SolverRegistry` (cold/planned build times) and
the :class:`repro_torch.serve.SolveService` (per-batch solve times) record into.
Dashboards read :meth:`LatencyHistogram.summary` out of ``stats()`` — no
external metrics dependency, no unbounded sample retention.
"""
from __future__ import annotations

import math

__all__ = ["LatencyHistogram"]


class LatencyHistogram:
    """Log2-bucketed latency histogram over seconds.

    Buckets span ``[2^lo_exp, 2^hi_exp)`` seconds (defaults cover 1 µs to
    ~65 s); samples outside the range clamp into the edge buckets.  O(1)
    record, O(buckets) summary, exact count/sum/min/max on the side so the
    mean is not quantized.
    """

    def __init__(self, *, lo_exp: int = -20, hi_exp: int = 6):
        if hi_exp <= lo_exp:
            raise ValueError(
                f"hi_exp must exceed lo_exp; got [{lo_exp}, {hi_exp}]")
        self.lo_exp = lo_exp
        self.hi_exp = hi_exp
        self.counts = [0] * (hi_exp - lo_exp)
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = 0.0

    def record(self, seconds: float) -> None:
        s = float(seconds)
        if not (s >= 0.0) or math.isinf(s):   # rejects NaN too
            raise ValueError(f"latency must be finite and >= 0; got {s}")
        self.count += 1
        self.total += s
        self.min = min(self.min, s)
        self.max = max(self.max, s)
        e = math.frexp(s)[1] - 1 if s > 0.0 else self.lo_exp
        idx = min(max(e - self.lo_exp, 0), len(self.counts) - 1)
        self.counts[idx] += 1

    def quantile(self, q: float) -> float:
        """Upper bucket edge containing the q-quantile (0 when empty) —
        a conservative (pessimistic) latency estimate, which is the right
        bias for an SLO check."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1]; got {q}")
        if self.count == 0:
            return 0.0
        rank = q * self.count
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= rank and c:
                return min(2.0 ** (self.lo_exp + i + 1), self.max)
        return self.max

    def summary(self) -> dict:
        """JSON-able digest: count / mean / min / max / p50 / p95 / p99."""
        return {
            "count": self.count,
            "mean_s": self.total / self.count if self.count else 0.0,
            "min_s": self.min if self.count else 0.0,
            "max_s": self.max,
            "p50_s": self.quantile(0.50),
            "p95_s": self.quantile(0.95),
            "p99_s": self.quantile(0.99),
        }
