"""Shared benchmark helpers of the port: time measurement + CSV/JSON
emission (the port's copy of the JAX package's ``benchmarks/common.py``).

The JSON side writes the repo's **shared perf-trajectory schema**: every
``BENCH_*.json`` artifact is ``{"schema": [...], "records": [...]}`` where
each record carries ``name`` (dotted metric group), ``backend`` (the
device type the run executed on: ``"cuda"`` or ``"cpu"``), ``n`` /
``nnz`` (problem size), ``metric`` (leaf key) and ``value`` — so
trajectories diff across benchmarks and across the two packages without
per-script parsers.

A bench keeps measuring apart from judging: its ``measure`` returns the
results, its ``gates`` turns them into :class:`Gate` records (the
reference bench's ``--smoke`` assertions, each with its kind), and
:func:`hold` raises on the first one not met, with the reference's
message, as the reference's ``--smoke`` run does.  Results keys that
start with ``_`` feed the gates only and stay out of the JSON
(:func:`public`).
"""
from __future__ import annotations

import dataclasses
import json
import numbers
import time

import numpy as np
import torch

__all__ = ["ROWS", "BENCH_SCHEMA", "LONG_CALL_S", "GATE_KINDS", "Gate",
           "timeit", "emit", "flush_csv", "to_records", "write_bench_json",
           "hold", "print_gates", "public", "ready"]

ROWS = []

BENCH_SCHEMA = ("name", "backend", "n", "nnz", "metric", "value")

# a call at least this long is timed once, after one warm-up
LONG_CALL_S = 0.2


# "answer": a solve's error or finiteness; "structural": a count, plan or
# residual that does not depend on the host's speed; "plan": a decision of
# the auto planner, which reads the device's calibration row; "speed": a
# ratio of times (the references set their thresholds on a CPU host)
GATE_KINDS = ("answer", "structural", "plan", "speed")


@dataclasses.dataclass(frozen=True)
class Gate:
    """One ``--smoke`` assertion of a reference bench: ``value`` beside
    ``threshold`` (as the reference states it), whether it is ``met``,
    its kind (:data:`GATE_KINDS`) and the reference's failure message."""

    name: str
    kind: str
    met: bool
    value: object
    threshold: str
    message: str = ""

    def __post_init__(self):
        if self.kind not in GATE_KINDS:
            raise ValueError(f"gate kind {self.kind!r} not in {GATE_KINDS}")


def hold(gates, kinds=GATE_KINDS) -> None:
    """Raise ``AssertionError`` with the reference's message on the first
    gate of ``kinds`` that is not met."""
    for g in gates:
        if g.kind in kinds and not g.met:
            raise AssertionError(g.message or f"{g.name}: {g.value!r} "
                                 f"(needs {g.threshold})")


def print_gates(prefix: str, gates) -> None:
    for g in gates:
        print(f"  [gate] {prefix}.{g.name} ({g.kind}): {g.value!r} vs "
              f"{g.threshold}: {'met' if g.met else 'NOT MET'}")


def public(results: dict) -> dict:
    """``results`` without the keys that start with ``_`` (gate inputs the
    reference bench does not write)."""
    return {k: v for k, v in results.items() if not str(k).startswith("_")}


def ready(x: torch.Tensor) -> torch.Tensor:
    """``x`` once the card has computed it (the port's
    ``block_until_ready``): synchronises on a CUDA tensor."""
    if x.is_cuda:
        torch.cuda.synchronize(x.device)
    return x


def timeit(fn, *args, iters: int = 10, warmup: int = 3) -> float:
    """Median seconds per call of ``fn(*args)`` after warm-up.  On the card
    (the device of the first tensor argument) each call is timed between
    CUDA events (host launch gaps included, as a caller waits) and
    synchronised; otherwise with the host clock.  A call that takes at
    least :data:`LONG_CALL_S` is timed once, after one warm-up; with
    ``warmup=0`` the first call is timed (for a call with nothing to
    compile or load)."""
    dev = next((a.device for a in args if torch.is_tensor(a)),
               torch.device("cpu"))
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)

        def once() -> float:
            start.record()
            fn(*args)
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3
    else:
        def once() -> float:
            t0 = time.perf_counter()
            fn(*args)
            return time.perf_counter() - t0

    if warmup:
        fn(*args)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    first = once()
    if first >= LONG_CALL_S:
        return first
    for _ in range(warmup - 1):
        fn(*args)
    return float(np.median([once() for _ in range(iters)]))


def emit(name: str, value, unit: str = "", **extra):
    ROWS.append({"name": name, "value": value, "unit": unit, **extra})
    ex = " ".join(f"{k}={v}" for k, v in extra.items())
    print(f"  {name:<44s} {value:>14} {unit:<10s} {ex}")


def flush_csv(path: str):
    import csv
    import os
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    keys = sorted({k for r in ROWS for k in r})
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=keys)
        w.writeheader()
        w.writerows(ROWS)


def _scalar(v):
    """JSON-able scalar or None (numpy scalars coerced; arrays rejected)."""
    if isinstance(v, (bool, str)) or v is None:
        return v
    if isinstance(v, numbers.Integral):
        return int(v)
    if isinstance(v, numbers.Real):
        return float(v)
    return None


def to_records(prefix: str, results, *, backend=None, n=None, nnz=None):
    """Flatten a nested result dict into shared-schema records: the dotted
    path is split as name (all but the leaf) + metric (the leaf); non-scalar
    leaves (schedules, arrays) are skipped.  ``backend`` defaults to the
    device type a run would use: ``"cuda"`` where a card is visible, else
    ``"cpu"``."""
    if backend is None:
        backend = "cuda" if torch.cuda.is_available() else "cpu"
    recs = []

    def walk(name, v):
        if isinstance(v, dict):
            for k, w in v.items():
                walk(f"{name}.{k}" if name else str(k), w)
            return
        sv = _scalar(v)
        if sv is None and v is not None:
            return
        head, _, metric = name.rpartition(".")
        recs.append({"name": f"{prefix}.{head}" if head else prefix,
                     "backend": backend, "n": n, "nnz": nnz,
                     "metric": metric or name, "value": sv})

    walk("", results)
    return recs


def write_bench_json(path: str, prefix: str, results, *,
                     backend=None, n=None, nnz=None):
    """Write a shared-schema ``BENCH_*.json`` perf-trajectory artifact."""
    payload = {
        "schema": list(BENCH_SCHEMA),
        "records": to_records(prefix, results, backend=backend, n=n, nnz=nnz),
    }
    with open(path, "w") as f:
        json.dump(payload, f, indent=2)
        f.write("\n")
    print(f"  wrote {path} ({len(payload['records'])} records)")
