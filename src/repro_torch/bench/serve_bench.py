"""Multi-tenant solve-service load generator: registry economics + SLOs
(the port's mirror of the JAX package's ``benchmarks/serve_bench.py``).

Three claims the serving tier makes, priced and asserted here:

* **Warm path** — a pattern-hit numeric refresh onto the resident pair is
  >= 10x faster than standing the planned solver up cold (the paper's
  analysis-amortization argument at fleet scale: the registry turns
  streams of same-pattern refactorizations into O(nnz) re-packs);
* **Cold path** — a request for a never-seen pattern is answered by the
  inline serial pair *before* the background planned build completes
  (deterministically pinned with the registry's ``build_gate`` hook), and
  the promoted pair then returns value-identical answers;
* **Residency** — under mixed cold/warm multi-tenant traffic
  (:func:`repro_torch.sparse.serve_traffic`) the registry's resident
  packed bytes never exceed the configured budget, while every request
  completes.

``--smoke`` asserts all three (CI gate).  ``--json PATH`` writes the
shared-schema perf-trajectory artifact (``backend`` = the device type).
``run()`` also returns, under ``results["mixed"]["requests"]``, every
solve request of the mixed traffic with the factor in effect when it was
submitted, so a caller can check answers against an oracle.

Usage::

    python -m repro_torch.bench.serve_bench                    # on the card
    python -m repro_torch.bench.serve_bench --smoke --device cpu \\
        --json BENCH_serve.json
"""
from __future__ import annotations

import argparse
import threading
import time

import numpy as np

from ..core import CSRMatrix, SpTRSV
from ..kernels.backend import resolve_device
from ..serve import SolverRegistry, SolveService
from ..sparse import lung2_like, refresh_values, serve_traffic
from .common import emit, flush_csv, write_bench_json

__all__ = ["run", "MIN_WARM_SPEEDUP", "MAX_P95_SOLVE_S"]

MIN_WARM_SPEEDUP = 10.0
# generous SLO for shared CI runners: p95 of a drained batch on the small
# mixed-traffic factors; a real deployment would calibrate this per host
MAX_P95_SOLVE_S = 2.0
# bound on every wait for a background build
WAIT_S = 600


def run(*, smoke: bool = False, json_path: str = "", device="cuda"):
    dev = resolve_device(device)
    print(f"== serve: registry + continuous batching under mixed traffic "
          f"({dev.type}) ==")
    if smoke:
        L = lung2_like(scale=0.02, fat_levels=12, thin_run=24,
                       dtype=np.float64)
        traffic_kwargs = dict(num_patterns=3, num_tenants=4,
                              num_events=120, n=192)
    else:
        L = lung2_like(scale=0.3, dtype=np.float64)
        traffic_kwargs = dict(num_patterns=4, num_tenants=8,
                              num_events=600, n=512)
    emit("serve.rows", L.n)
    emit("serve.nnz", L.nnz)
    results: dict = {"rows": L.n, "nnz": L.nnz}
    rng = np.random.default_rng(0)
    b = rng.standard_normal(L.n)

    # -- warm-vs-cold economics on one lung2-class pattern ----------------
    # The planned build is what a miss costs without the registry; the
    # refresh is what a pattern hit costs with it.
    strategy = "levelset"
    t0 = time.perf_counter()
    reg = SolverRegistry(strategy=strategy, background=False, max_batch=8,
                         device=dev)
    entry = reg.get(L)
    reg.wait_idle(timeout=WAIT_S)
    cold_total_s = time.perf_counter() - t0
    planned_s = entry.planned_build_seconds
    serial_s = entry.cold_build_seconds
    req_cold = entry.engine.submit(b)
    entry.engine.run()

    t0 = time.perf_counter()
    entry2 = reg.get(CSRMatrix(L.indptr, L.indices,
                               refresh_values(L, seed=11), L.shape))
    warm_s = time.perf_counter() - t0
    assert entry2 is entry and reg.hits == 1
    warm_speedup = cold_total_s / warm_s
    emit("serve.cold.serial_build_s", f"{serial_s:.3e}", "s")
    emit("serve.cold.planned_build_s", f"{planned_s:.3e}", "s")
    emit("serve.cold.total_admission_s", f"{cold_total_s:.3e}", "s")
    emit("serve.warm.refresh_s", f"{warm_s:.3e}", "s")
    emit("serve.warm.speedup_vs_cold", round(warm_speedup, 1), "x")
    results["warm"] = dict(
        serial_build_s=serial_s, planned_build_s=planned_s,
        cold_admission_s=cold_total_s, refresh_s=warm_s,
        speedup=warm_speedup)

    # -- cold path answers before the background build lands --------------
    # The gate holds the planned build so "answered while cold" is a
    # pinned fact, not a race; releasing it then proves promotion and
    # value-identical answers on the same RHS.
    gate = threading.Event()
    reg2 = SolverRegistry(strategy=strategy, background=True,
                          build_gate=gate, max_batch=8, device=dev)
    t0 = time.perf_counter()
    e2 = reg2.get(L)
    req = e2.engine.submit(b)
    e2.engine.run()
    first_answer_s = time.perf_counter() - t0
    cold_served = req.done and e2.state == "cold"
    gate.set()
    promoted = e2.wait_ready(timeout=WAIT_S) and e2.state == "ready"
    req_warm = e2.engine.submit(b)
    e2.engine.run()
    answers_match = bool(np.allclose(req.x, req_warm.x,
                                     rtol=1e-10, atol=1e-10))
    reg2.wait_idle(timeout=WAIT_S)
    emit("serve.cold.first_answer_s", f"{first_answer_s:.3e}", "s")
    emit("serve.cold.served_while_cold", cold_served)
    emit("serve.cold.promoted", promoted)
    emit("serve.cold.promoted_strategy", e2.engine.solver.strategy)
    emit("serve.cold.answers_match", answers_match)
    results["cold"] = dict(
        first_answer_s=first_answer_s, served_while_cold=cold_served,
        promoted=promoted, answers_match=answers_match)
    del reg, entry, entry2, reg2, e2

    # -- mixed multi-tenant traffic under a byte budget --------------------
    probe = SpTRSV.build(
        serve_traffic(**{**traffic_kwargs, "num_tenants": 1,
                         "num_events": 0})[0][0],
        strategy=strategy, device=dev)
    entry_bytes = probe.stats()["packed_bytes"] * 2  # fwd + bwd pair
    budget = int(entry_bytes * 2.5)  # holds ~2 of the patterns
    svc = SolveService(strategy=strategy, max_bytes=budget,
                       background=True, max_batch=16, device=dev)
    patterns, events = serve_traffic(seed=7, **traffic_kwargs)
    keys: dict = {}
    requests = []          # (request, factor in effect at submission)
    peak = 0
    t0 = time.perf_counter()
    for ev in events:
        if ev["op"] == "register":
            keys[ev["tenant"]] = svc.register(ev["tenant"], ev["matrix"])
        elif ev["op"] == "refresh":
            svc.refresh(ev["tenant"], ev["values"])
        else:
            r = svc.submit(ev["tenant"], ev["b"], transpose=ev["transpose"])
            requests.append((r, svc.registry.lookup(keys[ev["tenant"]]).pattern))
        svc.step()
        peak = max(peak, svc.registry.resident_bytes())
    svc.run()
    idle = svc.registry.wait_idle(timeout=WAIT_S)
    peak = max(peak, svc.registry.resident_bytes())
    wall = time.perf_counter() - t0
    st = svc.stats()
    rs = st["registry"]
    throughput = st["completed"] / wall if wall else 0.0
    emit("serve.mixed.events", len(events))
    emit("serve.mixed.completed", st["completed"])
    emit("serve.mixed.failed", st["failed"])
    emit("serve.mixed.hits", rs["hits"])
    emit("serve.mixed.misses", rs["misses"])
    emit("serve.mixed.promotions", rs["promotions"])
    emit("serve.mixed.evictions", rs["evictions"])
    emit("serve.mixed.budget_bytes", budget)
    emit("serve.mixed.peak_resident_bytes", peak)
    emit("serve.mixed.throughput_rps", round(throughput, 1), "req/s")
    emit("serve.mixed.p50_solve_s",
         f"{st['solve_latency']['p50_s']:.3e}", "s")
    emit("serve.mixed.p95_solve_s",
         f"{st['solve_latency']['p95_s']:.3e}", "s")
    results["mixed"] = dict(
        events=len(events), solves=len(requests), completed=st["completed"],
        failed=st["failed"], queue_depth=st["queue_depth"], idle=idle,
        hits=rs["hits"], misses=rs["misses"],
        promotions=rs["promotions"], evictions=rs["evictions"],
        budget_bytes=budget, peak_resident_bytes=peak,
        throughput_rps=throughput,
        p50_solve_s=st["solve_latency"]["p50_s"],
        p95_solve_s=st["solve_latency"]["p95_s"],
        requests=requests)

    if smoke:
        # warm (pattern-hit refresh) >= 10x a cold admission, cold requests
        # answered by the serial pair before the background build
        # completes (and promotion is value-identical), and the registry
        # never exceeds its byte budget under mixed traffic that forces
        # eviction.
        assert req_cold.done and req_cold.error is None
        assert warm_speedup >= MIN_WARM_SPEEDUP, (
            f"warm refresh only {warm_speedup:.1f}x faster than cold "
            f"admission (need >= {MIN_WARM_SPEEDUP}x)")
        assert cold_served, "cold request not answered while build held"
        assert promoted, "planned build never promoted"
        assert answers_match, "promoted pair changed the answers"
        assert st["failed"] == 0, st["per_tenant"]
        assert st["queue_depth"] == 0
        assert rs["evictions"] >= 1, (
            "traffic never exercised the byte budget — raise "
            "num_patterns or lower the budget")
        assert peak <= budget, (
            f"resident packed bytes peaked at {peak} > budget {budget}")
        assert st["solve_latency"]["p95_s"] <= MAX_P95_SOLVE_S, (
            f"p95 batch solve {st['solve_latency']['p95_s']:.3f}s > "
            f"SLO {MAX_P95_SOLVE_S}s")
        print(f"  smoke assertions passed (warm {warm_speedup:.0f}x >= "
              f"{MIN_WARM_SPEEDUP}x, cold served while building, "
              f"peak {peak} <= budget {budget} with "
              f"{rs['evictions']} eviction(s))")

    if json_path:
        write_bench_json(json_path, "serve", results, backend=dev.type,
                         n=results["rows"], nnz=results["nnz"])
    return results


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="small matrices + acceptance assertions (CI)")
    ap.add_argument("--json", default="", help="write results JSON here")
    ap.add_argument("--csv", default="")
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args()
    run(smoke=args.smoke, json_path=args.json, device=args.device)
    if args.csv:
        flush_csv(args.csv)
