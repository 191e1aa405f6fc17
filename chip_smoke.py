#!/usr/bin/env python3
"""Build and drive the PyTorch/CUDA port of SpTRSV (``src/repro_torch``) on
one NVIDIA GPU, at the size of the paper's lung2 (``lung2_like(scale=1.0)``:
110,258 rows, 493 levels).

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit and no result line):

1. print the card's name and power limit; build the CUDA kernels from
   ``src/repro_torch/kernels/csrc`` with nvcc (timed);
2. hold each of the four kernels against its plain torch version on the
   same CUDA tensors at the main path's shapes (f32/f64, m in {1, 32});
3. the main path: ``SpTRSV.build_pair`` for ``pallas_level``,
   ``pallas_level`` + coarsening and ``pallas_fused`` in f32 and f64, one RHS
   and a batch of 32, forward and transpose; componentwise residuals
   against the factor, agreement with the plain torch ``levelset``
   executor, a small case against a dense solve, then ``refresh`` and solve
   again.  Launch counts are zeroed just before and read just after; every
   kernel must have launched;
4. CUDA-event times per solve and per kernel (median and range of three
   batches; a solve slower than the batch budget is timed once), beside
   each kernel's bound and its launches per solve.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Exits non-zero without a result when no
GPU is visible or the port's sources are missing.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# max |kernel - plain| / max |plain| on the same inputs: nvcc contracts the
# multiply-subtract to FMA, so the two may differ by rounding.
KERNEL_TOL = {"float64": 1e-12, "float32": 1e-5}
# componentwise backward error max |b - A x| / (|A| |x| + |b|) of a solve
RESIDUAL_TOL = {"float64": 1e-12, "float32": 1e-5}
# H100 SXM data sheet: HBM rate; vector (non-tensor-core) FP rates
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}
WIDTHS = (1, 32)

KERNELS = {
    "sptrsv_level": ("src/repro_torch/kernels/csrc/sptrsv_level.cu",
                     "src/repro/kernels/sptrsv_level/lowering_tpu.py:72"),
    "sptrsv_level_batched": ("src/repro_torch/kernels/csrc/sptrsv_level.cu",
                             "src/repro/kernels/sptrsv_level/lowering_tpu.py:110"),
    "sptrsv_fused": ("src/repro_torch/kernels/csrc/sptrsv_fused.cu",
                     "src/repro/kernels/sptrsv_fused/lowering_tpu.py:76"),
    "sptrsv_fused_batched": ("src/repro_torch/kernels/csrc/sptrsv_fused.cu",
                             "src/repro/kernels/sptrsv_fused/lowering_tpu.py:137"),
}


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, *, warm: bool = True, budget_ms: float = 200.0,
            max_reps: int = 20, samples: int = 3) -> tuple[float, float, float]:
    """``(median, min, max)`` ms per call over ``samples`` batches of repeated
    calls between CUDA events (host launch gaps included — what a caller of
    the solve waits).  A first timed call, after an untimed warm-up unless
    ``warm`` is false (the caller has already run ``fn``), sizes each batch
    to about ``budget_ms``; a call that alone exceeds the budget is timed
    once."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)

    def batch(reps: int) -> float:
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    if warm:
        fn()
    torch.cuda.synchronize()
    first = batch(1)
    if first >= budget_ms:
        return first, first, first
    reps = int(max(1, min(max_reps, budget_ms // max(first, 1e-3))))
    per = sorted(batch(reps) for _ in range(samples))
    return per[len(per) // 2], per[0], per[-1]


def fmt_ms(t: tuple[float, float, float]) -> str:
    return f"{t[0]:.4f} ms [{t[1]:.4f}-{t[2]:.4f}]"


def device_busy(torch, fn, reps: int = 5) -> str:
    """Device kernel time per call over host wall time per call, read from
    a ``torch.profiler`` trace of ``reps`` calls ("not measured" when the
    profiler records no device activity)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / reps
        kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    except (RuntimeError, AttributeError) as err:
        return f"not measured (profiler: {err})"
    if not kernels:
        return "not measured (profiler recorded no device time)"
    dev_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / reps
    return (f"device {dev_ms:.4f} ms of {wall_ms:.4f} ms wall per call under "
            f"the profiler ({100 * dev_ms / wall_ms:.1f}% busy, "
            f"{len(kernels) // reps} device ops per call)")


def rel_err(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))


def residual(A, x: np.ndarray, b: np.ndarray) -> float:
    """Componentwise backward error of ``A x = b`` (scipy CSR ``A``)."""
    r = np.abs(b - A @ x)
    scale = abs(A) @ np.abs(x) + np.abs(b)
    return float((r / np.maximum(scale, 1e-300)).max())


def solve_bound_ms(L, m: int, dtype: str) -> tuple[float, str]:
    """Least time for one solve of ``m`` RHS: each input read once, each
    output written once (off-diagonal int32 index + value, diagonal and b
    read, x written; the gathers of x hit the L2), against the FLOPs
    (mul+sub per off-diagonal, one divide per row)."""
    s = 8 if dtype == "float64" else 4
    off = L.nnz - L.n
    nbytes = off * (4 + s) + L.n * s + 2 * L.n * m * s
    flops = m * (2 * off + L.n)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible (torch.cuda.is_available() "
              "is False)", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: {ROOT / 'src' / 'repro_torch'} is missing; run "
              "from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import scipy.sparse as sp

    from repro_torch.core import SpTRSV
    from repro_torch.core.coarsen import coarsen_schedule
    from repro_torch.core.packed import permute_rhs, segment_steps
    from repro_torch.kernels import build
    from repro_torch.kernels.sptrsv_fused import cuda as fused_cuda
    from repro_torch.kernels.sptrsv_fused.ops import build_layout
    from repro_torch.kernels.sptrsv_fused.ref import fused_solve_ref
    from repro_torch.kernels.sptrsv_level import cuda as level_cuda
    from repro_torch.kernels.sptrsv_level.ops import make_packed_solver
    from repro_torch.kernels.sptrsv_level.ref import level_walk_ref
    from repro_torch.sparse import lung2_like, refresh_values

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}")

    # -- phase 1: build -------------------------------------------------
    t0 = time.perf_counter()
    paths = build.build_all()
    print(f"phase 1: built {len(paths)} kernel libraries in "
          f"{time.perf_counter() - t0:.1f} s")
    for name, path in paths.items():
        log = path.with_suffix(".log")
        for line in (log.read_text().splitlines() if log.exists() else []):
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

    t0 = time.perf_counter()
    L64 = lung2_like(scale=1.0, seed=0)
    mats = {"float64": L64, "float32": L64.astype(np.float32)}
    print(f"lung2_like(scale=1.0): n={L64.n} nnz={L64.nnz} "
          f"(generated in {time.perf_counter() - t0:.1f} s)")

    # Solvers of the main path, built once: (strategy, coarsen) x dtype.
    t0 = time.perf_counter()
    variants = {"pallas_level": dict(strategy="pallas_level"),
                "pallas_level+coarsen": dict(strategy="pallas_level", coarsen=True),
                "pallas_fused": dict(strategy="pallas_fused"),
                "levelset": dict(strategy="levelset")}
    solvers = {}
    for dt, L in mats.items():
        for tag, kw in variants.items():
            solvers[tag, dt] = SpTRSV.build_pair(L, device="cuda", **kw)
    fwd = solvers["pallas_level", "float64"][0]
    for s in solvers["pallas_level", "float64"]:
        ks = [sl.K for sl in s.schedule.slabs]
        print(f"transpose={int(s.transpose)}: ELL width K max {max(ks)}, "
              f"levels with K > 64: {sum(k > 64 for k in ks)}, padded FLOPs "
              f"{s.schedule.padded_flops()}; fused n_pad "
              f"{solvers['pallas_fused', 'float64'][int(s.transpose)].stats()['n_pad']}")
    print(f"built {len(solvers)} solver pairs in {time.perf_counter() - t0:.1f} s; "
          f"levels={fwd.analysis.num_levels} segments: "
          + ", ".join(f"{t}={solvers[t, 'float64'][0].stats()['segments']}"
                      for t in variants))

    # -- phase 2: each kernel against its plain version -------------------
    rng = np.random.default_rng(0)
    kernel_err = {}
    sched64 = fwd.schedule
    for dt, L in mats.items():
        tdt = getattr(torch, dt)
        sched = solvers["pallas_level", dt][0].schedule
        co_sched = coarsen_schedule(sched)
        _, vals0, _, lay = make_packed_solver(co_sched, device="cuda")
        cols = torch.from_numpy(lay.cols_flat).to(dev)
        steps = segment_steps(lay)
        plain = [s for s in lay.segments if s.kind == "plain"]
        fat = max(plain, key=lambda s: s.R)
        chain = next(s for s in lay.segments if s.kind == "chain")
        pick = {(fat.off, fat.K, fat.R_pad)} | {
            (int(o), chain.K, chain.R_pad) for o in chain.sub_offs}
        sub = np.ascontiguousarray(
            [r for r in steps if (int(r[0]), int(r[1]), int(r[2])) in pick])
        check(len(sub) == 1 + chain.depth, "fat/chain step selection")
        n_x = -(-lay.n_pad // 128) * 128
        for m in WIDTHS:
            shape = (n_x,) if m == 1 else (n_x, m)
            x0 = torch.from_numpy(rng.standard_normal(shape)).to(dev, tdt)
            bhat = torch.from_numpy(rng.standard_normal(shape)).to(dev, tdt)
            xk, xr = x0.clone(), x0.clone()
            level_cuda.level_walk(xk, bhat, cols, vals0[0], vals0[1], sub)
            level_walk_ref(xr, bhat, cols, vals0[0], vals0[1], sub)
            torch.cuda.synchronize()
            name = "sptrsv_level" if m == 1 else "sptrsv_level_batched"
            err = rel_err(xk, xr)
            check(torch.isfinite(xk).all().item(), f"{name} {dt}: non-finite")
            check(err <= KERNEL_TOL[dt], f"{name} {dt} m={m}: rel err {err:.3e}")
            kernel_err[name, dt] = float((xk - xr).abs().max())
            print(f"phase 2: {name:22s} {dt} m={m:2d} fat level R={fat.R} "
                  f"+ chain depth {chain.depth}: max rel err {err:.3e} "
                  f"(tol {KERNEL_TOL[dt]:g})")

        flay = build_layout(sched)
        fcols = torch.from_numpy(flay.cols).to(dev)
        fvals = torch.from_numpy(flay.vals).to(dev)
        fdiag = torch.from_numpy(flay.diag).to(dev)
        spans = torch.tensor(flay.spans, dtype=torch.int32, device=dev)
        for m in WIDTHS:
            shape = (flay.n_pad,) if m == 1 else (flay.n_pad, m)
            bl = torch.from_numpy(rng.standard_normal(shape)).to(dev, tdt)
            xk = fused_cuda.fused_solve(bl, fcols, fvals, fdiag, spans)
            xr = fused_solve_ref(bl, fcols, fvals, fdiag, chunk=flay.chunk)
            torch.cuda.synchronize()
            name = "sptrsv_fused" if m == 1 else "sptrsv_fused_batched"
            err = rel_err(xk, xr)
            check(torch.isfinite(xk).all().item(), f"{name} {dt}: non-finite")
            check(err <= KERNEL_TOL[dt], f"{name} {dt} m={m}: rel err {err:.3e}")
            kernel_err[name, dt] = float((xk - xr).abs().max())
            print(f"phase 2: {name:22s} {dt} m={m:2d} whole layout "
                  f"n_pad={flay.n_pad} spans={len(flay.spans)}: max rel err "
                  f"{err:.3e} (tol {KERNEL_TOL[dt]:g})")

    # -- phase 3: the main path -------------------------------------------
    small = lung2_like(scale=0.02, fat_levels=4, seed=3)
    dense = small.to_dense()
    bs = rng.standard_normal((small.n, 3))
    for tag in ("pallas_level", "pallas_level+coarsen", "pallas_fused"):
        f, b_ = SpTRSV.build_pair(small, device="cuda", **variants[tag])
        for s, A in ((f, dense), (b_, dense.T)):
            x = s.solve(torch.from_numpy(bs).to(dev)).cpu().numpy()
            err = float(np.abs(x - np.linalg.solve(A, bs)).max())
            check(err <= 1e-11, f"small {tag} transpose={s.transpose}: {err:.3e}")
    print("phase 3: small lung2_like(n=%d) matches a dense solve for all "
          "kernel strategies, both directions" % small.n)

    level_cuda.reset_launches()
    fused_cuda.reset_launches()
    t0 = time.perf_counter()
    for dt, L in mats.items():
        tdt = getattr(torch, dt)
        A = {False: sp.csr_matrix((L.data, L.indices, L.indptr), shape=L.shape)}
        A[True] = A[False].T.tocsr()
        new = refresh_values(L, seed=1)
        A2 = {False: sp.csr_matrix((new, L.indices, L.indptr), shape=L.shape)}
        A2[True] = A2[False].T.tocsr()
        for m in WIDTHS:
            b_np = rng.standard_normal((L.n,) if m == 1 else (L.n, m)).astype(dt)
            b = torch.from_numpy(b_np).to(dev)
            base = {s.transpose: s.solve(b) for s in solvers["levelset", dt]}
            for tag in ("pallas_level", "pallas_level+coarsen", "pallas_fused"):
                for s in solvers[tag, dt]:
                    x = s.solve(b)
                    torch.cuda.synchronize()
                    xn = x.double().cpu().numpy()
                    check(x.shape == b.shape and np.isfinite(xn).all(),
                          f"{tag} {dt} m={m}: bad output")
                    res = residual(A[s.transpose], xn, b_np.astype(np.float64))
                    agree = rel_err(x, base[s.transpose])
                    check(res <= RESIDUAL_TOL[dt],
                          f"{tag} {dt} m={m} T={s.transpose}: residual {res:.3e}")
                    check(agree <= KERNEL_TOL[dt],
                          f"{tag} {dt} m={m} T={s.transpose}: vs levelset {agree:.3e}")
                    print(f"phase 3: {tag:21s} {dt} m={m:2d} transpose="
                          f"{int(s.transpose)} residual {res:.2e} "
                          f"vs levelset {agree:.2e}")
        # refresh in place, then solve again against the new values
        b_np = rng.standard_normal((L.n, WIDTHS[-1])).astype(dt)
        b = torch.from_numpy(b_np).to(dev)
        for tag in ("pallas_level", "pallas_level+coarsen", "pallas_fused"):
            for s in solvers[tag, dt]:
                ptrs = [v.data_ptr() for v in s._values]
                s.refresh(new)
                check(ptrs == [v.data_ptr() for v in s._values],
                      f"{tag}: refresh moved a value buffer")
                xn = s.solve(b).double().cpu().numpy()
                res = residual(A2[s.transpose], xn, b_np.astype(np.float64))
                check(res <= RESIDUAL_TOL[dt],
                      f"refresh {tag} {dt} T={s.transpose}: residual {res:.3e}")
                print(f"phase 3: refresh {tag:21s} {dt} transpose="
                      f"{int(s.transpose)} residual {res:.2e}")
                s.refresh(L.data)
    torch.cuda.synchronize()
    main_launches = {**level_cuda.launches, **fused_cuda.launches}
    print(f"phase 3: main path in {time.perf_counter() - t0:.1f} s; launches "
          f"{json.dumps(main_launches)}")
    for name in KERNELS:
        check(main_launches[name] > 0, f"{name} never launched on the main path")

    # launches of each kernel in one forward f64 solve, per strategy
    per_solve = {name: {} for name in KERNELS}
    for m in WIDTHS:
        bm = torch.from_numpy(rng.standard_normal(
            (L64.n,) if m == 1 else (L64.n, m))).to(dev)
        for tag in ("pallas_level", "pallas_level+coarsen", "pallas_fused"):
            level_cuda.reset_launches()
            fused_cuda.reset_launches()
            solvers[tag, "float64"][0].solve(bm)
            for name, n in {**level_cuda.launches, **fused_cuda.launches}.items():
                if n:
                    per_solve[name][tag] = n
    print(f"launches per solve: {json.dumps(per_solve)}")

    # -- phase 4: times -----------------------------------------------------
    for dt in mats:
        for m in WIDTHS:
            b = torch.from_numpy(rng.standard_normal(
                (L64.n,) if m == 1 else (L64.n, m))).to(dev, getattr(torch, dt))
            for tag in variants:
                for s in solvers[tag, dt]:
                    # phase 3 ran every one of these solves already
                    ms = time_ms(torch, lambda: s.solve(b), warm=False)
                    print(f"phase 4: solve {tag:21s} {dt} m={m:2d} transpose="
                          f"{int(s.transpose)}: {fmt_ms(ms)}")

    b1 = torch.from_numpy(rng.standard_normal(L64.n)).to(dev)
    for tag in ("pallas_level", "pallas_fused", "levelset"):
        s = solvers[tag, "float64"][0]
        print(f"phase 4: profile {tag} f64 m=1 forward: "
              + device_busy(torch, lambda: s.solve(b1)))

    dt, L, tdt = "float64", L64, torch.float64
    _, vals0, _, lay = make_packed_solver(sched64, device="cuda")
    steps = segment_steps(lay)
    cols = torch.from_numpy(lay.cols_flat).to(dev)
    perm = torch.from_numpy(lay.perm).to(dev)
    n_x = -(-lay.n_pad // 128) * 128
    flay = build_layout(sched64)
    fcols = torch.from_numpy(flay.cols).to(dev)
    fvals = torch.from_numpy(flay.vals).to(dev)
    fdiag = torch.from_numpy(flay.diag).to(dev)
    spans = torch.tensor(flay.spans, dtype=torch.int32, device=dev)
    perm_rows = torch.from_numpy(flay.perm_rows.astype(np.int64)).to(dev)
    A_csr = torch.sparse_csr_tensor(
        torch.from_numpy(L.indptr), torch.from_numpy(L.indices),
        torch.from_numpy(L.data), size=L.shape, device=dev)
    report = []
    for m in WIDTHS:
        b = torch.from_numpy(rng.standard_normal((L.n, m))).to(dev)
        bv = b[:, 0].contiguous() if m == 1 else b
        bhat = permute_rhs(bv, perm, lay.n_pad)
        x = torch.zeros((n_x,) + tuple(bv.shape[1:]), dtype=tdt, device=dev)
        bl = torch.cat([bv, bv.new_zeros((1,) + tuple(bv.shape[1:]))]
                       ).index_select(0, perm_rows)
        try:
            lib_ms = time_ms(torch, lambda: torch.triangular_solve(
                b, A_csr, upper=False))[0]
        except (RuntimeError, NotImplementedError, TypeError) as err:
            print(f"library: torch.triangular_solve on sparse CSR unavailable: {err}")
            lib_ms = None
        bound, bound_by = solve_bound_ms(L, m, dt)
        timings = {
            "sptrsv_level" if m == 1 else "sptrsv_level_batched": (
                lambda: level_cuda.level_walk(x, bhat, cols, vals0[0], vals0[1], steps),
                lambda: level_walk_ref(x, bhat, cols, vals0[0], vals0[1], steps)),
            "sptrsv_fused" if m == 1 else "sptrsv_fused_batched": (
                lambda: fused_cuda.fused_solve(bl, fcols, fvals, fdiag, spans),
                lambda: fused_solve_ref(bl, fcols, fvals, fdiag, chunk=flay.chunk)),
        }
        for name, (kern, plain) in timings.items():
            ms = time_ms(torch, kern)
            plain_ms = time_ms(torch, plain)
            print(f"phase 4: kernel {name:22s} f64 m={m:2d}: {fmt_ms(ms)} per "
                  f"solve ({json.dumps(per_solve[name])} launches), plain "
                  f"{fmt_ms(plain_ms)}, bound {bound:.6f} ms ({bound_by}), library "
                  f"{'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'}")
            source, replaces = KERNELS[name]
            report.append({
                "name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": main_launches[name],
                "launches_per_solve": per_solve[name],
                "max_abs_err": kernel_err[name, dt], "ms": ms[0],
                "ms_min_max": [ms[1], ms[2]], "plain_ms": plain_ms[0],
                "bound_ms": bound, "bound_by": bound_by, "library_ms": lib_ms})
    report.sort(key=lambda r: list(KERNELS).index(r["name"]))

    print(f"card: {card}")
    print(json.dumps({"kernels": report}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
