"""Calibration micro-run: measure the planner's pricing coefficients on the
card and print (or write) the ``"cuda"`` row of
:mod:`repro_torch.core.calibrate`.

    python -m repro_torch.bench.calibrate                  # print the row
    python -m repro_torch.bench.calibrate --json calibration.json
    python -m repro_torch.bench.calibrate --bench-json BENCH_calibrate.json

Each coefficient, in FLOP-equivalents of the reference gather throughput,
and what it is measured with (CUDA events around repeated calls, host
launch gaps included, as a solve pays them):

* ``gather_cost`` = 1 defines the unit: the SpMV kernel
  (``kernels/spmv_ell``, B5) on a random ``(K, n) = (8, 2**20)`` f32 ELL
  slab with row lengths, ``2·K·n`` flops per call;
* ``launch_cost``: one call of the same kernel on an 8-row slab, times the
  gather rate;
* ``serial_step_cost`` and ``serial_step_cost_scale``: the ``serial``
  solver (``core/packed.py``) on ``chain_matrix`` of 2**10 and 2**13 rows,
  per row, fit as ``base + scale·n``;
* ``gemm_cost`` and ``trsm_cost``: the block-apply kernel
  (``kernels/trsm_block``, B6) on 1,024 and 16,384 blocks of 32 x 32
  (f32; fewer blocks leave one launch's host cost, not the blocks, in the
  difference): the marginal time per block over its ``2·T²`` flops, and
  the intercept per block.

``lane_width``, ``fused_max_rows``, ``fused_num_launches``,
``substep_cost`` and ``mixed_gather_discount`` are facts of the port, not
timings, and keep the shipped row's values.  ``--device cpu`` runs the same
micro-run on the host's plain versions (a smoke run of this script; its
numbers are not the card's).
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from ..core.calibrate import (DEFAULT_CALIBRATIONS, BackendCalibration,
                              save_calibrations)
from ..core.solver import SpTRSV
from ..kernels.backend import resolve_device
from ..kernels.spmv_ell.ops import spmv
from ..kernels.trsm_block.ops import block_apply
from ..sparse import chain_matrix
from .common import write_bench_json

__all__ = ["measure", "write_bench", "main"]


def _seconds(fn, device: torch.device, iters: int, warmup: int = 2) -> float:
    """Seconds per call of ``fn``: CUDA events around ``iters`` calls on the
    card (host gaps included), the host clock on the CPU."""
    for _ in range(warmup):
        fn()
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters


def _spmv_call(n: int, K: int, device: torch.device, rng):
    """A call of the SpMV kernel on a random ``(K, n)`` f32 slab whose rows
    are all ``K`` long."""
    cols = rng.integers(0, n, size=(K, n))
    idt = torch.int32 if device.type == "cuda" else torch.int64
    cols_t = torch.from_numpy(cols).to(device, idt)
    vals = torch.from_numpy(rng.standard_normal((K, n))).to(device, torch.float32)
    v = torch.from_numpy(rng.standard_normal(n)).to(device, torch.float32)
    row_len = (torch.full((n,), K, dtype=torch.int32, device=device)
               if device.type == "cuda" else None)
    return lambda: spmv(v, cols_t, vals, row_len)


def _serial_row_seconds(n: int, device: torch.device, iters: int) -> float:
    s = SpTRSV.build(chain_matrix(n, dtype=np.float32), strategy="serial",
                     device=device)
    b = torch.from_numpy(np.random.default_rng(1).standard_normal(n)
                         .astype(np.float32)).to(device)
    return _seconds(lambda: s.solve(b), device, iters, warmup=1) / n


def _block_apply_seconds(B: int, T: int, device: torch.device, rng,
                         iters: int) -> float:
    dinv = torch.from_numpy(rng.standard_normal((B, T, T))).to(device,
                                                               torch.float32)
    rhs = torch.from_numpy(rng.standard_normal((B, T))).to(device,
                                                           torch.float32)
    return _seconds(lambda: block_apply(dinv, rhs), device, iters)


def measure(device="cuda", *, smoke: bool = False) -> tuple:
    """The measured row of ``device``'s family and the raw timings
    (``dict``): gather GFLOP/s, launch µs, serial µs per row at both sizes
    and the block-apply times.  ``smoke`` shrinks every size."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    n_g, K = (1 << 12, 8) if smoke else (1 << 20, 8)
    it = 5 if smoke else 50
    gather_s = _seconds(_spmv_call(n_g, K, dev, rng), dev, it)
    flops_per_s = 2.0 * K * n_g / gather_s
    launch_s = _seconds(_spmv_call(8, 1, dev, rng), dev, it * 4)
    n_small, n_big = (1 << 6, 1 << 8) if smoke else (1 << 10, 1 << 13)
    row_small = _serial_row_seconds(n_small, dev, 2 if smoke else 5)
    row_big = _serial_row_seconds(n_big, dev, 2 if smoke else 3)
    scale = max((row_big - row_small) / (n_big - n_small), 0.0) * flops_per_s
    serial_base = max(row_small * flops_per_s - scale * n_small, 1.0)
    T = 32
    b_small, b_big = (16, 64) if smoke else (1024, 16384)
    t_small = _block_apply_seconds(b_small, T, dev, rng, it)
    t_big = _block_apply_seconds(b_big, T, dev, rng, it)
    per_block_s = max((t_big - t_small) / (b_big - b_small), 0.0)
    gemm_cost = max(per_block_s * flops_per_s / (2.0 * T * T), 1e-4)
    trsm_cost = max(max(t_small - per_block_s * b_small, 0.0)
                    * flops_per_s / b_small, 1.0)
    base = DEFAULT_CALIBRATIONS.get(dev.type, BackendCalibration(dev.type))
    row = dataclasses.replace(
        base,
        launch_cost=round(launch_s * flops_per_s, 1),
        gather_cost=1.0,
        serial_step_cost=round(serial_base, 2),
        serial_step_cost_scale=round(scale, 4),
        gemm_cost=round(gemm_cost, 4),
        trsm_cost=round(trsm_cost, 2),
        source="measured",
    )
    raw = {"gather_gflops": flops_per_s / 1e9, "launch_us": launch_s * 1e6,
           f"serial_us_per_row_n{n_small}": row_small * 1e6,
           f"serial_us_per_row_n{n_big}": row_big * 1e6,
           f"block_apply_us_B{b_small}": t_small * 1e6,
           f"block_apply_us_B{b_big}": t_big * 1e6}
    return row, raw


def write_bench(path: str, row: BackendCalibration, raw: dict,
                device="cuda") -> None:
    """The measured row as a shared-schema ``BENCH_calibrate`` artifact:
    the row's fields under its backend's name, and the gather rate and the
    launch time (the JAX bench's ``--bench-json`` records)."""
    write_bench_json(
        path, "calibrate",
        {row.backend: {f.name: getattr(row, f.name)
                       for f in dataclasses.fields(row)},
         "gather_gflops": raw["gather_gflops"], "launch_us": raw["launch_us"]},
        backend=resolve_device(device).type)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true",
                    help="small sizes and few iterations")
    ap.add_argument("--json", default="",
                    help="write the table with the measured row here")
    ap.add_argument("--bench-json", default="",
                    help="write a shared-schema BENCH_*.json artifact of the "
                         "measured row here")
    args = ap.parse_args(argv)
    row, raw = measure(args.device, smoke=args.smoke)
    dev = resolve_device(args.device)
    where = (torch.cuda.get_device_name(0) if dev.type == "cuda"
             else "the host CPU (plain versions)")
    print(f"calibrate: measured on {where}")
    for key, value in raw.items():
        print(f"calibrate: {key} {value:.6g}")
    print(f"calibrate: row {row!r}")
    if args.json:
        table = dict(DEFAULT_CALIBRATIONS)
        table[row.backend] = row
        save_calibrations(args.json, table)
        print(f"calibrate: wrote {args.json}")
    if args.bench_json:
        write_bench(args.bench_json, row, raw, args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
