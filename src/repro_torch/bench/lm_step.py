"""Time the LM serving path's decode step at one arch's full width, as
``chip_smoke.py`` serves it: ms per ``Model.decode_step`` with SLOTS
slots at position S_CACHE // 2 (CUDA events around SAMPLES batches of
REPS steps, host gaps included), and the device's busy share of a step
under ``torch.profiler``.  Random bf16 weights from seed 0; no prefill,
so no kernel is built.

    PYTHONPATH=src python -m repro_torch.bench.lm_step [--arch granite-3-8b]
        [--json PATH] [--smoke --device cpu]

The script imports only ``repro_torch.configs.get_config`` and
``repro_torch.models.model.Model``, so it can time another tree's model
in the same call: put that tree's ``src`` on ``PYTHONPATH`` and run the
file through ``runpy``, which keeps the file's own directory off
``sys.path``::

    PYTHONPATH=OTHER/src python -c "import runpy; runpy.run_path(
        'src/repro_torch/bench/lm_step.py', run_name='__main__')" --arch ...

The last line printed is a JSON record naming the tree it timed.
``--smoke --device cpu`` runs the arch's smoke configuration on the host
clock (no busy share).
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time
from pathlib import Path

import torch

import repro_torch
from repro_torch.configs import get_config
from repro_torch.models.model import Model

__all__ = ["measure", "main"]

SLOTS, S_CACHE, SAMPLES, REPS = 4, 2048, 5, 10


def _card() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True, timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def _batch_ms(fn, reps: int, cuda: bool) -> float:
    """ms per call of ``reps`` calls in a row."""
    if not cuda:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _busy(fn, reps: int) -> dict:
    """Device kernel time and host wall time per call over ``reps`` calls
    under ``torch.profiler``, and device ops per call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / reps
    ops = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    dev = sum(e.time_range.elapsed_us() for e in ops) / 1e3 / reps
    return {"device_ms": dev, "wall_ms": wall,
            "busy": dev / wall if ops else None, "device_ops": len(ops) // reps}


def measure(arch: str = "granite-3-8b", *, smoke: bool = False,
            device: str = "cuda") -> dict:
    """Decode-step times of ``arch``: SAMPLES batches of REPS steps after
    3 untimed ones."""
    cfg = get_config(arch)
    if smoke:
        from repro_torch.models.config import smoke_config
        cfg = smoke_config(arch)
    cuda = device == "cuda"
    model = Model(cfg, device=device)
    params = model.init(torch.Generator(device=device).manual_seed(0))
    cache = model.init_cache(SLOTS, S_CACHE)
    cache["idx"] = S_CACHE // 2
    toks = torch.randint(0, cfg.vocab_size, (SLOTS, 1),
                         generator=torch.Generator().manual_seed(1)).to(device)

    def step():
        model.decode_step(params, toks, cache)

    for _ in range(3):
        step()
    if cuda:
        torch.cuda.synchronize()
    per = [_batch_ms(step, REPS, cuda) for _ in range(SAMPLES)]
    rec = {"tree": str(Path(repro_torch.__file__).resolve().parents[2]),
           "arch": arch, "layers": cfg.num_layers, "slots": SLOTS,
           "position": S_CACHE // 2, "decode_ms": statistics.median(per),
           "decode_ms_samples": per, "device": device}
    if cuda:
        rec.update(_busy(step, 5), card=_card())
    return rec


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="granite-3-8b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--json", default=None, help="append the record to this file")
    a = ap.parse_args(argv)
    rec = measure(a.arch, smoke=a.smoke, device=a.device)
    line = json.dumps(rec)
    if a.json:
        with open(a.json, "a") as f:
            f.write(line + "\n")
    print(line)
    return rec


if __name__ == "__main__":
    main()
