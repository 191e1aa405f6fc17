"""Serving launcher: the continuous-batching engine over a synthetic
request stream, reporting throughput.

    PYTHONPATH=src python -m repro_torch.launch.serve [--arch gemma3-1b]
        [--smoke] [--slots 4] [--requests 16] [--max-new 16] [--cache 128]
        [--device cuda|cpu]

The flags are those of the JAX package's launcher, plus ``--device``.  The
default arch is ``gemma3-1b``, as the JAX launcher's; granite-3-8b,
gemma3-12b, qwen1.5-32b, recurrentgemma-2b, xlstm-350m,
llama4-scout-17b-a16e and arctic-480b run too (the MoE archs' full
configs do not fit one card: run them with ``--smoke``); whisper-medium
and paligemma-3b raise ``NotImplementedError``, as does ``--ckpt`` until
checkpoints are ported.  Parameters are random, drawn from seed 0 on the
chosen device.
"""
from __future__ import annotations

import argparse
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-1b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--cache", type=int, default=128)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from repro_torch.configs import get_config, smoke_config
    from repro_torch.models.model import Model
    from repro_torch.serve.engine import Request, ServeEngine

    if args.ckpt:
        raise NotImplementedError("--ckpt: checkpoints are not ported yet "
                                  "(ROADMAP A12)")
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = Model(cfg, device=args.device)
    params = model.init(torch.Generator(device=model.device).manual_seed(0))
    print(f"[serve] {cfg.name}{' (smoke)' if args.smoke else ''} on "
          f"{model.device.type}: {cfg.num_layers} layers {cfg.block_pattern}")
    eng = ServeEngine(model, params, batch_slots=args.slots, s_cache=args.cache)
    rng = np.random.default_rng(0)
    reqs = []
    for i in range(args.requests):
        plen = int(rng.integers(4, 16))
        r = Request(i, rng.integers(0, cfg.vocab_size, (plen,)).astype(np.int32),
                    max_new=args.max_new)
        reqs.append(r)
        eng.submit(r)
    t0 = time.perf_counter()
    eng.run(max_steps=10_000)
    if model.device.type == "cuda":
        torch.cuda.synchronize(model.device)
    dt = time.perf_counter() - t0
    toks = sum(len(r.out) for r in reqs)
    done = sum(r.done for r in reqs)
    print(f"[serve] {done}/{len(reqs)} requests, {toks} tokens, "
          f"{toks/dt:.1f} tok/s ({eng.steps} steps, {args.slots} slots, "
          f"{model.device.type})")
    return reqs


if __name__ == "__main__":
    main()
