"""Serving launcher: the continuous-batching engine over a synthetic
request stream, reporting throughput.

    PYTHONPATH=src python -m repro_torch.launch.serve [--arch gemma3-1b]
        [--smoke] [--slots 4] [--requests 16] [--max-new 16] [--cache 128]
        [--ckpt DIR] [--device cuda|cpu]

The flags are those of the JAX package's launcher, plus ``--device``.  The
default arch is ``gemma3-1b``, as the JAX launcher's; every other arch
runs too (the MoE archs' full configs do not fit one card: run them with
``--smoke``).  Parameters are random, drawn from seed 0 on the chosen
device, or with ``--ckpt DIR`` the latest step of a checkpoint directory
that the training launcher wrote (``repro_torch.launch.train --ckpt-dir
DIR``, the same arch and ``--smoke``): its ``params``, cast to the serving
model's dtypes.  Whisper-medium and paligemma-3b requests carry their modality
stub, drawn with numpy from the same seed (standard normal, f32, as the
JAX package's ``SyntheticLM`` draws its ``extras``): whisper ``enc_embed``
of ENC_FRAMES frames (30 s of audio at whisper's 50 frames a second after
its convolution's stride; SMOKE_ENC_FRAMES with ``--smoke``), paligemma
``patches`` of ``prefix_len`` rows (256: a 224-pixel image in 14-pixel
patches).  A paligemma sequence is the patches and the prompt, so give it
a ``--cache`` longer than ``prefix_len`` to keep the prompt's keys.
"""
from __future__ import annotations

import argparse
import os
import time

ENC_FRAMES, SMOKE_ENC_FRAMES = 1500, 32


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

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = Model(cfg, device=args.device)
    params = model.init(torch.Generator(device=model.device).manual_seed(0))
    source = "random weights"
    if args.ckpt:
        from repro_torch.checkpoint import CheckpointManager
        if not os.path.isdir(args.ckpt):
            raise FileNotFoundError(f"--ckpt {args.ckpt}: no such directory")
        tree, manifest = CheckpointManager(args.ckpt).restore({"params": params})
        params = tree["params"]
        source = f"{args.ckpt} step {manifest['step']}"
    print(f"[serve] {cfg.name}{' (smoke)' if args.smoke else ''} on "
          f"{model.device.type}: {cfg.num_layers} layers {cfg.block_pattern}, "
          f"{source}")
    eng = ServeEngine(model, params, batch_slots=args.slots, s_cache=args.cache)
    rng = np.random.default_rng(0)
    stub_rows = {"enc_embed": SMOKE_ENC_FRAMES if args.smoke else ENC_FRAMES,
                 "patches": cfg.prefix_len}.get(model.stub)
    reqs = []
    for i in range(args.requests):
        plen = int(rng.integers(4, 16))
        prompt = rng.integers(0, cfg.vocab_size, (plen,)).astype(np.int32)
        extras = None if model.stub is None else {model.stub: rng.standard_normal(
            (stub_rows, cfg.d_model), dtype=np.float32)}
        r = Request(i, prompt, max_new=args.max_new, extras=extras)
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
