"""Training launcher: the fault-tolerant Trainer on synthetic data.

    PYTHONPATH=src python -m repro_torch.launch.train [--arch gemma3-1b]
        [--smoke] [--steps 100] [--seq 128] [--batch 8]
        [--optimizer adamw|adafactor|sgd|tripre] [--lr 3e-3]
        [--ckpt-dir DIR] [--ckpt-every 25] [--resume auto|none]
        [--micro-steps 1] [--model-parallel 1] [--device cuda|cpu]
        [--layers N] [--max-recoveries N]

The flags are those of the JAX package's launcher, plus ``--device`` (the
card unless ``cpu`` is asked for), ``--layers`` (train the config's first
``N`` layers at full width) and ``--max-recoveries`` (end the job after
that many failed steps; unbounded by default, as the reference).  Each
layer is recomputed in the backward pass unless ``--smoke``, as in the
JAX launcher.  The checkpoint directory defaults to one under the system's
temporary directory.  Returns the Trainer's result with the optimizer
under ``"optimizer"`` and the mesh's shape under ``"mesh"`` (None
unsharded).

Sharded training runs one process per rank, each with ``RANK``,
``WORLD_SIZE`` and ``REPRO_TORCH_STORE`` (a file path every rank shares,
which :mod:`repro_torch.launch.mesh` makes the process group's store):
gloo ranks with ``--device cpu``, NCCL ranks on the card.  A world above
one trains on ``local_mesh(model=--model-parallel)``, a ``("data",
"model")`` mesh (``ValueError`` where ``--model-parallel`` does not divide
the world); a world of one trains without a mesh, whatever
``--model-parallel`` says, as the JAX launcher does.

    for r in 0 1; do RANK=$r WORLD_SIZE=2 REPRO_TORCH_STORE=/tmp/store \
        PYTHONPATH=src python -m repro_torch.launch.train --smoke \
        --device cpu --model-parallel 2 & done; wait
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-1b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--optimizer", default="adamw",
                    choices=["adamw", "adafactor", "sgd", "tripre"])
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_launch_train"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--resume", default="auto", choices=["auto", "none"])
    ap.add_argument("--micro-steps", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--layers", type=int, default=0,
                    help="train only the first N layers (0: all)")
    ap.add_argument("--max-recoveries", type=int, default=None)
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config, smoke_config
    from repro_torch.launch import mesh as meshes
    from repro_torch.models.model import Model

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    model = Model(cfg, remat=not args.smoke, device=args.device)
    world = int(os.environ.get("WORLD_SIZE", 1))
    made = world > 1 and not meshes.dist.is_initialized()
    if made:
        meshes.init_process_group(world, device=model.device)
    try:
        mesh = (meshes.local_mesh(model=args.model_parallel, device=model.device)
                if world > 1 else None)
        return _train(args, cfg, model, mesh)
    finally:
        if made:
            meshes.destroy_process_group()


def _train(args, cfg, model, mesh):
    import torch.distributed as dist

    from repro_torch.data import SyntheticLM
    from repro_torch.optim import get_optimizer
    from repro_torch.train import TrainConfig, Trainer

    rank0 = mesh is None or dist.get_rank() == 0
    shape = None if mesh is None else tuple(mesh.shape)
    if rank0:
        print(f"[launch] arch={cfg.name} layers={cfg.num_layers} device="
              f"{model.device.type} remat={model.remat} optimizer={args.optimizer} "
              f"mesh={shape}")
    data = SyntheticLM(cfg.vocab_size, args.seq, args.batch,
                       family=cfg.family, d_model=cfg.d_model,
                       prefix_len=cfg.prefix_len)
    opt = get_optimizer(args.optimizer, lr=args.lr, total_steps=args.steps)
    tc = TrainConfig(steps=args.steps, ckpt_every=args.ckpt_every,
                     ckpt_dir=args.ckpt_dir, resume=args.resume,
                     micro_steps=args.micro_steps,
                     max_recoveries=args.max_recoveries)
    out = Trainer(model, opt, data, tc, mesh=mesh).run()
    hist = out["history"]
    if rank0:
        print(f"[launch] done at step {out['final_step']}; "
              + (f"loss {hist[0]:.3f} -> {hist[-1]:.3f}; " if hist else "no step run; ")
              + f"stragglers={out['straggler_events']} recoveries={out['recoveries']}")
    return dict(out, optimizer=opt, mesh=shape)



if __name__ == "__main__":
    main()
