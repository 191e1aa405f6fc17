"""Training loop with fault tolerance and straggler mitigation: the JAX
package's ``train/loop.py`` on one device.

* the parameters start as f32 masters drawn from ``torch.Generator`` seeded
  with ``TrainConfig.seed`` on the model's device;
* a checkpoint every ``ckpt_every`` steps (``save_async``, written beside
  the next steps), atomic, and a final save;
* ``resume="auto"`` restores the latest checkpoint;
* a failed step (an exception, or one ``failure_hook`` injects) rolls back
  to the last checkpoint instead of ending the job, as the reference's
  catch-all does; ``TrainConfig.max_recoveries`` (unbounded by default, as
  the reference) ends the job past that many, so that a step that fails
  every time does not loop for ever;
* the straggler watchdog: a step slower than ``straggler_factor`` times the
  trailing median is counted.

With a ``mesh`` (a ``("data", "model")`` ``DeviceMesh`` of
:mod:`repro_torch.launch.mesh`, every rank running the same Trainer) the
training is sharded, as the JAX Trainer's:

* every rank draws the full masters from the same seeded generator and
  keeps its blocks (:func:`repro_torch.models.sharding.shard_params`, the
  ``2d`` policy): DTensors at rest; the optimizer state mirrors them, so
  each moment is sharded as its own parameter;
* each rank takes its slice of ``data.batch(step)`` by
  :func:`~repro_torch.models.sharding.batch_specs` (split over the batch
  axes when divisible, else whole) and runs
  :func:`~repro_torch.train.steps.make_train_step` with
  ``DistContext(mesh, dp_axes(mesh))``;
* checkpoints gather each leaf and rank 0 writes the unsharded files; a
  restore reads them onto this mesh, whatever mesh (or none) saved them;
* a failure hook is a function of the step, so every rank fails, rolls
  back and resumes at the same step; the straggler watchdog reads the
  slowest rank's step time, so every rank counts the same events; only
  rank 0 logs.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from collections import deque
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..checkpoint.manager import CheckpointManager
from ..data.pipeline import SyntheticLM
from ..models.model import DistContext, Model
from ..models.sharding import (NamedSharding, batch_specs, dp_axes, local_slice,
                               shard_params, spec_of)
from ..optim.optimizers import Optimizer
from ..tree import map_tree
from .steps import make_train_step

__all__ = ["TrainConfig", "Trainer"]


@dataclasses.dataclass
class TrainConfig:
    steps: int = 100
    ckpt_every: int = 25
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    micro_steps: int = 1
    log_every: int = 10
    straggler_factor: float = 3.0
    resume: str = "auto"           # auto | none
    seed: int = 0
    max_recoveries: Optional[int] = None


class Trainer:
    def __init__(self, model: Model, optimizer: Optimizer, data: SyntheticLM,
                 cfg: TrainConfig, *, mesh=None,
                 failure_hook: Optional[Callable[[int], bool]] = None):
        self.model = model
        self.optimizer = optimizer
        self.data = data
        self.cfg = cfg
        self.failure_hook = failure_hook
        self.ckpt = CheckpointManager(cfg.ckpt_dir)
        self.straggler_events = 0
        self.recoveries = 0
        self._times: deque = deque(maxlen=32)
        self.mesh = mesh
        self.dist = None if mesh is None else DistContext(mesh=mesh,
                                                          dp_axes=dp_axes(mesh))
        self.rank0 = mesh is None or dist.get_rank() == 0
        self.step_fn = make_train_step(model, optimizer, dist=self.dist,
                                       micro_steps=cfg.micro_steps)

    # ---- state ------------------------------------------------------------
    def init_state(self):
        gen = torch.Generator(device=self.model.device).manual_seed(self.cfg.seed)
        params = self.model.init(gen, masters=True)
        if self.mesh is not None:
            params = shard_params(params, self.mesh, self.model.cfg)
        return params, self.optimizer.init(params), 0

    def _shardings(self, tree):
        """Where a restore puts each leaf: a DTensor leaf of the fresh state
        where it is, any other leaf whole."""
        if self.mesh is None:
            return None
        return map_tree(lambda x: NamedSharding(self.mesh, spec_of(x))
                        if hasattr(x, "placements") else None, tree)

    def _restore(self, params, opt_state):
        if self.ckpt.latest_step() is None:
            return params, opt_state, 0
        template = {"params": params, "opt": opt_state}
        tree, manifest = self.ckpt.restore(template,
                                           shardings=self._shardings(template))
        return tree["params"], tree["opt"], int(manifest["step"])

    def _local_batch(self, batch: dict) -> dict:
        """This rank's slice of the global batch."""
        if self.mesh is None:
            return batch
        return map_tree(lambda x, s: local_slice(x, s, self.mesh), batch,
                        batch_specs(self.mesh, batch))

    def _slowest(self, dt: float) -> float:
        """The step's wall time on the slowest rank."""
        if self.mesh is None:
            return dt
        t = torch.tensor([dt], dtype=torch.float64, device=self.model.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return float(t[0])

    def _log(self, msg: str) -> None:
        if self.rank0:
            print(msg)

    def _sync(self):
        if self.model.device.type == "cuda":
            torch.cuda.synchronize(self.model.device)

    # ---- loop -------------------------------------------------------------
    def run(self) -> dict:
        """Train to ``cfg.steps``: ``{"history": losses, "final_step",
        "straggler_events", "recoveries", "step_seconds": each step's wall
        time, "save_seconds" and "save_bytes": the final checkpoint's}``."""
        params, opt_state, start = self.init_state()
        if self.cfg.resume == "auto":
            params, opt_state, start = self._restore(params, opt_state)
        step = start
        history, seconds = [], []
        while step < self.cfg.steps:
            batch_np = self.data.batch(step)
            batch = {"tokens": batch_np.tokens, "labels": batch_np.labels}
            if batch_np.extras:
                batch.update(batch_np.extras)
            batch = self._local_batch(batch)
            t0 = time.perf_counter()
            try:
                if self.failure_hook and self.failure_hook(step):
                    raise RuntimeError(f"injected failure at step {step}")
                params, opt_state, metrics = self.step_fn(params, opt_state, batch)
                loss = float(metrics["loss"])
            except Exception as e:  # noqa: BLE001 — step failure => recover
                self.recoveries += 1
                if (self.cfg.max_recoveries is not None
                        and self.recoveries > self.cfg.max_recoveries):
                    raise
                self.ckpt.wait()
                params = opt_state = None
                p, o, s = self.init_state()
                params, opt_state, step = self._restore(p, o)
                self._log(f"[trainer] recovered from failure ({e}) -> step {step}")
                continue
            dt = self._slowest(time.perf_counter() - t0)
            if len(self._times) >= 4:
                med = float(np.median(self._times))
                if dt > self.cfg.straggler_factor * med:
                    self.straggler_events += 1
                    self._log(f"[trainer] straggler: step {step} took {dt:.3f}s "
                          f"(median {med:.3f}s)")
            self._times.append(dt)
            seconds.append(dt)
            step += 1
            history.append(loss)
            if step % self.cfg.log_every == 0:
                self._log(f"[trainer] step {step} loss {loss:.4f} ({dt*1e3:.0f} ms)")
            if step % self.cfg.ckpt_every == 0:
                self.ckpt.save_async({"params": params, "opt": opt_state}, step)
        self.ckpt.wait()
        t0 = time.perf_counter()
        self.ckpt.save({"params": params, "opt": opt_state}, step)
        save_s = time.perf_counter() - t0
        path = os.path.join(self.ckpt.dir, f"step_{step}", "arrays.npz")
        return {"history": history, "final_step": step,
                "straggler_events": self.straggler_events,
                "recoveries": self.recoveries, "step_seconds": seconds,
                "save_seconds": save_s, "save_bytes": os.path.getsize(path)}
