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

A ``mesh`` (data or model parallel training) waits for the mesh and
sharding layer (ROADMAP A12).
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

from ..checkpoint.manager import CheckpointManager
from ..data.pipeline import SyntheticLM
from ..models.model import Model
from ..optim.optimizers import Optimizer
from .steps import make_train_step

__all__ = ["TrainConfig", "Trainer"]

MESH = "Trainer(mesh=): sharded training is not ported yet (ROADMAP A12)"


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
        if mesh is not None:
            raise NotImplementedError(MESH)
        self.model = model
        self.optimizer = optimizer
        self.data = data
        self.cfg = cfg
        self.failure_hook = failure_hook
        self.ckpt = CheckpointManager(cfg.ckpt_dir)
        self.straggler_events = 0
        self.recoveries = 0
        self._times: deque = deque(maxlen=32)
        self.step_fn = make_train_step(model, optimizer, micro_steps=cfg.micro_steps)

    # ---- state ------------------------------------------------------------
    def init_state(self):
        gen = torch.Generator(device=self.model.device).manual_seed(self.cfg.seed)
        params = self.model.init(gen, masters=True)
        return params, self.optimizer.init(params), 0

    def _restore(self, params, opt_state):
        if self.ckpt.latest_step() is None:
            return params, opt_state, 0
        tree, manifest = self.ckpt.restore({"params": params, "opt": opt_state})
        return tree["params"], tree["opt"], int(manifest["step"])

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
                print(f"[trainer] recovered from failure ({e}) -> step {step}")
                continue
            dt = time.perf_counter() - t0
            if len(self._times) >= 4:
                med = float(np.median(self._times))
                if dt > self.cfg.straggler_factor * med:
                    self.straggler_events += 1
                    print(f"[trainer] straggler: step {step} took {dt:.3f}s "
                          f"(median {med:.3f}s)")
            self._times.append(dt)
            seconds.append(dt)
            step += 1
            history.append(loss)
            if step % self.cfg.log_every == 0:
                print(f"[trainer] step {step} loss {loss:.4f} ({dt*1e3:.0f} ms)")
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
