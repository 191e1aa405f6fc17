"""Atomic checkpointing with async save: the JAX package's
``checkpoint/manager.py`` over the port's trees, writing the same files.

* **The same files on disk**: ``arrays.npz``, one array per leaf keyed by
  ``md5(path)[:16]`` of the leaf's JAX-style path
  (``['params']['layers'][0]['mix']['q']['w']``, :mod:`repro_torch.tree`),
  bf16 widened to f32 with the original dtype in ``manifest.json``, and a
  per-leaf ``sum``; so either package restores what the other saved, for a
  tree of the same structure.
* **Atomic**: writes go to ``<dir>/tmp.<step>/`` and are renamed to
  ``<dir>/step_<step>/`` once the manifest is fsynced; a job killed
  mid-save leaves a tmp dir that restore ignores.
* **Async**: ``save_async`` copies the tree to host memory synchronously
  and writes it in a daemon thread, beside the next train steps; ``wait()``
  joins before the next save or exit.
* ``restore`` casts each array to its template leaf's dtype and device.
* **Sharded trees** (DTensor leaves, the sharded Trainer's): ``save`` /
  ``save_async`` gather each leaf on every rank (a collective, in leaf
  order); rank 0 writes the files an unsharded save writes, and every rank
  waits at a barrier (``save``'s end, or ``wait()`` after ``save_async``).
  ``restore(shardings=)`` reads the whole array on every rank and keeps
  this rank's block (a :class:`~repro_torch.models.sharding.NamedSharding`
  per leaf; None, for a leaf or a whole subtree, restores it unsharded), so
  a checkpoint restores onto any mesh shape, or none.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..tree import leaves, leaves_with_path, map_tree, unflatten

__all__ = ["CheckpointManager", "save_pytree", "restore_pytree"]


def _host(leaf) -> tuple[np.ndarray, str]:
    """A leaf as a numpy array npz can hold, and its dtype's name."""
    if torch.is_tensor(leaf):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:   # npz cannot hold it: widened, as JAX does
            return t.float().numpy(), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def save_pytree(tree: Any, path: str, *, manifest_extra: Optional[dict] = None):
    os.makedirs(path, exist_ok=True)
    arrays, meta = {}, {}
    for name, leaf in leaves_with_path(tree):
        arr, orig_dtype = _host(leaf)
        key = hashlib.md5(name.encode()).hexdigest()[:16]
        arrays[key] = arr
        meta[name] = {"key": key, "shape": list(arr.shape), "dtype": orig_dtype,
                      # summed in f64 without an f64 copy of the leaf
                      "sum": float(np.sum(arr, dtype=np.float64)) if arr.size else 0.0}
    np.savez(os.path.join(path, "arrays.npz"), **arrays)
    manifest = {"leaves": meta, "saved_at": time.time()}
    manifest.update(manifest_extra or {})
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())


def restore_pytree(template: Any, path: str, *, shardings: Any = None) -> Any:
    """``template``'s structure with each leaf read from the checkpoint at
    ``path``, cast to the template leaf's dtype and moved to its device;
    with ``shardings``, a tree of the template's structure (a subtree may
    be None), each leaf with a sharding this rank's block of it as a
    DTensor."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    out = []
    shards = leaves(_spread(shardings, template))
    with np.load(os.path.join(path, "arrays.npz")) as data:
        for (name, leaf), sh in zip(leaves_with_path(template), shards):
            arr = data[manifest["leaves"][name]["key"]]
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"{name}: checkpoint shape {arr.shape}, "
                                 f"template {tuple(leaf.shape)}")
            if sh is None:
                out.append(torch.from_numpy(arr).to(leaf.device, leaf.dtype))
            else:
                full = torch.from_numpy(arr).to(sh.mesh.device_type, leaf.dtype)
                out.append(sh.shard(full))
    return unflatten(template, out)


def _spread(shardings, template):
    """``shardings`` with each None subtree spread to a None per leaf of
    ``template``'s matching subtree."""
    if shardings is None:
        return map_tree(lambda _: None, template)
    if isinstance(template, dict):
        return {k: _spread(shardings[k], v) for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_spread(s, t) for s, t in zip(shardings, template))
    return shardings


def _is_sharded(tree) -> bool:
    from torch.distributed.tensor import DTensor

    return any(isinstance(x, DTensor) for x in leaves(tree))


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._barrier = False      # a sharded save_async the ranks wait for

    # -- discovery -----------------------------------------------------------
    def steps(self):
        out = []
        for d in os.listdir(self.dir):
            if d.startswith("step_") and os.path.exists(
                    os.path.join(self.dir, d, "manifest.json")):
                out.append(int(d.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    # -- save ------------------------------------------------------------------
    def _write(self, host_tree, step: int, extra: dict):
        tmp = os.path.join(self.dir, f"tmp.{step}")
        final = os.path.join(self.dir, f"step_{step}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        save_pytree(host_tree, tmp, manifest_extra=dict(extra, step=step))
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

    @staticmethod
    def _to_host(tree):
        """Every leaf on the host; a DTensor gathered whole (a collective)."""
        def host(a):
            if torch.is_tensor(a):
                a = a.full_tensor() if hasattr(a, "full_tensor") else a
                return a.detach().cpu()
            return np.asarray(a)
        return map_tree(host, tree)

    def save(self, tree: Any, step: int, **extra):
        sharded = _is_sharded(tree)
        host = self._to_host(tree)
        if not sharded or dist.get_rank() == 0:
            self._write(host, step, extra)
        if sharded:
            dist.barrier()

    def save_async(self, tree: Any, step: int, **extra):
        self.wait()
        sharded = _is_sharded(tree)
        host = self._to_host(tree)
        if not sharded or dist.get_rank() == 0:
            self._thread = threading.Thread(
                target=self._write, args=(host, step, extra), daemon=True)
            self._thread.start()
        self._barrier = sharded

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._barrier:
            self._barrier = False
            dist.barrier()

    def _gc(self):
        steps = self.steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"), ignore_errors=True)

    # -- restore ----------------------------------------------------------------
    def restore(self, template: Any, step: Optional[int] = None, *,
                shardings: Any = None):
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint found in {self.dir}")
        path = os.path.join(self.dir, f"step_{step}")
        tree = restore_pytree(template, path, shardings=shardings)
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        return tree, manifest
