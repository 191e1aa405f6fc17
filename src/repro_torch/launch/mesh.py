"""Device meshes over ``torch.distributed`` — the port's ``make_mesh`` and
``local_mesh``.

A mesh is a :class:`torch.distributed.device_mesh.DeviceMesh` with named
dimensions (``("data",)`` for the distributed solve).  Where no process
group exists, :func:`make_mesh` creates the default one from a
:class:`torch.distributed.FileStore` — never from a network address: NCCL
on the card, gloo on the CPU.  Each process is one rank and calls
:func:`make_mesh` with the same shape (SPMD); its rank comes from the
argument or the ``RANK`` environment variable, the store's file from the
argument or ``REPRO_TORCH_STORE``.  A world of one needs neither: it makes
its store in a temporary directory, which :func:`destroy_process_group`
removes with the group.

    mesh = make_mesh((1,), ("data",))                  # one card
    mesh = make_mesh((4,), ("data",), device="cpu",    # rank r of 4 ranks
                     rank=r, store_path="/path/to/store")
    ...
    destroy_process_group()

The JAX package's ``make_production_mesh`` (256/512 TPU chips) has no
counterpart here.
"""
from __future__ import annotations

import math
import os
import shutil
import tempfile
from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..kernels.backend import resolve_device

__all__ = ["make_mesh", "local_mesh", "init_process_group",
           "destroy_process_group"]

STORE_ENV = "REPRO_TORCH_STORE"

# the temporary directory of the default group's store, when this module
# made it (a world of one without a store path)
_store_dir: Optional[str] = None


def init_process_group(world_size: int, *, device="cuda",
                       rank: Optional[int] = None,
                       store_path: Optional[str] = None) -> None:
    """Create the default process group of ``world_size`` ranks on a
    :class:`~torch.distributed.FileStore` (NCCL for ``device="cuda"``, bound
    to this process's card, gloo for ``"cpu"``).  ``rank`` defaults to the
    ``RANK`` environment variable (0 when unset), ``store_path`` to
    ``REPRO_TORCH_STORE``; a world of one without a store path uses a file
    in a new temporary directory, removed by :func:`destroy_process_group`.
    Raises ``RuntimeError`` if a default group already exists."""
    global _store_dir
    dev = resolve_device(device)
    if dist.is_initialized():
        raise RuntimeError("a default process group already exists")
    rank = int(os.environ.get("RANK", 0)) if rank is None else rank
    store_path = store_path or os.environ.get(STORE_ENV)
    if store_path is None and world_size != 1:
        raise ValueError(f"a world of {world_size} ranks needs a shared "
                         f"store file: pass store_path= or set {STORE_ENV}")
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} is outside a world of {world_size}")
    if store_path is None:
        _store_dir = tempfile.mkdtemp(prefix="repro_torch_pg_")
        store_path = os.path.join(_store_dir, "store")
    store = dist.FileStore(store_path, world_size)
    if dev.type == "cuda":
        card = torch.device("cuda", torch.cuda.current_device()
                            if dev.index is None else dev.index)
        dist.init_process_group("nccl", store=store, rank=rank,
                                world_size=world_size, device_id=card)
    else:
        dist.init_process_group("gloo", store=store, rank=rank,
                                world_size=world_size)


def destroy_process_group() -> None:
    """Destroy the default process group, and remove the temporary store
    directory :func:`init_process_group` made for it, if it made one."""
    global _store_dir
    dist.destroy_process_group()
    if _store_dir is not None:
        shutil.rmtree(_store_dir, ignore_errors=True)
        _store_dir = None


def make_mesh(shape: Sequence[int], axes: Sequence[str], *, device="cuda",
              rank: Optional[int] = None,
              store_path: Optional[str] = None) -> DeviceMesh:
    """A :class:`DeviceMesh` of ``shape`` with dimension names ``axes`` over
    every rank of the default process group, which is created first
    (:func:`init_process_group`, world size ``prod(shape)``) when none
    exists."""
    if len(shape) != len(axes):
        raise ValueError(f"shape {tuple(shape)} and axes {tuple(axes)} differ "
                         "in length")
    dev = resolve_device(device)
    if not dist.is_initialized():
        init_process_group(math.prod(shape), device=dev, rank=rank,
                           store_path=store_path)
    return init_device_mesh(dev.type, tuple(shape), mesh_dim_names=tuple(axes))


def local_mesh(model: Optional[int] = None, *, device="cuda") -> DeviceMesh:
    """A ``("data", "model")`` mesh over every rank of the default process
    group (a world of one when none exists), ``model`` ranks wide."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    model = model or 1
    if n % model:
        raise ValueError(f"model={model} does not divide {n} ranks")
    return make_mesh((n // model, model), ("data", "model"), device=device)
