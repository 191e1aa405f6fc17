"""Sharding rules of the port: parameter, batch and cache specs for any
mesh, and the parameters as DTensors at rest — the JAX package's
``models/sharding.py`` on ``torch.distributed``.

Logical axes:
  ``dp``    batch        -> ("pod","data") on the multi-pod mesh, else "data"
  ``fsdp``  param shards -> "data"  (ZeRO-3; pod-replicated so the gradient
                            all-reduce is the only cross-pod collective)
  ``tp``    tensor       -> "model" (Megatron: heads / d_ff / vocab)
  ``ep``    experts      -> "model"

Dims are sharded **only when divisible** by the mesh axis size; otherwise the
dim is replicated (e.g. qwen's 40 heads on model=16 → attention projections
stay fsdp-only and TP lives in d_ff/vocab).

A spec (:class:`P`) has one entry per dimension: an axis name, a tuple of
names (sharded over their product, the first name outermost), or None.  The
rules read only the mesh's dimension names and sizes, so a
:class:`~torch.distributed.device_mesh.DeviceMesh` and the shape-only
:class:`MeshShape` serve alike; the production meshes' specs need no ranks:

    param_specs(Model(cfg, device="meta").init(), MeshShape((16, 16)), cfg)

The rules match on the JAX package's parameter paths, in its order
(``_rule`` is the reference's, unchanged).  The port's tree holds one entry
per layer where the JAX tree stacks a scanned layer's leaves on a leading
``reps`` axis; :func:`repro_torch.models.convert.jax_paths` gives each port
leaf its JAX path, and a scanned layer's spec is the JAX spec without its
leading None.

:func:`shard_params` puts a full tree on a mesh as DTensors: ``Shard(d)``
on each mesh dimension the spec names for tensor dimension ``d``,
``Replicate()`` on the others, so that reductions over a leaf (the global
gradient norm, Adafactor's factored means) are reductions over the global
leaf and a replicated leaf counts once.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Sequence

import numpy as np
import torch

from ..tree import map_tree
from .config import ModelConfig
from .convert import jax_paths, scanned_layers

__all__ = [
    "ShardingPolicy", "POLICIES", "dp_axes", "axis_size", "param_specs",
    "batch_specs", "cache_specs", "shard_params", "opt_state_specs",
    "P", "MeshShape", "NamedSharding", "placements", "spec_of",
    "local_slice", "shard",
]


class P(tuple):
    """A partition spec: one entry per dimension, an axis name, a tuple of
    names or None (replicated), as ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple(self)!r}"


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's dimension names and sizes without ranks, for computing
    specs: ``MeshShape((2, 16, 16), ("pod", "data", "model"))``."""
    shape: tuple
    mesh_dim_names: tuple = ("data", "model")

    def __post_init__(self):
        if len(self.shape) != len(self.mesh_dim_names):
            raise ValueError(f"shape {self.shape} and axes {self.mesh_dim_names} "
                             "differ in length")


@dataclasses.dataclass(frozen=True)
class ShardingPolicy:
    """Logical->mesh axis mapping.

    ``2d`` (default): batch over data, FSDP over data, TP/EP over model —
    the Megatron+ZeRO hybrid.
    ``fsdp_only``: batch AND parameters sharded over (data, model) jointly —
    pure ZeRO-3, no tensor parallelism.  MoE archs keep ``2d`` (experts need
    the model axis for EP).
    """
    name: str = "2d"
    fsdp: tuple = ("data",)
    tp: str | None = "model"
    dp: tuple = ("data",)


POLICIES = {
    "2d": ShardingPolicy(),
    "fsdp_only": ShardingPolicy(name="fsdp_only", fsdp=("data", "model"),
                                tp=None, dp=("data", "model")),
}


def _sizes(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names or (), tuple(mesh.shape)))


def dp_axes(mesh) -> tuple:
    return ("pod", "data") if "pod" in (mesh.mesh_dim_names or ()) else ("data",)


def axis_size(mesh, name) -> int:
    if isinstance(name, tuple):
        return int(np.prod([axis_size(mesh, n) for n in name]))
    return int(_sizes(mesh).get(name, 1))


def _div(dim: int, mesh, ax) -> bool:
    return dim % axis_size(mesh, ax) == 0 and axis_size(mesh, ax) > 1


def _rule(ps: str, shape: tuple, mesh, cfg: ModelConfig,
          policy: "ShardingPolicy" = None) -> P:
    """Spec for one param given its JAX path string and (unstacked) shape."""
    policy = policy or POLICIES["2d"]
    fsdp = policy.fsdp if len(policy.fsdp) > 1 else policy.fsdp[0]
    tp = policy.tp

    def ax(dim_size, name):
        if name is None:
            return None
        return name if _div(dim_size, mesh, name) else None

    # embeddings: (V_pad, D)
    if ps.endswith("embed/tok") or ps.endswith("embed/out"):
        return P(ax(shape[0], tp), ax(shape[1], fsdp))
    if "patch_proj" in ps:
        return P(ax(shape[0], fsdp), ax(shape[1], tp))
    # MoE stacked experts: (E, D, F) / (E, F, D)
    if any(ps.endswith(f"ffn/{w}") for w in ("wi", "wg", "wo")) and len(shape) == 3:
        return P(ax(shape[0], tp), ax(shape[1], fsdp), None)
    if "router" in ps:
        return P(ax(shape[0], fsdp), None)
    # attention projections
    if any(f"/{n}/w" in ps for n in ("q", "k", "v")) and len(shape) == 3:
        return P(ax(shape[0], fsdp), ax(shape[1], tp), None)
    if any(f"/{n}/b" in ps for n in ("q", "k", "v")) and len(shape) == 2:
        return P(ax(shape[0], tp), None)
    if "/o/w" in ps:
        return P(ax(shape[0], tp), ax(shape[1], fsdp))
    # MLP
    if any(ps.endswith(f"/{n}/w") for n in ("wi", "wg")) and len(shape) == 2:
        return P(ax(shape[0], fsdp), ax(shape[1], tp))
    if ps.endswith("/wo/w") and len(shape) == 2:
        return P(ax(shape[0], tp), ax(shape[1], fsdp))
    # RG-LRU / LSTM / conv / misc dense (D_in, D_out)
    if len(shape) == 2 and shape[0] >= 128 and shape[1] >= 128:
        return P(ax(shape[0], fsdp), ax(shape[1], tp))
    if len(shape) == 3 and min(shape[1], shape[2]) >= 128:   # (H, dh, dh) blocks
        # per-head recurrent weights used inside the time scan stay
        # replicated up to 16 MiB
        if int(np.prod(shape)) * 4 <= 16 * 2**20:
            return P(None, None, None)
        return P(None, ax(shape[1], fsdp), ax(shape[2], tp))
    if len(shape) == 1 and shape[0] >= 1024:
        return P(ax(shape[0], tp))
    return P(*([None] * len(shape)))


def param_specs(params: Any, mesh, cfg: ModelConfig,
                policy: "ShardingPolicy" = None):
    """The spec of every leaf of the port's ``params`` (tensors, meta
    tensors or anything with ``.shape``): the JAX rule on the leaf's JAX
    path and its own (unstacked) shape."""
    paths = jax_paths(params, cfg)
    return map_tree(lambda leaf, ps: _rule(ps, tuple(leaf.shape), mesh, cfg, policy),
                    params, paths)


def batch_specs(mesh, batch_shape: dict) -> dict:
    """Input specs: batch dim over dp when divisible, else replicated."""
    dp = dp_axes(mesh)
    ndp = axis_size(mesh, dp)

    def one(leaf):
        shape = tuple(np.shape(leaf))
        B = shape[0] if shape else 1
        if B % ndp == 0 and B >= ndp:
            return P(dp if len(dp) > 1 else dp[0], *([None] * (len(shape) - 1)))
        return P(*([None] * len(shape)))

    return map_tree(one, batch_shape)


def _cache_paths(cache: dict, cfg: ModelConfig) -> dict:
    """The JAX cache path of each leaf of the port's cache: a scanned
    layer's ``blocks/p<pos>/<kind>/<name>``, a tail layer's
    ``tail/<j>/<kind>/<name>`` (``attn`` for either attention kind)."""
    n_scan, n_pat = scanned_layers(cfg), len(cfg.block_pattern)
    out = {k: k for k in cache if k != "layers"}
    out["layers"] = []
    for i, (kind, slot) in enumerate(zip(cfg.kinds(), cache["layers"])):
        group = "attn" if kind.startswith("attn") else kind
        at = f"blocks/p{i % n_pat}" if i < n_scan else f"tail/{i - n_scan}"
        out["layers"].append({name: f"{at}/{group}/{name}" for name in slot})
    return out


def cache_specs(cache: Any, mesh, cfg: ModelConfig):
    """KV caches: batch over dp when divisible; otherwise (long-context,
    batch=1) the sequence dim is sharded over (data, model) — sequence
    parallelism for decode.  Recurrent state: batch over dp, feature over
    model when divisible.  ``idx`` replicated."""
    dp = dp_axes(mesh)
    ndp = axis_size(mesh, dp)
    dp_name = dp if len(dp) > 1 else dp[0]

    def one(leaf, ps):
        core = tuple(np.shape(leaf))
        if ps.endswith("idx") or not core:
            return P(*([None] * len(core)))
        B = core[0]
        spec: list = [None] * len(core)
        if B % ndp == 0 and B >= ndp:
            spec[0] = dp_name
            if len(core) == 4 and _div(core[1], mesh, "model"):      # (B,S,H,hd)
                spec[1] = "model"
            elif len(core) >= 2 and _div(core[-1], mesh, "model"):
                spec[-1] = "model"
        else:
            # batch too small: shard the biggest dim over everything divisible
            if len(core) == 4:                                        # (B,S,H,hd)
                both = tuple(dp) + ("model",)
                if core[1] % axis_size(mesh, both) == 0:
                    spec[1] = both
                elif _div(core[1], mesh, "data"):
                    spec[1] = "data"
            elif len(core) >= 2 and _div(core[-1], mesh, "model"):
                spec[-1] = "model"
        return P(*spec)

    return map_tree(one, cache, _cache_paths(cache, cfg))


def _spec_leaves(tree) -> list:
    """The specs of a spec tree in leaf order (a spec is a tuple, which
    :mod:`repro_torch.tree` would walk into)."""
    if isinstance(tree, P):
        return [tree]
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in _spec_leaves(tree[k])]
    return [s for sub in tree for s in _spec_leaves(sub)]


def opt_state_specs(param_spec_tree, opt_state):
    """The reference's rule, kept for parity: each array leaf of
    ``opt_state`` gets the first parameter spec of its rank (in leaf
    order), not its own parameter's (ROADMAP C-ref 16); scalars and ranks
    no parameter has are replicated.  The Trainer does not use it: it
    shards each moment by its own parameter's spec."""
    flat_specs = _spec_leaves(param_spec_tree)

    def one(leaf):
        ndim = len(np.shape(leaf))
        cand = next((s for s in flat_specs if len(s) == ndim), None)
        return cand if cand is not None else P(*([None] * ndim))

    return map_tree(one, opt_state)


# --------------------------------------------------------------------------
# specs on a DeviceMesh: placements, slices and DTensors
# --------------------------------------------------------------------------
def _names(entry) -> tuple:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def placements(spec: Sequence, mesh) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on each
    mesh dimension that tensor dimension ``d`` names, ``Replicate()`` on
    the others.  A dimension split over several names must name them in
    the mesh's order (the first outermost, as DTensor splits)."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        idx = [names.index(a) for a in _names(entry) if a in names]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: {entry} is not in the mesh's order {names}")
        for k in idx:
            out[k] = Shard(d)
    return tuple(out)


def spec_of(x) -> P:
    """The spec of a DTensor's placements (the inverse of
    :func:`placements`); a plain tensor's is all None."""
    from torch.distributed.tensor import DTensor, Shard

    if not isinstance(x, DTensor):
        return P(*([None] * x.dim()))
    entries: list = [()] * x.dim()
    for name, pl in zip(x.device_mesh.mesh_dim_names, x.placements):
        if isinstance(pl, Shard):
            entries[pl.dim] = entries[pl.dim] + (name,)
    return P(*[None if not e else e[0] if len(e) == 1 else e for e in entries])


def local_slice(full, spec: Sequence, mesh):
    """This rank's block of ``full`` (a tensor or numpy array) under
    ``spec``: for each dimension, the block at this rank's index among the
    named mesh dimensions (row-major in their order)."""
    names = tuple(mesh.mesh_dim_names)
    index = []
    for d, entry in enumerate(spec):
        axes = [a for a in _names(entry) if a in names]
        n = math.prod(mesh.size(names.index(a)) for a in axes)
        if n == 1:
            index.append(slice(None))
            continue
        i = 0
        for a in axes:
            i = i * mesh.size(names.index(a)) + mesh.get_local_rank(a)
        size = full.shape[d]
        if size % n:
            raise ValueError(f"dimension {d} of {tuple(full.shape)} does not "
                             f"split over {axes} ({n} ranks)")
        index.append(slice(i * (size // n), (i + 1) * (size // n)))
    return full[tuple(index)]


def shard(full: torch.Tensor, spec: Sequence, mesh):
    """``full`` (the same on every rank) as a DTensor on ``mesh`` that
    holds this rank's block under ``spec``; no collective."""
    from torch.distributed.tensor import DTensor

    local = local_slice(full, spec, mesh).contiguous()
    return DTensor.from_local(local, mesh, placements(spec, mesh),
                              run_check=False, shape=full.shape,
                              stride=full.contiguous().stride())


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh, where a restore puts a leaf
    (``CheckpointManager.restore(shardings=...)``)."""
    mesh: Any
    spec: P

    def shard(self, full: torch.Tensor):
        return shard(full, self.spec, self.mesh)


def shard_params(params, mesh, cfg: ModelConfig,
                 policy: "ShardingPolicy" = None):
    """``params`` (full, the same on every rank) as DTensors on ``mesh``
    under :func:`param_specs`: each rank keeps its blocks."""
    specs = param_specs(params, mesh, cfg, policy)
    return map_tree(lambda p, s: shard(p, s, mesh), params, specs)
