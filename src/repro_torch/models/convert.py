"""Carry the JAX package's model parameters into the port.

The JAX ``Model.init`` returns a pytree whose scanned blocks are stacked on
a leading ``reps`` axis (``params["blocks"]["p<pos>"]``) with the pattern's
remainder in ``params["tail"]``.  :func:`from_jax` takes that pytree as
numpy arrays (``jax.tree.map(np.asarray, params)``) and returns the port's
parameters: one entry per layer, in layer order (the pattern's full
repetitions, then its tail; an MoE layer's expert stacks ``(E, D, F)``;
whisper's decoder blocks with their ``xattn``), whisper's encoder blocks
(``params["encoder"]["blocks"]["p0"]``, stacked over ``encoder_layers``)
as ``{"layers": [...], "ln"}``, paligemma's ``patch_proj`` and the
embedding's untied ``out`` table where there are, weights in the compute
dtype and the ``F32_LEAVES`` in f32, on ``device`` (the card unless the
caller asks for ``"cpu"``, as every entry point of the port).  With
``masters=True`` every leaf stays f32, as the JAX package's master weights;
a JAX gradient tree, which has the parameters' structure, is carried
across the same way.

:func:`jax_ndims` gives each leaf of a port tree the rank its leaf has in
the JAX layout: one more for a leaf of a scanned layer (the stacked
``reps`` axis, and the encoder's stacked blocks), which decides what the
JAX train step casts to the compute dtype (``p.ndim >= 2``).
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels.backend import resolve_device
from .config import ModelConfig
from .model import DTYPES, check_supported

__all__ = ["from_jax", "jax_ndims", "jax_paths", "scanned_layers"]

# leaves the JAX package uses in f32 whatever the compute dtype: norm
# scales, the RG-LRU's lam and the sLSTM's recurrent matrices
F32_LEAVES = ("scale", "lam", "rz", "ri", "rf", "ro")


def _tensors(tree, dtype: torch.dtype, device, *, rep=None):
    """``tree`` with every array (its ``rep``-th slice when given) as a
    tensor: the ``F32_LEAVES`` f32, all others ``dtype``."""
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out[key] = _tensors(val, dtype, device, rep=rep)
            continue
        t = torch.from_numpy(np.array(val if rep is None else val[rep],
                                      dtype=np.float32))
        out[key] = t.to(device, torch.float32 if key in F32_LEAVES else dtype)
    return out


def from_jax(params: dict, cfg: ModelConfig, *, device="cuda",
             masters: bool = False) -> dict:
    check_supported(cfg)
    device = resolve_device(device)
    dtype = torch.float32 if masters else DTYPES[cfg.dtype]
    P = len(cfg.block_pattern)
    layers = [_tensors(params["blocks"][f"p{i % P}"], dtype, device, rep=i // P)
              for i in range(scanned_layers(cfg))]
    layers += [_tensors(block, dtype, device) for block in params["tail"]]
    if len(layers) != cfg.num_layers:
        raise ValueError(f"{len(layers)} layers in the pytree, config has "
                         f"{cfg.num_layers}")
    out = {"embed": _tensors(params["embed"], dtype, device),
           "final_ln": _tensors(params["final_ln"], dtype, device),
           "layers": layers}
    if "encoder" in params:
        enc = params["encoder"]
        reps = len(enc["blocks"]["p0"]["mix"]["ln"]["scale"])
        if reps != cfg.encoder_layers:
            raise ValueError(f"{reps} encoder layers in the pytree, config has "
                             f"{cfg.encoder_layers}")
        out["encoder"] = {"layers": [_tensors(enc["blocks"]["p0"], dtype, device, rep=r)
                                     for r in range(reps)],
                          "ln": _tensors(enc["ln"], dtype, device)}
    if "patch_proj" in params:
        out["patch_proj"] = _tensors(params["patch_proj"], dtype, device)
    return out


def scanned_layers(cfg: ModelConfig) -> int:
    """How many of the decoder's layers (the first ones) the JAX package
    stacks and scans: its whole pattern repetitions."""
    return cfg.num_layers // len(cfg.block_pattern) * len(cfg.block_pattern)


def jax_ndims(params: dict, cfg: ModelConfig) -> dict:
    """``params``' structure with each leaf's rank in the JAX layout: the
    port's rank, plus one in a scanned decoder layer and in every encoder
    layer."""
    def ranks(tree, extra):
        if isinstance(tree, dict):
            return {k: ranks(v, extra) for k, v in tree.items()}
        return tree.dim() + extra

    n_scan = scanned_layers(cfg)
    out = {k: ranks(v, 0) for k, v in params.items() if k not in ("layers", "encoder")}
    out["layers"] = [ranks(lp, int(i < n_scan)) for i, lp in enumerate(params["layers"])]
    if "encoder" in params:
        out["encoder"] = {"layers": [ranks(lp, 1) for lp in params["encoder"]["layers"]],
                          "ln": ranks(params["encoder"]["ln"], 0)}
    return out


def jax_paths(params: dict, cfg: ModelConfig) -> dict:
    """``params``' structure with each leaf's path in the JAX package's
    tree, ``/``-joined as its sharding rules read it: a scanned layer's
    leaves under ``blocks/p<pos>/``, a tail layer's under ``tail/<j>/``,
    the encoder's layers under ``encoder/blocks/p0/``."""
    def paths(tree, prefix):
        if isinstance(tree, dict):
            return {k: paths(v, f"{prefix}/{k}" if prefix else k)
                    for k, v in tree.items()}
        return prefix

    n_scan, n_pat = scanned_layers(cfg), len(cfg.block_pattern)
    out = {k: paths(v, k) for k, v in params.items() if k not in ("layers", "encoder")}
    out["layers"] = [paths(lp, f"blocks/p{i % n_pat}" if i < n_scan
                           else f"tail/{i - n_scan}")
                     for i, lp in enumerate(params["layers"])]
    if "encoder" in params:
        out["encoder"] = {"layers": [paths(lp, "encoder/blocks/p0")
                                     for lp in params["encoder"]["layers"]],
                          "ln": paths(params["encoder"]["ln"], "encoder/ln")}
    return out
