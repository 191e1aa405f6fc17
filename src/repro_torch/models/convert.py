"""Carry the JAX package's model parameters into the port.

The JAX ``Model.init`` returns a pytree whose scanned blocks are stacked on
a leading ``reps`` axis (``params["blocks"]["p<pos>"]``) with the pattern's
remainder in ``params["tail"]``.  :func:`from_jax` takes that pytree as
numpy arrays (``jax.tree.map(np.asarray, params)``) and returns the port's
parameters: one entry per layer, in layer order (the pattern's full
repetitions, then its tail; an MoE layer's expert stacks ``(E, D, F)``),
weights in the compute dtype and the ``F32_LEAVES`` in f32, on ``device``
(the card unless the caller asks for ``"cpu"``, as every entry point of
the port).
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels.backend import resolve_device
from .config import ModelConfig
from .model import DTYPES, check_supported

__all__ = ["from_jax"]

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


def from_jax(params: dict, cfg: ModelConfig, *, device="cuda") -> dict:
    check_supported(cfg)
    device = resolve_device(device)
    dtype = DTYPES[cfg.dtype]
    pattern = cfg.block_pattern
    reps = cfg.num_layers // len(pattern)
    layers = [_tensors(params["blocks"][f"p{pos}"], dtype, device, rep=r)
              for r in range(reps) for pos in range(len(pattern))]
    layers += [_tensors(block, dtype, device) for block in params["tail"]]
    if len(layers) != cfg.num_layers:
        raise ValueError(f"{len(layers)} layers in the pytree, config has "
                         f"{cfg.num_layers}")
    return {"embed": _tensors(params["embed"], dtype, device),
            "final_ln": _tensors(params["final_ln"], dtype, device),
            "layers": layers}
