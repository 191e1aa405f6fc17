"""Recurrent blocks of the port's LM path: the RG-LRU block of
RecurrentGemma / Griffin (the JAX package's ``models/recurrent.py``, its
RG-LRU part), in torch.

Prefill runs the gated recurrence ``h_t = a_t h_{t-1} + x_t`` through
:func:`repro_torch.core.recurrence.linear_recurrence` with
``method="doubling"``: the paper's equation rewriting taken to a fixpoint on
the chain matrix.  Decode takes one step of it from the cached state.  The
casts follow the JAX package: the gates and the state in f32, the block's
input, output and the depthwise convolution in the compute dtype; ``lam``
stays f32.  The xLSTM blocks (mLSTM, sLSTM) are not ported yet:
:func:`repro_torch.models.model.check_supported` turns their configurations
away.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..core.recurrence import linear_recurrence
from .config import ModelConfig
from .layers import Init, dense, init_dense, init_rms_norm, rms_norm

__all__ = ["init_rglru_block", "rglru_block_apply", "rglru_block_decode"]

RGLRU_C = 8.0


# --------------------------------------------------------------------------
# causal depthwise temporal conv
# --------------------------------------------------------------------------

def init_conv(init: Init, d: int, width: int) -> dict:
    return {"w": init.normal((width, d), width ** -0.5),
            "b": init.zeros((d,), init.dtype)}


def causal_conv(p: dict, x: torch.Tensor, state: Optional[torch.Tensor] = None):
    """``x`` ``(B, S, d)``; ``state`` ``(B, W-1, d)`` carries the history in
    decode.  Returns ``(y, new state)``: the last ``W - 1`` inputs."""
    W = p["w"].shape[0]
    w = p["w"].to(x.dtype)
    if state is None:
        xp = F.pad(x, (0, 0, W - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    S = x.shape[1]
    y = sum(xp[:, k:k + S] * w[k] for k in range(W))
    return y + p["b"].to(x.dtype), xp[:, -(W - 1):]


# --------------------------------------------------------------------------
# RG-LRU block (Griffin recurrent block)
# --------------------------------------------------------------------------

def init_rglru_block(init: Init, cfg: ModelConfig) -> dict:
    D = cfg.d_model
    R = cfg.d_rnn or D
    if init.device.type == "meta":
        lam = torch.empty((R,), dtype=torch.float32, device="meta")
    else:   # a = sigmoid(lam) spread over [0.9, 0.999], as the JAX init
        a = np.linspace(0.9, 0.999, R)
        lam = torch.from_numpy(np.log(a / (1 - a)).astype(np.float32)).to(init.device)
    return {
        "ln": init_rms_norm(init, D),
        "in_x": init_dense(init, D, R),
        "in_gate": init_dense(init, D, R),
        "conv": init_conv(init, R, cfg.conv_width),
        "w_a": init_dense(init, R, R),          # recurrence gate
        "w_i": init_dense(init, R, R),          # input gate
        "lam": lam,
        "out": init_dense(init, R, D, scale=R ** -0.5),
    }


def rglru_gates(p: dict, u: torch.Tensor):
    """``u`` ``(..., R)``, the conv output → ``(log a, gated input)``, both
    f32."""
    r = torch.sigmoid(dense(p["w_a"], u).float())
    i = torch.sigmoid(dense(p["w_i"], u).float())
    log_a = -RGLRU_C * r * F.softplus(p["lam"])          # log a_t (< 0)
    x_in = i * u.float()
    mult = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    return log_a, mult * x_in


def rglru_block_apply(params: dict, cfg: ModelConfig, x: torch.Tensor, *,
                      return_state: bool = False):
    """``x`` ``(B, S, D)`` → ``(B, S, D)`` with the residual; with
    ``return_state`` also the decode state after the last position:
    ``(h (B, R) f32, conv (B, W-1, R))``."""
    h = rms_norm(params["ln"], x)
    gate = F.gelu(dense(params["in_gate"], h), approximate="tanh")
    u, conv_state = causal_conv(params["conv"], dense(params["in_x"], h))
    log_a, xin = rglru_gates(params, u)
    hs = linear_recurrence(torch.exp(log_a), xin, method="doubling", axis=1)
    out = x + dense(params["out"], hs.to(x.dtype) * gate)
    return (out, (hs[:, -1], conv_state)) if return_state else out


def rglru_block_decode(params: dict, cfg: ModelConfig, x: torch.Tensor,
                       cache: dict) -> torch.Tensor:
    """One step ``x`` ``(B, 1, D)`` from ``cache`` ``{"h": (B, R) f32,
    "conv": (B, W-1, R)}``, which it updates in place (the conv state
    rounded to the cache's dtype)."""
    h = rms_norm(params["ln"], x)
    gate = F.gelu(dense(params["in_gate"], h), approximate="tanh")
    u, conv_state = causal_conv(params["conv"], dense(params["in_x"], h),
                                cache["conv"])
    log_a, xin = rglru_gates(params, u)
    h_new = torch.exp(log_a[:, 0]) * cache["h"] + xin[:, 0]       # (B, R)
    cache["h"].copy_(h_new)
    cache["conv"].copy_(conv_state)
    return x + dense(params["out"], h_new[:, None].to(x.dtype) * gate)
