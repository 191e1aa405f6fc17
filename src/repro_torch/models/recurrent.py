"""Recurrent blocks of the port's LM path: the RG-LRU block of
RecurrentGemma / Griffin and the mLSTM and sLSTM blocks of xLSTM (the JAX
package's ``models/recurrent.py``), in torch.

RG-LRU prefill runs the gated recurrence ``h_t = a_t h_{t-1} + x_t``
through :func:`repro_torch.core.recurrence.linear_recurrence` with
``method="doubling"``: the paper's equation rewriting taken to a fixpoint on
the chain matrix.  The mLSTM prefills chunkwise-parallel (a quasi-attention
inside each chunk of 256 steps, a scan of the matrix state across chunks,
stabilised in f32 with ``-1e30`` as the empty state's log scale); the sLSTM
is sequential (one step of its scalar memory per position, a Python loop,
as the JAX package's ``lax.scan``).  Decode takes one step of each from the
cached state, which it updates in place.  The casts follow the JAX
package: gates and states in f32, the block's input, output and the
depthwise convolution in the compute dtype; ``lam`` and the sLSTM's
recurrent matrices ``rz`` / ``ri`` / ``rf`` / ``ro`` stay f32; the
convolution's cached state is bf16 (the model's cache).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..core.recurrence import linear_recurrence
from .config import ModelConfig
from .layers import Init, dense, init_dense, init_rms_norm, rms_norm

__all__ = [
    "init_rglru_block", "rglru_block_apply", "rglru_block_decode",
    "init_mlstm_block", "mlstm_block_apply", "mlstm_block_decode",
    "init_slstm_block", "slstm_block_apply", "slstm_block_decode",
]

RGLRU_C = 8.0
# the mLSTM's prefill chunk up to 16,384 steps; past that the prompt is cut
# into UNROLL_LIMIT chunks (the JAX package's runtime_flags.UNROLL_LIMIT)
MLSTM_CHUNK = 256
UNROLL_LIMIT = 64
# the log scale of an empty mLSTM / sLSTM state
NEG_STATE = -1e30


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


# --------------------------------------------------------------------------
# mLSTM block (xLSTM): matrix memory, chunkwise-parallel prefill
# --------------------------------------------------------------------------

def init_mlstm_block(init: Init, cfg: ModelConfig) -> dict:
    D = cfg.d_model
    Din = 2 * D                 # pf=2 up-projection
    H = cfg.n_state_heads
    return {
        "ln": init_rms_norm(init, D),
        "up": init_dense(init, D, 2 * Din),        # (inner, gate)
        "conv": init_conv(init, Din, cfg.conv_width),
        "q": init_dense(init, Din, (H, Din // H)),
        "k": init_dense(init, Din, (H, Din // H)),
        "v": init_dense(init, Din, (H, Din // H)),
        "ig": init_dense(init, Din, H),            # log-space input gate
        "fg": init_dense(init, Din, H),            # forget gate (pre-sigmoid)
        "down": init_dense(init, Din, D, scale=Din ** -0.5),
        "skip": init_dense(init, Din, Din),
    }


def mlstm_qkv(params: dict, xi: torch.Tensor):
    """``q``, ``k`` (scaled by ``d^-1/2``), ``v`` ``(B, S, H, d)`` in the
    compute dtype and the log input and forget gates ``(B, S, H)`` f32."""
    q = dense(params["q"], xi)
    k = dense(params["k"], xi) * params["q"]["w"].shape[-1] ** -0.5
    v = dense(params["v"], xi)
    li = dense(params["ig"], xi).float()                        # log i_t
    lf = F.logsigmoid(dense(params["fg"], xi).float())          # log f_t
    return q, k, v, li, lf


def mlstm_chunk_scan(q, k, v, li, lf, chunk: int, state=None):
    """The chunkwise-parallel stabilised mLSTM over ``S`` steps in chunks of
    ``W = min(chunk, S)``: ``q``, ``k``, ``v`` ``(B, S, H, d)``, ``li``,
    ``lf`` ``(B, S, H)``, ``state`` ``(C (B, H, d, d), n (B, H, d), m (B,
    H))`` or an empty one.  Returns ``h`` ``(B, S, H, d)`` f32 and the state
    after the last step.  Raises ``ValueError`` unless ``W`` divides ``S``
    (the JAX package asserts it)."""
    B, S, H, d = q.shape
    W = min(chunk, S)
    if S % W:
        raise ValueError(f"the mLSTM's chunkwise scan needs S % min(chunk, S) "
                         f"== 0: a prompt of {S} steps in chunks of {W}")
    nc = S // W
    qc, kc, vc = (t.reshape(B, nc, W, H, d).float() for t in (q, k, v))
    lic, lfc = li.reshape(B, nc, W, H), lf.reshape(B, nc, W, H)
    if state is None:
        C0 = q.new_zeros((B, H, d, d), dtype=torch.float32)
        n0 = q.new_zeros((B, H, d), dtype=torch.float32)
        m0 = q.new_full((B, H), NEG_STATE, dtype=torch.float32)
    else:
        C0, n0, m0 = state
    tri = torch.tril(torch.ones((W, W), dtype=torch.bool, device=q.device))
    hs = []
    for c in range(nc):
        qw, kw, vw, liw, lfw = qc[:, c], kc[:, c], vc[:, c], lic[:, c], lfc[:, c]
        b = torch.cumsum(lfw, dim=1)                      # (B, W, H) log-forget
        # intra-chunk log weights D[t, s] = b_t - b_s + li_s (s <= t)
        Dm = b[:, :, None] - b[:, None, :, :] + liw[:, None]      # (B, W, W, H)
        Dm = torch.where(tri[None, :, :, None], Dm, NEG_STATE)
        m_t = torch.maximum(b + m0[:, None], Dm.amax(dim=2))      # (B, W, H)
        m_t = torch.clamp(m_t, min=NEG_STATE)
        wgt = torch.exp(Dm - m_t[:, :, None])
        ws = wgt * torch.einsum("bthd,bshd->btsh", qw, kw)
        inter_scale = torch.exp(b + m0[:, None] - m_t)            # (B, W, H)
        h_num = (torch.einsum("btsh,bshd->bthd", ws, vw)
                 + inter_scale[..., None] * torch.einsum("bhde,bthd->bthe", C0, qw))
        # the denominator: n_t . q_t with the same weights
        n_q = ws.sum(dim=2) + inter_scale * torch.einsum("bhd,bthd->bth", n0, qw)
        denom = torch.maximum(n_q.abs(), torch.exp(-m_t))
        hs.append(h_num / denom[..., None])
        # the state at the chunk's end
        bW = b[:, -1]                                             # (B, H)
        m_end = torch.maximum(bW + m0, (bW[:, None] - b + liw).amax(dim=1))
        g_in = torch.exp(bW[:, None] - b + liw - m_end[:, None])  # (B, W, H)
        decay = torch.exp(bW + m0 - m_end)
        C0 = (decay[:, :, None, None] * C0
              + torch.einsum("bwh,bwhd,bwhe->bhde", g_in, kw, vw))
        n0 = decay[:, :, None] * n0 + torch.einsum("bwh,bwhd->bhd", g_in, kw)
        m0 = m_end
    return torch.stack(hs, dim=1).reshape(B, S, H, d), (C0, n0, m0)


def mlstm_block_apply(params: dict, cfg: ModelConfig, x: torch.Tensor, *,
                      chunk: int = 0, return_state: bool = False):
    """``x`` ``(B, S, D)`` → ``(B, S, D)`` with the residual; ``chunk`` 0
    picks 256, or ``S / UNROLL_LIMIT`` past 16,384 steps.  With
    ``return_state`` also the decode state after the last position: ``((C,
    n, m), conv (B, W-1, 2D))``."""
    B, S, D = x.shape
    if chunk == 0:
        chunk = MLSTM_CHUNK if S <= 16384 else -(-S // UNROLL_LIMIT)
    h = rms_norm(params["ln"], x)
    xi, gate = torch.chunk(dense(params["up"], h), 2, dim=-1)
    xi, conv_state = causal_conv(params["conv"], xi)
    xi = F.silu(xi)
    q, k, v, li, lf = mlstm_qkv(params, xi)
    hh, state = mlstm_chunk_scan(q, k, v, li, lf, chunk)
    H, d = q.shape[2], q.shape[3]
    y = hh.to(x.dtype).reshape(B, S, H * d) + dense(params["skip"], xi)
    out = x + dense(params["down"], y * F.silu(gate))
    if not return_state:
        return out
    # the JAX prefill's state (_mlstm_state_from_prefill, model.py:505-518)
    # is a scan of chunk min(256, S), or of 1 where that does not divide S:
    # this scan's whenever chunk was left at 0 (the scan above refuses the
    # prompts the fallback is for), a second scan otherwise
    sc = min(MLSTM_CHUNK, S) if S <= 16384 else -(-S // UNROLL_LIMIT)
    if S % sc:
        sc = 1
    if sc != min(chunk, S):
        _, state = mlstm_chunk_scan(q, k, v, li, lf, sc)
    return out, (state, conv_state)


def mlstm_block_decode(params: dict, cfg: ModelConfig, x: torch.Tensor,
                       cache: dict) -> torch.Tensor:
    """One step ``x`` ``(B, 1, D)`` from ``cache`` ``{"C": (B, H, d, d),
    "n": (B, H, d), "m": (B, H)`` f32, ``"conv": (B, W-1, 2D)}``, which it
    updates in place."""
    B = x.shape[0]
    h = rms_norm(params["ln"], x)
    xi, gate = torch.chunk(dense(params["up"], h), 2, dim=-1)
    xi, conv_state = causal_conv(params["conv"], xi, cache["conv"])
    xi = F.silu(xi)
    q, k, v, li, lf = mlstm_qkv(params, xi)
    q0, k0, v0 = (t[:, 0].float() for t in (q, k, v))          # (B, H, d)
    li0, lf0 = li[:, 0], lf[:, 0]                              # (B, H)
    C, n, m = cache["C"], cache["n"], cache["m"]
    m_new = torch.maximum(lf0 + m, li0)
    fs = torch.exp(lf0 + m - m_new)
    is_ = torch.exp(li0 - m_new)
    C1 = fs[..., None, None] * C + is_[..., None, None] * torch.einsum(
        "bhd,bhe->bhde", k0, v0)
    n1 = fs[..., None] * n + is_[..., None] * k0
    num = torch.einsum("bhde,bhd->bhe", C1, q0)
    den = torch.maximum(torch.einsum("bhd,bhd->bh", n1, q0).abs(), torch.exp(-m_new))
    hh = (num / den[..., None]).to(x.dtype)                    # (B, H, d)
    y = hh.reshape(B, 1, -1) + dense(params["skip"], xi)
    out = x + dense(params["down"], y * F.silu(gate))
    C.copy_(C1)
    n.copy_(n1)
    m.copy_(m_new)
    cache["conv"].copy_(conv_state)
    return out


# --------------------------------------------------------------------------
# sLSTM block (xLSTM): scalar memory, sequential
# --------------------------------------------------------------------------

def init_slstm_block(init: Init, cfg: ModelConfig) -> dict:
    D = cfg.d_model
    H = cfg.n_state_heads
    dh = D // H
    Fd = int(D * 4 / 3) // 8 * 8        # pf = 4/3 post-FFN

    def recurrent():    # one (dh, dh) block per head, f32 as in JAX
        return init.normal((H, dh, dh), dh ** -0.5, torch.float32)

    return {
        "ln": init_rms_norm(init, D),
        "conv": init_conv(init, D, cfg.conv_width),
        "wz": init_dense(init, D, D),
        "wi": init_dense(init, D, D),
        "wf": init_dense(init, D, D),
        "wo": init_dense(init, D, D),
        "rz": recurrent(), "ri": recurrent(), "rf": recurrent(), "ro": recurrent(),
        "gn": init_rms_norm(init, D),
        "ffn": {"wi": init_dense(init, D, Fd),
                "wo": init_dense(init, Fd, D, scale=Fd ** -0.5)},
    }


def _slstm_recurrent(params: dict) -> torch.Tensor:
    """``rz``, ``ri``, ``rf``, ``ro`` side by side ``(H, dh, 4 dh)`` f32: one
    product a step for the four gates' recurrent terms (a train step that
    casts them to bf16 gets them back in f32, as JAX's promotion of its
    bf16 x f32 einsum)."""
    return torch.cat([params[n] for n in ("rz", "ri", "rf", "ro")], dim=-1).float()


def slstm_cell(R: torch.Tensor, pre: torch.Tensor, carry):
    """One step.  ``R`` from :func:`_slstm_recurrent`; ``pre`` ``(B, 4, D)``
    the z, i, f, o pre-activations from the inputs; ``carry`` ``(c, n, m,
    h)`` each ``(B, D)`` f32."""
    c, n, m, h = carry
    B, D = h.shape
    H, dh = R.shape[0], R.shape[1]
    rec = torch.einsum("bhd,hde->bhe", h.reshape(B, H, dh), R)    # (B, H, 4 dh)
    g = pre + rec.reshape(B, H, 4, dh).transpose(1, 2).reshape(B, 4, D)
    z = torch.tanh(g[:, 0])
    li = g[:, 1]                                    # log-space input gate
    lf = F.logsigmoid(g[:, 2])
    o = torch.sigmoid(g[:, 3])
    m_new = torch.maximum(lf + m, li)
    i_ = torch.exp(li - m_new)
    f_ = torch.exp(lf + m - m_new)
    c_new = f_ * c + i_ * z
    n_new = f_ * n + i_
    return c_new, n_new, m_new, o * c_new / torch.clamp(n_new, min=1e-6)


def _slstm_pre(params: dict, h0: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The gates' input terms ``(B, S, 4, D)`` f32: z and o from the normed
    input, i and f from the convolution."""
    return torch.stack([dense(params["wz"], h0), dense(params["wi"], u),
                        dense(params["wf"], u), dense(params["wo"], h0)],
                       dim=2).float()


def _slstm_out(params: dict, x: torch.Tensor, hs: torch.Tensor) -> torch.Tensor:
    """The group norm of the cell's outputs, the residual, then the gated
    FFN (pf = 4/3, tanh gelu as ``jax.nn.gelu``) and its residual."""
    x = x + rms_norm(params["gn"], hs.to(x.dtype))
    f = dense(params["ffn"]["wo"],
              F.gelu(dense(params["ffn"]["wi"], x), approximate="tanh"))
    return x + f


def slstm_block_apply(params: dict, cfg: ModelConfig, x: torch.Tensor, *,
                      return_state: bool = False):
    """``x`` ``(B, S, D)`` → ``(B, S, D)``, one cell step per position; with
    ``return_state`` also the decode state after the last position:
    ``((c, n, m, h) (B, D) f32, conv (B, W-1, D))``."""
    B, S, D = x.shape
    h0 = rms_norm(params["ln"], x)
    u, conv_state = causal_conv(params["conv"], h0)
    pre = _slstm_pre(params, h0, F.silu(u))
    R = _slstm_recurrent(params)
    zero = x.new_zeros((B, D), dtype=torch.float32)
    carry = (zero, zero, torch.full_like(zero, NEG_STATE), zero)
    hs = []
    for t in range(S):
        carry = slstm_cell(R, pre[:, t], carry)
        hs.append(carry[3])
    out = _slstm_out(params, x, torch.stack(hs, dim=1))
    return (out, (carry, conv_state)) if return_state else out


def slstm_block_decode(params: dict, cfg: ModelConfig, x: torch.Tensor,
                       cache: dict) -> torch.Tensor:
    """One step ``x`` ``(B, 1, D)`` from ``cache`` ``{"c", "n", "m", "h":
    (B, D) f32, "conv": (B, W-1, D)}``, which it updates in place."""
    h0 = rms_norm(params["ln"], x)
    u, conv_state = causal_conv(params["conv"], h0, cache["conv"])
    pre = _slstm_pre(params, h0, F.silu(u))[:, 0]
    carry = slstm_cell(_slstm_recurrent(params), pre,
                       tuple(cache[n] for n in ("c", "n", "m", "h")))
    for name, t in zip(("c", "n", "m", "h"), carry):
        cache[name].copy_(t)
    cache["conv"].copy_(conv_state)
    return _slstm_out(params, x, carry[3][:, None])
