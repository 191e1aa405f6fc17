"""Mixture of experts of the port's LM path: the JAX package's
``models/moe.py`` in torch.

A softmax top-k router (ties to the lower expert id, as ``lax.top_k``);
the sort-based dispatch of the JAX package, which packs each (token,
choice) pair into its expert's capacity buffer ``(E, C + 1, D)`` by a
stable argsort (row ``C`` takes the pairs past capacity and is
discarded); the experts as batched products; the gated combine; and the
Switch auxiliary loss.  Two paths share that dispatch:

* local (``mesh=None``): every expert on this device and no collective.
  Prefill takes it without a mesh, and every decode step takes it, as in
  the JAX package.
* expert parallel (``mesh=`` a ``DeviceMesh`` of
  :mod:`repro_torch.launch.mesh` with an ``"model"`` dimension): the JAX
  ``shard_map`` region (``moe.py:120-174``) on ``torch.distributed``.  Each
  rank holds its batch shard and the expert slices :func:`shard_moe_params`
  gives it: experts split over ``"model"``, and FSDP-sharded over
  ``"data"``, which an ``all_gather`` undoes in the block.  Each rank sends
  every expert's capacity buffer to the rank that holds the expert and
  gets the outputs back (two ``all_to_all``), then averages ``aux`` over
  data, then over model.  The collectives carry gradients
  (:mod:`repro_torch.distributed.collectives`): ``x``'s is this rank's
  tokens' own, the router's this rank's share (the caller sums it over the
  batch axes), and an expert slice's the whole gradient of that slice —
  summed over the FSDP axis by the gather's reduce-scatter, and the mean
  over the ``"model"`` ranks of a data row, which send the experts the same
  tokens.

llama4-scout adds a shared (always-on) expert and arctic a parallel dense
MLP: plain MLPs on the MoE's normed input, outside the expert region, each
normed again by its own ``ln`` as in the JAX package.

The JAX package computes the experts as einsums outside any Pallas kernel;
here they are ``torch.bmm`` in the compute dtype.  The combine adds a
token's ``top_k`` outputs in the compute dtype with ``index_add_``; for
``top_k <= 2`` that sum does not depend on the order.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..core.dist import axis_size
from ..distributed.collectives import all_gather, all_reduce, all_to_all, scale_grad
from .config import ModelConfig
from .layers import Init, dense, init_dense, init_mlp, init_rms_norm, mlp_apply, rms_norm

__all__ = ["init_moe", "moe_apply", "shard_moe_params", "capacity",
           "dispatch_indices", "top_k", "expert_ffn"]


def init_moe(init: Init, cfg: ModelConfig) -> dict:
    """The router, the stacked experts ``wi`` / ``wg`` ``(E, D, F)`` and
    ``wo`` ``(E, F, D)`` (drawn one expert at a time), and the shared
    expert or the dense MLP where ``cfg`` has one."""
    D, Fd, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {
        "ln": init_rms_norm(init, D),
        "router": init_dense(init, D, E),
        "wi": init.stacked(E, (D, Fd), D ** -0.5),
        "wg": init.stacked(E, (D, Fd), D ** -0.5),
        "wo": init.stacked(E, (Fd, D), Fd ** -0.5),
    }
    if cfg.shared_expert:
        p["shared"] = init_mlp(init, cfg)
    if cfg.moe_dense_residual:
        p["dense_mlp"] = init_mlp(init, cfg)
    return p


def capacity(tokens: int, cfg: ModelConfig) -> int:
    """Slots per expert for ``tokens`` routed tokens: ``tokens * top_k / E``
    times the capacity factor, rounded up to a multiple of 8, at least 8."""
    c = math.ceil(tokens * cfg.top_k / cfg.n_experts * cfg.capacity_factor)
    return max(8, -(-c // 8) * 8)


def dispatch_indices(eid: torch.Tensor, capacity: int) -> torch.Tensor:
    """``eid`` ``(N,)``, the expert of each (token, choice) pair in token
    order → each pair's slot in its expert's buffer: its position among
    the pairs of that expert, or ``capacity`` (dropped) past it.  The sort
    is stable, so the earlier tokens keep their slots, as in JAX."""
    N = eid.shape[0]
    order = torch.argsort(eid, stable=True)
    se = eid[order].contiguous()
    pos = torch.arange(N, device=eid.device) - torch.searchsorted(se, se)
    slot = torch.empty_like(pos)
    slot[order] = torch.clamp(pos, max=capacity)
    return slot


def top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest of each row and their indices, in descending
    order with ties to the lower index, as ``lax.top_k`` (``torch.topk``
    promises no order among ties)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def expert_ffn(x: torch.Tensor, wi: torch.Tensor, wg: torch.Tensor,
               wo: torch.Tensor) -> torch.Tensor:
    """The SwiGLU experts, batched: ``x`` ``(E, C, D)`` → ``(E, C, D)`` in
    ``x``'s dtype."""
    dt = x.dtype
    h = torch.bmm(x, wg.to(dt))
    u = torch.bmm(x, wi.to(dt))
    return torch.bmm(F.silu(h) * u, wo.to(dt))


class _Routes:
    """One batch of tokens routed into capacity buffers: the pairs'
    experts, slots, tokens and gates, and the router's probabilities."""

    def __init__(self, params: dict, cfg: ModelConfig, x2: torch.Tensor, C: int):
        T = x2.shape[0]
        k = cfg.top_k
        probs = torch.softmax(dense(params["router"], x2).float(), dim=-1)  # (T, E)
        gate, eid = top_k(probs, k)
        self.gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
        self.probs = probs
        self.eflat = eid.reshape(-1)                                         # (T*k,)
        self.slot = dispatch_indices(self.eflat, C)
        self.src = torch.arange(T, device=x2.device).repeat_interleave(k)
        self.E, self.C, self.T, self.k = cfg.n_experts, C, T, k

    def pack(self, x2: torch.Tensor) -> torch.Tensor:
        """The capacity buffers ``(E, C, D)`` (the overflow row cut off)."""
        buf = x2.new_zeros((self.E, self.C + 1, x2.shape[1]))
        buf[self.eflat, self.slot] = x2[self.src]
        return buf[:, :self.C]

    def combine(self, y_buf: torch.Tensor) -> torch.Tensor:
        """The experts' outputs ``(E, C, D)`` → ``(T, D)``: each pair's
        output times its gate (a dropped pair's is 0), summed per token."""
        E, C, D = y_buf.shape
        y_buf = torch.cat([y_buf, y_buf.new_zeros((E, 1, D))], dim=1)
        y = y_buf[self.eflat, self.slot] * self.gate.reshape(-1, 1).to(y_buf.dtype)
        return y_buf.new_zeros((self.T, D)).index_add_(0, self.src, y)

    def aux(self) -> torch.Tensor:
        """The Switch loss ``E * sum_e f_e p_e``: ``f_e`` the share of pairs
        routed to expert ``e`` (dropped or not), ``p_e`` its mean
        probability."""
        ce = torch.zeros(self.E, dtype=torch.float32, device=self.probs.device)
        ce.index_add_(0, self.eflat, torch.ones_like(self.eflat, dtype=torch.float32))
        return self.E * torch.sum(self.probs.mean(0) * (ce / (self.T * self.k)))


def _moe_local(params: dict, cfg: ModelConfig, x2: torch.Tensor):
    """Every expert here: ``x2`` ``(T, D)`` → ``(y (T, D), aux)``."""
    routes = _Routes(params, cfg, x2, capacity(x2.shape[0], cfg))
    y_buf = expert_ffn(routes.pack(x2), params["wi"], params["wg"], params["wo"])
    return routes.combine(y_buf), routes.aux()


def _fsdp_axis(mesh, dp_axes) -> str:
    return "data" if "data" in mesh.mesh_dim_names else dp_axes[0]


def _gather_axis1(w: torch.Tensor, group) -> torch.Tensor:
    """The tiled all-gather of ``w`` ``(a, b, c)`` along axis 1 over
    ``group`` → ``(a, n * b, c)``, rank ``i``'s slice at ``[:, i*b:(i+1)*b]``.
    The collective concatenates along axis 0, so the gather lands in an
    ``(n, a, b, c)`` buffer whose axis is then moved.  Its gradient is the
    reduce-scatter: the sum over ``group``, this rank's slice."""
    n = dist.get_world_size(group)
    a, b, c = w.shape
    out = all_gather(w, group)
    return out.view(n, a, b, c).transpose(0, 1).reshape(a, n * b, c)


def _moe_ep(params: dict, cfg: ModelConfig, x2: torch.Tensor, mesh,
            dp_axes: tuple, ep_axis: str):
    """This rank's tokens ``x2`` ``(T, D)`` and expert slices → ``(y (T, D),
    aux replicated)``."""
    E, D = cfg.n_experts, x2.shape[1]
    ep = axis_size(mesh, ep_axis)
    el = E // ep
    fsdp = _fsdp_axis(mesh, dp_axes)
    if E % ep or params["wi"].shape[0] != el:
        raise ValueError(f"expert parallelism over {ep} ranks needs the "
                         f"expert slices of shard_moe_params ({E} experts, "
                         f"{el} a rank); got wi {tuple(params['wi'].shape)}")
    fsdp_group, ep_group = mesh.get_group(fsdp), mesh.get_group(ep_axis)
    # the FSDP all-gather of this layer's expert shards; the ep ranks of a
    # data row send the experts the same tokens, so each expert's gradient
    # is the mean over those ep copies
    wi, wg, wo = (scale_grad(_gather_axis1(params[n], fsdp_group), 1 / ep)
                  for n in ("wi", "wg", "wo"))
    routes = _Routes(params, cfg, x2, capacity(x2.shape[0], cfg))
    C = routes.C
    # dispatch: expert block j of every rank's buffer to rank j, which
    # stacks the ranks' tokens for its experts along the slots
    recv = all_to_all(routes.pack(x2).reshape(ep, el, C, D), ep_group)
    recv = recv.permute(1, 0, 2, 3).reshape(el, ep * C, D)
    y_loc = expert_ffn(recv, wi, wg, wo)                       # (el, ep*C, D)
    # and back: rank i's slots to rank i, stacked in expert order
    send = y_loc.reshape(el, ep, C, D).permute(1, 0, 2, 3)
    back = all_to_all(send, ep_group).reshape(E, C, D)
    aux = routes.aux()
    for axis in (*dp_axes, ep_axis):
        group = mesh.get_group(axis)
        aux = all_reduce(aux, group) / dist.get_world_size(group)
    return routes.combine(back), aux


def moe_apply(params: dict, cfg: ModelConfig, x: torch.Tensor, *,
              mesh=None, dp_axes: tuple = ("data",),
              ep_axis: str = "model") -> tuple[torch.Tensor, torch.Tensor]:
    """``x`` ``(B, S, D)`` → ``(x + the experts' output [+ the shared
    expert's or the dense MLP's], aux)``.  With a ``mesh`` that has
    ``ep_axis``, ``x`` is this rank's batch shard and ``params`` this rank's
    slices (:func:`shard_moe_params`); ``aux`` is then the mean over every
    rank."""
    B, S, D = x.shape
    h = rms_norm(params["ln"], x)
    if mesh is None or ep_axis not in (mesh.mesh_dim_names or ()):
        y, aux = _moe_local(params, cfg, h.reshape(B * S, D))
    else:
        y, aux = _moe_ep(params, cfg, h.reshape(B * S, D), mesh, tuple(dp_axes),
                         ep_axis)
    out = x + y.reshape(B, S, D)
    if "shared" in params:          # llama4: always-on shared expert
        out = out + mlp_apply(params["shared"], h, residual=False)
    if "dense_mlp" in params:       # arctic: parallel dense residual MLP
        out = out + mlp_apply(params["dense_mlp"], h, residual=False)
    return out, aux


def shard_moe_params(params: dict, mesh, *, dp_axes: tuple = ("data",),
                     ep_axis: str = "model") -> dict:
    """This rank's slices of an MoE layer's parameters for the expert
    parallel path, in place of the JAX ``in_specs``: ``wi`` / ``wg``
    ``[E/ep, D/n, F]`` and ``wo`` ``[E/ep, F/n, D]``, with ``ep`` the ranks
    along ``ep_axis`` and ``n`` along the FSDP axis (``"data"``); the router,
    norm and the shared or dense MLP whole."""
    ep, n = axis_size(mesh, ep_axis), axis_size(mesh, _fsdp_axis(mesh, dp_axes))
    e, f = mesh.get_local_rank(ep_axis), mesh.get_local_rank(_fsdp_axis(mesh, dp_axes))

    def cut(w: torch.Tensor) -> torch.Tensor:
        E, A = w.shape[:2]
        if E % ep or A % n:
            raise ValueError(f"{tuple(w.shape)} does not split into {ep} expert "
                             f"and {n} FSDP shards")
        return w[e * (E // ep):(e + 1) * (E // ep),
                 f * (A // n):(f + 1) * (A // n)].contiguous()

    return dict(params, wi=cut(params["wi"]), wg=cut(params["wg"]),
                wo=cut(params["wo"]))
