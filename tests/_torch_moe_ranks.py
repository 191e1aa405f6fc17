"""One rank of the port's expert-parallel MoE, for ``tests/test_torch_moe.py``.

The test writes its cases to a pickle and spawns ``world`` processes
(``spawn`` start method) that each run :func:`run_rank`: a gloo process
group on a ``FileStore``, a ``("data", "model")`` mesh of ``shape``, then
every case on this rank's batch shard (rows ``[i * B / n_data, (i + 1) * B
/ n_data)`` for data coordinate ``i``) and this rank's expert slices
(``shard_moe_params``), in the same order on every rank (SPMD).  Each rank
pickles its outputs to ``<out_dir>/rank<r>.pkl``.  This module imports the
port only, never JAX: the parent computes the JAX answers.

A case is ``("layer", cfg, numpy params, numpy x)`` for ``moe_apply``,
``("prefill", cfg, numpy JAX pytree, numpy tokens, s_cache)`` for
``Model.prefill(dist=...)``, or ``("grad", cfg, numpy params, numpy x,
numpy cotangent)`` for the gradient of ``sum(y * cotangent)`` through the
expert-parallel layer: this rank's ``x`` rows, its expert slices, and the
other leaves summed over ``"data"``."""
from __future__ import annotations

import pickle
from pathlib import Path


def _tensors(tree):
    import torch

    return {k: _tensors(v) if isinstance(v, dict) else torch.from_numpy(v)
            for k, v in tree.items()}


def _shard_rows(a, mesh):
    n = mesh.size(mesh.mesh_dim_names.index("data"))
    i = mesh.get_local_rank("data")
    rows = a.shape[0] // n
    return a[i * rows:(i + 1) * rows]


def _grads(case, mesh) -> dict:
    import torch
    import torch.distributed as dist

    from repro_torch.models.moe import moe_apply, shard_moe_params
    from repro_torch.tree import leaves_with_path, map_tree

    _, cfg, params, x, ct = case
    p = map_tree(lambda t: t.requires_grad_(True),
                 shard_moe_params(_tensors(params), mesh))
    xs = torch.from_numpy(_shard_rows(x, mesh)).requires_grad_(True)
    y, _ = moe_apply(p, cfg, xs, mesh=mesh)
    (y * torch.from_numpy(_shard_rows(ct, mesh))).sum().backward()
    out = {"x": xs.grad.numpy()}
    for path, leaf in leaves_with_path(p):
        g = leaf.grad
        if not any(path == f"[{w!r}]" for w in ("wi", "wg", "wo")):
            dist.all_reduce(g, group=mesh.get_group("data"))
        out[path] = g.numpy()
    return out


def run_rank(rank: int, world: int, shape: tuple, store: str, cases_path: str,
             out_dir: str) -> None:
    import torch

    from repro_torch.launch.mesh import destroy_process_group, make_mesh
    from repro_torch.models.convert import from_jax
    from repro_torch.models.model import DistContext, Model
    from repro_torch.models.moe import moe_apply, shard_moe_params

    torch.set_num_threads(1)
    with open(cases_path, "rb") as f:
        cases = pickle.load(f)
    mesh = make_mesh(shape, ("data", "model"), device="cpu", rank=rank,
                     store_path=store)
    out = {"coords": (mesh.get_local_rank("data"), mesh.get_local_rank("model"))}
    try:
        for name, case in cases.items():
            if case[0] == "layer":
                _, cfg, params, x = case
                p = shard_moe_params(_tensors(params), mesh)
                y, aux = moe_apply(p, cfg, torch.from_numpy(_shard_rows(x, mesh)),
                                   mesh=mesh)
                out[name] = (y.numpy(), float(aux))
            elif case[0] == "grad":
                out[name] = _grads(case, mesh)
            else:
                _, cfg, tree, tokens, s_cache = case
                params = from_jax(tree, cfg, device="cpu")
                for layer in params["layers"]:
                    if "ffn" in layer:
                        layer["ffn"] = shard_moe_params(layer["ffn"], mesh)
                logits, cache = Model(cfg, device="cpu").prefill(
                    params, torch.from_numpy(_shard_rows(tokens, mesh)), s_cache,
                    dist=DistContext(mesh))
                out[name] = (logits.numpy(),
                             [{k: v.float().numpy() for k, v in slot.items()}
                              for slot in cache["layers"]])
    finally:
        destroy_process_group()
    with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(out, f)
