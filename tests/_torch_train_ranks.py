"""One rank of the port's sharded training, for
``tests/test_torch_train_sharded.py``.

The test writes its cases to a pickle and spawns ``world`` processes
(``spawn`` start method) that each run :func:`run_rank`: a gloo process
group of ``world`` ranks on a ``FileStore``, then every case for this
world, in the same order on every rank (SPMD).  Each rank pickles its
results to ``<out_dir>/rank<r>.pkl``.  This module imports the port only,
never JAX: the parent computes the reference answers.

A case is a dict with ``kind``, ``world`` (the world that runs it) and its
inputs:

* ``step``: ``steps`` train steps of ``optimizer`` on ``mesh`` from the
  numpy JAX tree ``tree``, on the global ``batches``; returns each step's
  loss and grad norm and the gathered parameters.
* ``grads``: :func:`repro_torch.train.steps.loss_and_grads` on ``mesh``;
  returns the metrics and the gathered gradients.
* ``trainer``: ``Trainer(mesh=)`` runs (``runs``: ``(steps, ckpt_dir)``,
  each resuming the directory) on ``SyntheticLM``; returns the histories.
* ``restore``: a checkpoint restored onto ``mesh`` (``shardings=``), the
  restored leaves gathered, once ``wait_for`` (the checkpoint another
  world writes) exists.
* ``launch``: ``launch.train.main(argv)`` with ``WORLD_SIZE`` set.
* ``compress``: ``rounds`` rounds of ``compressed_allreduce`` of this
  rank's row of ``g`` over the world.
* ``gpipe``: ``make_gpipe`` of ``tanh(x @ w)`` stages over the world, this
  rank stage ``rank``; returns the outputs and the gradients of their sum.
"""
from __future__ import annotations

import faulthandler
import os
import pickle
import time
import traceback
from pathlib import Path


def _np(tree):
    """A tree of tensors (DTensors gathered) as numpy arrays."""
    from repro_torch.tree import map_tree

    def one(t):
        t = t.full_tensor() if hasattr(t, "full_tensor") else t
        return t.detach().float().cpu().numpy() if hasattr(t, "detach") else t
    return map_tree(one, tree)


def _local(batch, mesh):
    from repro_torch.models.sharding import batch_specs, local_slice
    from repro_torch.tree import map_tree

    return map_tree(lambda x, s: local_slice(x, s, mesh), batch,
                    batch_specs(mesh, batch))


def _mesh(shape, cache: dict):
    from repro_torch.launch.mesh import make_mesh

    if shape not in cache:
        cache[shape] = make_mesh(shape, ("data", "model"), device="cpu")
    return cache[shape]


def _params(case, mesh):
    from repro_torch.models.convert import from_jax
    from repro_torch.models.sharding import shard_params

    full = from_jax(case["tree"], case["cfg"], device="cpu", masters=True)
    return full, shard_params(full, mesh, case["cfg"])


def _step(case, mesh) -> dict:
    from repro_torch.models.model import DistContext, Model
    from repro_torch.models.sharding import dp_axes
    from repro_torch.optim import get_optimizer
    from repro_torch.train.steps import make_train_step

    cfg = case["cfg"]
    model = Model(cfg, remat=case.get("remat", False), device="cpu")
    _, params = _params(case, mesh)
    opt = get_optimizer(case["optimizer"], lr=1e-2, total_steps=10,
                        **case.get("opt_kw", {}))
    state = opt.init(params)
    step = make_train_step(model, opt, dist=DistContext(mesh, dp_axes(mesh)),
                           micro_steps=case.get("micro_steps", 1))
    losses, norms = [], []
    for b in case["batches"]:
        params, state, m = step(params, state, _local(b, mesh))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return {"loss": losses, "grad_norm": norms, "params": _np(params),
            "placements": [str(p.placements) for p in _leaves(params)]}


def _leaves(tree):
    from repro_torch.tree import leaves
    return leaves(tree)


def _grads(case, mesh) -> dict:
    from repro_torch.models.model import DistContext, Model
    from repro_torch.models.sharding import dp_axes
    from repro_torch.train.steps import loss_and_grads

    model = Model(case["cfg"], remat=True, device="cpu")
    _, params = _params(case, mesh)
    grads, metrics = loss_and_grads(model, params, _local(case["batch"], mesh),
                                    dist=DistContext(mesh, dp_axes(mesh)))
    return {"grads": _np(grads), "metrics": {k: float(v) for k, v in metrics.items()}}


def _trainer(case, mesh) -> dict:
    from repro_torch.data import SyntheticLM
    from repro_torch.models.model import Model
    from repro_torch.optim import get_optimizer
    from repro_torch.train import TrainConfig, Trainer

    cfg = case["cfg"]
    out = []
    for steps, ckpt_dir in case["runs"]:
        data = SyntheticLM(cfg.vocab_size, 16, 4, seed=3)
        opt = get_optimizer("adafactor", lr=1e-2, total_steps=10)
        tc = TrainConfig(steps=steps, ckpt_every=2, ckpt_dir=ckpt_dir, log_every=1)
        res = Trainer(Model(cfg, remat=False, device="cpu"), opt, data, tc,
                      mesh=mesh).run()
        out.append(res["history"])
    return {"histories": out}


def _restore(case, mesh) -> dict:
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.data import SyntheticLM
    from repro_torch.models.model import Model
    from repro_torch.optim import get_optimizer
    from repro_torch.train import TrainConfig, Trainer

    deadline = time.monotonic() + 200.0
    while not os.path.exists(case["wait_for"]):
        if time.monotonic() > deadline:
            raise TimeoutError(f"{case['wait_for']} was not written")
        time.sleep(0.1)
    cfg = case["cfg"]
    trainer = Trainer(Model(cfg, remat=False, device="cpu"),
                      get_optimizer("adafactor", lr=1e-2, total_steps=10),
                      SyntheticLM(cfg.vocab_size, 16, 4, seed=3),
                      TrainConfig(steps=0, ckpt_dir=case["ckpt_dir"]), mesh=mesh)
    params, opt_state, _ = trainer.init_state()
    template = {"params": params, "opt": opt_state}
    tree, manifest = CheckpointManager(case["ckpt_dir"]).restore(
        template, shardings=trainer._shardings(template))
    return {"step": manifest["step"], "tree": _np(tree),
            "sharded": [hasattr(x, "placements") for x in _leaves(tree["params"])]}


def _launch(case, mesh) -> dict:
    from repro_torch.launch import train

    os.environ["WORLD_SIZE"] = str(case["world"])
    out = train.main(case["argv"])
    return {"history": out["history"], "mesh": out["mesh"]}


def _compress(case, mesh) -> dict:
    import torch
    import torch.distributed as dist

    from repro_torch.distributed import compressed_allreduce

    g = torch.from_numpy(case["g"][dist.get_rank()])
    r = torch.zeros_like(g)
    outs, resids = [], []
    for _ in range(case["rounds"]):
        out, r = compressed_allreduce(g, r)
        outs.append(out.numpy())
        resids.append(r.numpy())
    return {"out": outs, "resid": resids}


def _gpipe(case, mesh) -> dict:
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.distributed import make_gpipe

    pipe = init_device_mesh("cpu", (dist.get_world_size(),), mesh_dim_names=("pipe",))
    w = torch.from_numpy(case["w"][dist.get_rank()]).requires_grad_(True)
    xs = torch.from_numpy(case["xs"]).requires_grad_(True)
    fn = make_gpipe(lambda p, x: torch.tanh(x @ p), pipe, "pipe")
    out = fn(w, xs)
    out.sum().backward()
    return {"out": out.detach().numpy(), "w_grad": w.grad.numpy(),
            "xs_grad": (torch.zeros_like(xs) if xs.grad is None else xs.grad).numpy()}


KINDS = {"step": _step, "grads": _grads, "trainer": _trainer, "restore": _restore,
         "launch": _launch, "compress": _compress, "gpipe": _gpipe}


def run_rank(rank: int, world: int, store: str, cases_path: str,
             out_dir: str) -> None:
    """Every case of ``world``; a case that raises leaves its name and
    traceback in ``<out_dir>/rank<r>.err``, and a fatal signal the Python
    stacks of every thread in ``<out_dir>/rank<r>.fault``, for the test to
    print."""
    with open(Path(out_dir) / f"rank{rank}.fault", "w") as fault:
        faulthandler.enable(fault, all_threads=True)
        try:
            _run_cases(rank, world, store, cases_path, out_dir)
        finally:
            faulthandler.disable()


def _run_cases(rank, world, store, cases_path, out_dir) -> None:
    import torch

    from repro_torch.launch.mesh import destroy_process_group, init_process_group

    torch.set_num_threads(1)
    with open(cases_path, "rb") as f:
        cases = pickle.load(f)
    init_process_group(world, device="cpu", rank=rank, store_path=store)
    meshes: dict = {}
    out: dict = {"seconds": {}}
    try:
        for name, case in cases.items():
            if case["world"] != world:
                continue
            mesh = _mesh(tuple(case["mesh"]), meshes) if "mesh" in case else None
            t0 = time.perf_counter()
            try:
                out[name] = KINDS[case["kind"]](case, mesh)
            except BaseException:
                with open(Path(out_dir) / f"rank{rank}.err", "w") as f:
                    f.write(f"case {name}\n{traceback.format_exc()}")
                raise
            out["seconds"][name] = time.perf_counter() - t0
    finally:
        destroy_process_group()
    with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(out, f)
