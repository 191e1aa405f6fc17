"""The port's sharded training on gloo worlds of 2 and 4 CPU ranks, against
the port's unsharded step and the JAX package.

A module fixture spawns the world of 4 and then the world of 2 (``spawn``,
a ``FileStore``, each under a hard deadline), each rank running
``tests/_torch_train_ranks.py::run_rank``, while the parent computes the
references.  Meshes ``(2, 2)`` and ``(4, 1)`` in the world of 4, ``(2,
1)`` and ``(1, 2)`` in the world of 2, all ``("data", "model")``.

* Two train steps of gemma3-1b and recurrentgemma-2b (smoke, one pattern
  repetition and two tail layers, f32), adamw and adafactor, each on one
  mesh of each world (each arch and each optimizer meets every mesh): the
  losses, grad norms and gathered parameters against the port's unsharded
  step, and against the jitted JAX step.
* llama4-scout (smoke, capacity factor 8) on ``(1, 2)`` and ``(2, 2)``:
  the expert leaves' gradients against the port's unsharded ones; the
  router's and the aux loss against the JAX sharded gradient on a JAX mesh
  of the same shape (JAX averages the Switch loss per batch shard, so it
  differs from the unsharded one there).
* tripre on ``(2, 2)`` against the port's unsharded step (the jitted JAX
  step cannot run tripre: ROADMAP C-ref 14); two micro steps on ``(2,
  1)`` against the unsharded step's.
* ``Trainer(mesh=)``: two steps with a checkpoint at step 2 on ``(2, 2)``,
  then a resume to step 3; its checkpoint restores onto ``(1, 2)`` and
  unsharded, and an unsharded checkpoint onto ``(2, 1)``.
* The launcher with ``--model-parallel 2`` in the world of 2 trains on a
  ``(1, 2)`` mesh; in a world of one it trains unsharded.
* ``compressed_allreduce`` (20 rounds with error feedback) and
  ``make_gpipe`` (4 stages, 4 microbatches) in the world of 4, against the
  JAX functions on 4 virtual devices.

Tolerances, max-norm relative per leaf: against the port's unsharded step
1e-5 (the same f32 arithmetic, the batch's sums split over ranks); adamw's
parameters excepted, whose first step moves an element by ``lr * g / (|g|
+ eps)``, the sign of a gradient within rounding of 0 (its moments are
held at 1e-5); against JAX the tolerances of ``test_torch_train_step.py``.
"""
import functools
import json
import math
import os
import pickle
import shutil
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from jax.sharding import Mesh, NamedSharding as JaxNamedSharding

import _torch_train_ranks as ranks
from _torch_lm_parity import configs, noisy
from _torch_train_parity import batch, one_torch_thread, to_port  # noqa: F401

from repro.models import sharding as js
from repro.models.model import DistContext as JaxDistContext
from repro.optim import optimizers as jopt
from repro.train.steps import loss_fn as jax_loss_fn
from repro.train.steps import make_train_step as jax_make_train_step
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import SyntheticLM
from repro_torch.launch import train as launch_train
from repro_torch.models.convert import from_jax, scanned_layers
from repro_torch.models.model import Model
from repro_torch.optim import get_optimizer
from repro_torch.train import TrainConfig, Trainer
from repro_torch.train.steps import loss_and_grads, make_train_step
from repro_torch.tree import leaves_with_path, map_tree

DEADLINE_S = 240.0
WORLDS = (4, 2)                # spawned in this order
MESHES = {4: ((2, 2), (4, 1)), 2: ((2, 1), (1, 2))}
ARCHS = ("gemma3-1b", "recurrentgemma-2b")
OPTIMIZERS = ("adamw", "adafactor")
# each arch and optimizer on one mesh of each world; each arch meets
# every mesh and each optimizer every mesh
STEP_CASES = [("gemma3-1b", "adamw", (2, 2)), ("gemma3-1b", "adamw", (2, 1)),
              ("gemma3-1b", "adafactor", (4, 1)), ("gemma3-1b", "adafactor", (1, 2)),
              ("recurrentgemma-2b", "adamw", (4, 1)),
              ("recurrentgemma-2b", "adamw", (1, 2)),
              ("recurrentgemma-2b", "adafactor", (2, 2)),
              ("recurrentgemma-2b", "adafactor", (2, 1))]
MOE = "llama4-scout-17b-a16e"
MOE_MESHES = ((1, 2), (2, 2))
# against the port's unsharded step
PORT_TOL = 1e-5
# against JAX (tests/test_torch_train_step.py)
STEP_TOL, ADAMW_PARAM_TOL = 1e-4, 1e-3
# f32 gradients against JAX (tests/_torch_train_parity.py)
GRAD_TOL = 1e-4
# an expert's gradient on (2, 2) against the local step (measured 2.5e-4)
EXPERT_LOCAL_TOL = 1e-3
# three adafactor steps of the Trainer against the unsharded one (measured
# 1.1e-5: adafactor's normalisation carries the rounding of the split sums)
TRAINER_TOL = 1e-4
EXPERTS = ("['ffn']['wi']", "['ffn']['wg']", "['ffn']['wo']")
GPIPE_TOL = 2e-4
LAUNCH_ARGV = ["--smoke", "--device", "cpu", "--model-parallel", "2", "--steps",
               "2", "--seq", "16", "--batch", "4", "--resume", "none"]


def _name(*parts) -> str:
    return "-".join("x".join(map(str, p)) if isinstance(p, tuple) else str(p)
                    for p in parts)


def _batches(cfg, seeds=(2, 3)):
    return [batch(cfg, B=4, S=16, seed=s) for s in seeds]


def _moe_cfgs():
    return configs(MOE, "float32", capacity_factor=8.0)


@functools.lru_cache(maxsize=None)
def _numpy_tree(arch: str) -> dict:
    """f32 masters of the smoke model with one pattern repetition and two
    tail layers, in the JAX layout (a scanned layer's leaves stacked under
    ``blocks/p<pos>``, the tail a list) with seeded noise in the leaves the
    init leaves at zero: the port's init, stacked, which costs no JAX
    compile."""
    cfg = _cfg(arch)
    port = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0), masters=True)
    layers = [map_tree(lambda t: t.numpy(), lp) for lp in port["layers"]]
    n_pat, n_scan = len(cfg.block_pattern), scanned_layers(cfg)
    tree = {k: map_tree(lambda t: t.numpy(), v) for k, v in port.items() if k != "layers"}
    tree["blocks"] = {f"p{i}": map_tree(lambda *xs: np.stack(xs),
                                        *layers[i:n_scan:n_pat])
                      for i in range(n_pat)}
    tree["tail"] = layers[n_scan:]
    return noisy(tree, 100)


def _cfg(arch: str):
    return configs(arch, "float32")[1]


def _cases(tmp) -> dict:
    cases = {}
    cfg = _cfg(ARCHS[0])
    sharded = str(tmp / "ck_sharded")
    cases["trainer"] = dict(kind="trainer", world=4, mesh=(2, 2), cfg=cfg,
                            runs=[(2, sharded), (3, sharded)])
    for arch, opt, mesh in STEP_CASES:
        cfg = _cfg(arch)
        cases[_name("step", arch, opt, mesh)] = dict(
            kind="step", world=math.prod(mesh), mesh=mesh, cfg=cfg,
            tree=_numpy_tree(arch), batches=_batches(cfg), optimizer=opt)
    cfg = _cfg(ARCHS[1])
    cases["micro"] = dict(kind="step", world=2, mesh=(2, 1), cfg=cfg,
                          tree=_numpy_tree(ARCHS[1]), batches=_batches(cfg),
                          optimizer="adafactor", micro_steps=2)
    _, cfg = _moe_cfgs()
    for mesh in MOE_MESHES:
        cases[_name("moe", mesh)] = dict(kind="grads", world=math.prod(mesh), mesh=mesh,
                                         cfg=cfg, tree=_numpy_tree(MOE),
                                         batch=batch(cfg, B=4, S=16, seed=4))
    cfg = _cfg(ARCHS[0])
    cases["tripre"] = dict(kind="step", world=4, mesh=(2, 2), cfg=cfg,
                           tree=_numpy_tree(ARCHS[0]), batches=_batches(cfg, (2,)),
                           optimizer="tripre", opt_kw=dict(band=4, refresh_every=5))
    cases["resume-unsharded"] = dict(kind="trainer", world=2, mesh=(2, 1), cfg=cfg,
                                     runs=[(4, str(tmp / "ck_onto_2x1"))])
    cases["launch"] = dict(kind="launch", world=2,
                           argv=LAUNCH_ARGV + ["--ckpt-dir", str(tmp / "ck_launch")])
    cases["restore"] = dict(kind="restore", world=2, mesh=(1, 2), cfg=cfg,
                            ckpt_dir=sharded, wait_for=os.path.join(sharded, "step_3"))
    rng = np.random.default_rng(0)
    cases["compress"] = dict(kind="compress", world=4, rounds=20,
                             g=rng.normal(size=(4, 64)).astype(np.float32))
    cases["gpipe"] = dict(kind="gpipe", world=4,
                          w=(rng.normal(size=(4, 16, 16)) * 0.3).astype(np.float32),
                          xs=rng.normal(size=(4, 2, 16)).astype(np.float32))
    return cases


# --------------------------------------------------------------------------
# references
# --------------------------------------------------------------------------
def _trainer_runs(cfg, runs) -> list:
    out = []
    for steps, ckpt_dir in runs:
        tc = TrainConfig(steps=steps, ckpt_every=2, ckpt_dir=ckpt_dir, log_every=1)
        res = Trainer(Model(cfg, remat=False, device="cpu"),
                      get_optimizer("adafactor", lr=1e-2, total_steps=10),
                      SyntheticLM(cfg.vocab_size, 16, 4, seed=3), tc).run()
        out.append(res["history"])
    return out


def _port_step(case) -> dict:
    cfg = case["cfg"]
    model = Model(cfg, remat=False, device="cpu")
    params = from_jax(case["tree"], cfg, device="cpu", masters=True)
    opt = get_optimizer(case["optimizer"], lr=1e-2, total_steps=10,
                        **case.get("opt_kw", {}))
    state = opt.init(params)
    step = make_train_step(model, opt, micro_steps=case.get("micro_steps", 1))
    losses, norms = [], []
    for b in case["batches"]:
        params, state, m = step(params, state, b)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return {"loss": losses, "grad_norm": norms, "params": params}


def _jax_steps(arch: str, batches) -> dict:
    """The JAX train step of each optimizer on ``batches``: the jitted
    gradient of the JAX ``loss_fn`` (one compile per arch), then the JAX
    package's clipping and update, jitted, as its ``make_train_step``
    composes them."""
    from repro.models.model import Model as JaxModel

    jcfg, cfg = configs(arch, "float32")
    jm = JaxModel(jcfg, remat=False)
    grad = jax.jit(jax.value_and_grad(lambda q, b: jax_loss_fn(jm, q, b), has_aux=True))
    out = {}
    for name in OPTIMIZERS:
        jo = jopt.get_optimizer(name, lr=1e-2, total_steps=10)
        update = jax.jit(lambda g, st, p, jo=jo: jo.update(
            jopt.clip_by_global_norm(g, 1.0)[0], st, p))
        params = jax.tree.map(jnp.asarray, _numpy_tree(arch))
        state, losses = jo.init(params), []
        for b in batches:
            (loss, _), g = grad(params, {k: jnp.asarray(v) for k, v in b.items()})
            params, state = update(g, state, params)
            losses.append(float(loss))
        out[name] = {"loss": losses, "params": to_port(params, cfg)}
    return out


def _jax_mesh(shape):
    devs = np.array(jax.devices()[:math.prod(shape)]).reshape(shape)
    return Mesh(devs, ("data", "model"))


def _jax_sharded_grads(shape) -> dict:
    jcfg, cfg = _moe_cfgs()
    from repro.models.model import Model as JaxModel

    jm = JaxModel(jcfg, remat=False)
    tree = jax.tree.map(jnp.asarray, _numpy_tree(MOE))
    mesh = _jax_mesh(shape)
    specs = js.param_specs(tree, mesh, jcfg)
    sharded = jax.device_put(tree, jax.tree.map(lambda s: JaxNamedSharding(mesh, s),
                                                specs))
    dist = JaxDistContext(mesh=mesh, dp_axes=("data",))
    b = {k: jnp.asarray(v) for k, v in batch(cfg, B=4, S=16, seed=4).items()}
    with mesh:
        (loss, metrics), g = jax.jit(jax.value_and_grad(
            lambda q: jax_loss_fn(jm, q, b, dist=dist), has_aux=True))(sharded)
    return {"loss": float(loss), "aux": float(metrics["aux"]),
            "grads": to_port(g, cfg)}


def _jax_compress(g: np.ndarray, rounds: int):
    from repro.compat import shard_map
    from repro.distributed.compress import compressed_allreduce
    from jax.sharding import PartitionSpec as P

    mesh = Mesh(np.array(jax.devices()[:4]), ("data",))

    def body(gg, rr):
        out, r = compressed_allreduce(gg[0], rr[0], "data")
        return out, r[None]

    f = jax.jit(shard_map(body, mesh=mesh, in_specs=(P("data", None), P("data", None)),
                          out_specs=(P(None), P("data", None)), check_vma=False))
    resid, outs, resids = jnp.zeros_like(g), [], []
    for _ in range(rounds):
        out, resid = f(jnp.asarray(g), resid)
        outs.append(np.asarray(out))
        resids.append(np.asarray(resid))
    return outs, resids


def _jax_gpipe(w: np.ndarray, xs: np.ndarray):
    from repro.distributed.pipeline import make_gpipe

    mesh = Mesh(np.array(jax.devices()[:4]), ("pipe",))
    fn = make_gpipe(lambda p, x: jnp.tanh(x @ p), mesh, "pipe")
    with mesh:
        out, (gw, gx) = jax.jit(jax.value_and_grad(
            lambda a, b: fn(a, b).sum(), argnums=(0, 1)))(jnp.asarray(w), jnp.asarray(xs))
        fwd = jax.jit(fn)(jnp.asarray(w), jnp.asarray(xs))
    return np.asarray(fwd), np.asarray(gw), np.asarray(gx)


def _start(world: int, tmp, cases_path):
    out_dir = tmp / f"world{world}"
    out_dir.mkdir()
    return out_dir, mp.start_processes(
        ranks.run_rank, args=(world, str(out_dir / "store"), str(cases_path),
                              str(out_dir)),
        nprocs=world, join=False, start_method="spawn")


def _rank_logs(out_dir) -> str:
    """What the ranks left of a failure: each ``rank<r>.err`` (the case and
    its traceback) and ``rank<r>.fault`` (the stacks at a fatal signal)."""
    found = [f"--- {f.name}\n{f.read_text()}" for pat in ("rank*.err", "rank*.fault")
             for f in sorted(out_dir.glob(pat)) if f.stat().st_size]
    return "\n".join(found) or "(no rank left a traceback)"


def _join(world: int, out_dir, ctx, deadline: float) -> list:
    """Wait for ``world``'s ranks until ``deadline`` (the test fails past
    it, or when a rank fails, with what the ranks left of it); their
    outputs in rank order."""
    try:
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                pytest.fail(f"the world of {world} did not finish in {DEADLINE_S} s\n"
                            f"{_rank_logs(out_dir)}")
    except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
        pytest.fail(f"the world of {world} failed: {e}\n{_rank_logs(out_dir)}")
    got = []
    for r in range(world):
        with open(out_dir / f"rank{r}.pkl", "rb") as f:
            got.append(pickle.load(f))
    return got


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """``({world: per-rank outputs}, references, cases, tmp)``: both worlds
    run at once (the world of 2 restores the world of 4's checkpoint last,
    once it is written), while the parent computes the references."""
    tmp = tmp_path_factory.mktemp("train_sharded")
    cases = _cases(tmp)
    with open(tmp / "cases.pkl", "wb") as f:
        pickle.dump(cases, f)
    cfg = _cfg(ARCHS[0])
    # the unsharded checkpoint the (2, 1) mesh resumes
    _trainer_runs(cfg, [(3, str(tmp / "ck_unsharded"))])
    shutil.copytree(tmp / "ck_unsharded", tmp / "ck_onto_2x1")
    deadline = time.monotonic() + DEADLINE_S
    started = {w: _start(w, tmp, tmp / "cases.pkl") for w in WORLDS}
    ref: dict = {}
    got: dict = {}
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for arch in ARCHS:
            runs = {opt: cases[_name("step", arch, opt, mesh)]
                    for a, opt, mesh in STEP_CASES if a == arch}
            jax_ref = _jax_steps(arch, runs["adamw"]["batches"])
            for opt, case in runs.items():
                ref[_name("jax", arch, opt)] = jax_ref[opt]
                ref[_name("port", arch, opt)] = _port_step(case)
        ref["moe-jax"] = _jax_sharded_grads((2, 2))
        _, mcfg = _moe_cfgs()
        ref["moe-port"] = loss_and_grads(
            Model(mcfg, remat=False, device="cpu"),
            from_jax(_numpy_tree(MOE), mcfg, device="cpu", masters=True),
            batch(mcfg, B=4, S=16, seed=4))
        ref["tripre"] = _port_step(cases["tripre"])
        ref["micro"] = _port_step(cases["micro"])
        ref["compress"] = _jax_compress(cases["compress"]["g"], 20)
        ref["gpipe"] = _jax_gpipe(cases["gpipe"]["w"], cases["gpipe"]["xs"])
        ref["trainer"] = _trainer_runs(cfg, [(2, str(tmp / "ck_u2")),
                                             (3, str(tmp / "ck_u2"))])
        shutil.copytree(tmp / "ck_unsharded", tmp / "ck_u4")
        ref["resume-unsharded"] = _trainer_runs(cfg, [(4, str(tmp / "ck_u4"))])
        got[4] = _join(4, *started[4], deadline)
        shutil.copytree(tmp / "ck_sharded", tmp / "ck_from_sharded")
        ref["from-sharded"] = _trainer_runs(cfg, [(4, str(tmp / "ck_from_sharded"))])
        got[2] = _join(2, *started[2], deadline)
    finally:
        torch.set_num_threads(n)
        for _, ctx in started.values():
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join(10)
    return got, ref, cases, tmp


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want).max() if want.size else 0.0
    err = np.abs(got - want).max() if got.size else 0.0
    return err / scale if scale else err


def _worst(got: dict, want: dict, skip=()) -> tuple:
    a, b = leaves_with_path(got), leaves_with_path(want)
    assert [k for k, _ in a] == [k for k, _ in b]
    return max(((_rel(x, torch.as_tensor(y).detach().numpy()), k)
                for (k, x), (_, y) in zip(a, b) if not any(s in k for s in skip)),
               default=(0.0, ""))


def _ranks(got, name):
    """Every rank's result of case ``name``, checked the same on all."""
    world = next(w for w, rs in got.items() if name in rs[0])
    outs = [r[name] for r in got[world]]
    return outs


# --------------------------------------------------------------------------
# the tests
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch,opt,mesh", STEP_CASES, ids=[_name(*c) for c in STEP_CASES])
def test_sharded_step_matches_unsharded_and_jax(spawned, arch, opt, mesh):
    got, ref, _, _ = spawned
    outs = _ranks(got, _name("step", arch, opt, mesh))
    port, jx = ref[_name("port", arch, opt)], ref[_name("jax", arch, opt)]
    for r in outs:
        assert r["loss"] == outs[0]["loss"] and r["grad_norm"] == outs[0]["grad_norm"]
        np.testing.assert_allclose(r["loss"], port["loss"], rtol=PORT_TOL)
        np.testing.assert_allclose(r["grad_norm"], port["grad_norm"], rtol=PORT_TOL)
        np.testing.assert_allclose(r["loss"], jx["loss"], rtol=1e-5)
    params = outs[0]["params"]
    ptol = ADAMW_PARAM_TOL if opt == "adamw" else PORT_TOL
    err, leaf = _worst(params, port["params"])
    assert err <= ptol, (leaf, err)
    err, leaf = _worst(params, jx["params"])
    assert err <= (ADAMW_PARAM_TOL if opt == "adamw" else STEP_TOL), (leaf, err)
    # sharded at rest: some leaf is split wherever the mesh has ranks to split over
    assert any("Shard" in p for p in outs[0]["placements"])


def _moe_grads(outs) -> dict:
    for r in outs[1:]:
        assert r["metrics"] == outs[0]["metrics"]
    return outs[0]["grads"]


def test_moe_on_1x2_matches_local(spawned):
    """One batch shard: the Switch loss per shard is the whole batch's, so
    every leaf, the loss and the aux loss are the local step's."""
    got, ref, _, _ = spawned
    outs = _ranks(got, _name("moe", (1, 2)))
    want, metrics = ref["moe-port"]
    err, leaf = _worst(_moe_grads(outs), want)
    assert err <= GRAD_TOL, (leaf, err)
    for key in ("loss", "aux"):
        np.testing.assert_allclose(outs[0]["metrics"][key], float(metrics[key]),
                                   rtol=1e-5)


def test_moe_on_2x2_experts_match_local_and_router_matches_jax(spawned):
    """Two batch shards: every leaf, the loss and the aux loss against the
    JAX sharded gradient on a (2, 2) JAX mesh; the experts also against the
    local step, to EXPERT_LOCAL_TOL (the per-shard Switch loss reaches an
    earlier layer's experts through the residual stream)."""
    got, ref, _, _ = spawned
    outs = _ranks(got, _name("moe", (2, 2)))
    grads = _moe_grads(outs)
    jx, (want, _) = ref["moe-jax"], ref["moe-port"]
    err, leaf = _worst(grads, jx["grads"])
    assert err <= GRAD_TOL, (leaf, err)
    np.testing.assert_allclose(outs[0]["metrics"]["aux"], jx["aux"], rtol=1e-5)
    np.testing.assert_allclose(outs[0]["metrics"]["loss"], jx["loss"], rtol=1e-5)
    local = dict(leaves_with_path(want))
    experts = [(p, g) for p, g in leaves_with_path(grads) if p.endswith(EXPERTS)]
    assert len(experts) == 3 * sum(k.endswith(EXPERTS[0]) for k in local) > 0
    for path, g in experts:
        assert _rel(g, local[path].numpy()) <= EXPERT_LOCAL_TOL, path
    # the router is not the local one: JAX averages the Switch loss per shard
    router = [p for p in local if p.endswith("['router']['w']")]
    assert max(_rel(dict(leaves_with_path(grads))[p], local[p].numpy())
               for p in router) > GRAD_TOL


def test_micro_steps_split_the_local_shard(spawned):
    """Two micro steps on (2, 1): each rank splits its own rows, so a micro
    step's rows differ from the unsharded split's, but every row holds the
    same number of labelled tokens, so the averaged gradient is the same
    (the loss reported is the last micro step's, of other rows)."""
    got, ref, _, _ = spawned
    (r, *_) = _ranks(got, "micro")
    np.testing.assert_allclose(r["grad_norm"], ref["micro"]["grad_norm"], rtol=PORT_TOL)
    err, leaf = _worst(r["params"], ref["micro"]["params"])
    assert err <= PORT_TOL, (leaf, err)


def test_tripre_matches_unsharded(spawned):
    got, ref, _, _ = spawned
    (r, *rest) = _ranks(got, "tripre")
    np.testing.assert_allclose(r["loss"], ref["tripre"]["loss"], rtol=PORT_TOL)
    err, leaf = _worst(r["params"], ref["tripre"]["params"])
    assert err <= PORT_TOL, (leaf, err)


def test_trainer_resumes_and_matches_unsharded(spawned):
    got, ref, _, tmp = spawned
    outs = _ranks(got, "trainer")
    for r in outs:
        h = r["histories"]
        assert [len(x) for x in h] == [2, 1]
        np.testing.assert_allclose(h[0] + h[1], ref["trainer"][0] + ref["trainer"][1],
                                   rtol=PORT_TOL)
    mgr = CheckpointManager(str(tmp / "ck_sharded"))
    assert mgr.steps() == [2, 3]
    with np.load(tmp / "ck_sharded" / "step_3" / "arrays.npz") as a, \
            np.load(tmp / "ck_u2" / "step_3" / "arrays.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert _rel(a[k], b[k]) <= TRAINER_TOL, k


def test_sharded_checkpoint_restores_onto_another_mesh_and_unsharded(spawned):
    got, ref, _, tmp = spawned
    outs = _ranks(got, "restore")
    with open(tmp / "ck_sharded" / "step_3" / "manifest.json") as f:
        manifest = json.load(f)
    with np.load(tmp / "ck_sharded" / "step_3" / "arrays.npz") as a:
        for r in outs:
            assert r["step"] == 3 and any(r["sharded"])
            for path, leaf in leaves_with_path(r["tree"]):
                assert np.array_equal(leaf, a[manifest["leaves"][path]["key"]]), path
    # the unsharded trainer resumes the (2, 2) world's checkpoint
    assert len(ref["from-sharded"][0]) == 1
    np.testing.assert_allclose(ref["from-sharded"][0], ref["resume-unsharded"][0],
                               rtol=PORT_TOL)


def test_unsharded_checkpoint_resumes_onto_2x1(spawned):
    got, ref, _, _ = spawned
    for r in _ranks(got, "resume-unsharded"):
        assert len(r["histories"][0]) == 1
        np.testing.assert_allclose(r["histories"][0], ref["resume-unsharded"][0],
                                   rtol=PORT_TOL)


def test_launcher_model_parallel(spawned, tmp_path, monkeypatch):
    """``--model-parallel 2`` on a world of 2 trains on a (1, 2) mesh; in a
    world of one the same flags train unsharded, to the same losses."""
    got, _, _, _ = spawned
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    out = launch_train.main(LAUNCH_ARGV + ["--ckpt-dir", str(tmp_path)])
    assert out["mesh"] is None
    for r in _ranks(got, "launch"):
        assert r["mesh"] == (1, 2)
        np.testing.assert_allclose(r["history"], out["history"], rtol=PORT_TOL)


def test_compressed_allreduce_matches_jax(spawned):
    """The means bit for bit in every round: the same f32 arithmetic, an
    int32 sum and the max-scale in both packages.  The residual ``g - q *
    scale`` is held to one rounding of the product per round so far (the
    residual carries it into the next round): XLA contracts it into a fused
    multiply-add on the CPU, torch rounds the product first.  Error
    feedback keeps the 20-round mean error below 0.02, as the JAX package's
    test."""
    got, ref, cases, _ = spawned
    outs, resids = ref["compress"]
    g = cases["compress"]["g"]
    target = g.mean(0)
    ulp = float(np.spacing(np.float32(np.abs(g).max())))
    for rank, r in enumerate(_ranks(got, "compress")):
        for k in range(20):
            np.testing.assert_array_equal(r["out"][k], outs[k])
            np.testing.assert_allclose(r["resid"][k], resids[k][rank], rtol=0,
                                       atol=(k + 1) * ulp)
        err = np.mean([o - target for o in r["out"]], axis=0)
        assert np.abs(err).max() < 0.02
        np.testing.assert_allclose(r["out"][0], target, atol=0.1)


def test_gpipe_matches_jax_forward_and_gradient(spawned):
    got, ref, cases, _ = spawned
    fwd, gw, gx = ref["gpipe"]
    outs = _ranks(got, "gpipe")
    for r in outs:
        np.testing.assert_allclose(r["out"], fwd, rtol=GPIPE_TOL, atol=GPIPE_TOL)
    w_grad = np.stack([r["w_grad"] for r in outs])
    np.testing.assert_allclose(w_grad, gw, rtol=GPIPE_TOL, atol=GPIPE_TOL)
    xs_grad = sum(r["xs_grad"] for r in outs)
    np.testing.assert_allclose(xs_grad, gx, rtol=GPIPE_TOL, atol=GPIPE_TOL)
    # the sequential stages
    ref_out = cases["gpipe"]["xs"]
    for s in range(4):
        ref_out = np.tanh(ref_out @ cases["gpipe"]["w"][s])
    np.testing.assert_allclose(outs[0]["out"], ref_out, rtol=GPIPE_TOL, atol=GPIPE_TOL)
