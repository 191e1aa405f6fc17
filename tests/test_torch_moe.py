"""The port's mixture of experts (``repro_torch.models.moe``) against the
JAX package's ``models/moe.py``, at the smoke configurations of
llama4-scout (4 experts, top-1, a shared expert) and arctic (4 experts,
top-2, a dense residual MLP): d_model 64, d_ff 128.  Parameters come from
the JAX ``init_moe`` with seeded noise in the norm scales, inputs from
numpy seeds; the port runs on the CPU.

* The routing: ``capacity``, ``dispatch_indices`` (random, tie-heavy and
  dropping expert ids) and the router's top-k with tied probabilities are
  held exactly; so are the (expert, slot) of every (token, choice) pair in
  a case that drops pairs past capacity, and in one whose router has two
  equal columns (ties go to the lower expert id, as ``lax.top_k``).
* The local path (``mesh=None``): ``y`` and ``aux``.
* The expert-parallel path: a world of 4 gloo ranks (``spawn``, a
  ``FileStore``, under a hard deadline) on a ``(2, 2)`` ``("data",
  "model")`` mesh, each rank its batch shard and its ``shard_moe_params``
  slices, against the JAX ``moe_apply(mesh=make_mesh((2, 2), ...))`` on
  the virtual CPU devices (per-shard capacity: not the local answer), a
  case that drops pairs included, and ``Model.prefill(dist=...)`` for
  llama4-scout's smoke model; a world of one in process against the local
  path.

Tolerances, as max |port - jax| / max |jax|: f32 ``y`` 1e-5 and ``aux``
1e-6 absolute (the same f32 arithmetic in another order; ``aux`` is near
1); bf16 2e-2 (the frameworks round bf16 products at different points);
the expert-parallel answers 2e-4 and 1e-6, as the JAX package's own
EP-against-local test (``tests/test_parallel_features.py``) holds ``y``.
"""
import dataclasses
import functools
import pickle
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro.launch.mesh import make_mesh as jax_make_mesh
from repro.models import config as jax_config
from repro.models import moe as jm
from repro.models.layers import dense as jax_dense
from repro.models.layers import rms_norm as jax_rms_norm
from repro.models.model import DistContext as JaxDistContext
from repro.models.model import Model as JaxModel
from repro_torch.launch import mesh as t_mesh
from repro_torch.models import config as port_config
from repro_torch.models import moe as pm
from repro_torch.models.layers import rms_norm

import _torch_moe_ranks as ranks
from _torch_lm_parity import _tree, configs, noisy, rel

ARCHS = ("llama4-scout-17b-a16e", "arctic-480b")
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
AUX_TOL = {"float32": 1e-6, "bfloat16": 2e-2}
EP_TOL, EP_AUX_TOL = 2e-4, 1e-6
# seconds the spawned world may take, start to finish
DEADLINE_S = 240.0
MESH = (2, 2)


def _cfgs(arch, **kw):
    return (dataclasses.replace(jax_config.smoke_config(arch), **kw),
            dataclasses.replace(port_config.smoke_config(arch), **kw))


@functools.lru_cache(maxsize=None)
def _numpy_params(arch: str, seed: int = 0) -> dict:
    """The JAX ``init_moe`` (f32 masters) with noise in the norm scales."""
    jcfg, _ = _cfgs(arch)
    return noisy(jax.tree.map(np.asarray, jm.init_moe(jax.random.key(seed), jcfg)),
                 seed + 100)


def _port(tree: dict, dtype=torch.float32) -> dict:
    """``tree`` as the port holds it: norm scales f32, weights ``dtype``."""
    return {k: _port(v, dtype) if isinstance(v, dict)
            else torch.from_numpy(np.array(v)).to(torch.float32 if k == "scale" else dtype)
            for k, v in tree.items()}


def _x(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _jax_routes(params, cfg, x, C):
    """The JAX local path's (expert, slot) per (token, choice) pair."""
    h = jax_rms_norm(params["ln"], jnp.asarray(x))
    h2 = h.reshape(-1, h.shape[-1])
    probs = jax.nn.softmax(jax_dense(params["router"], h2).astype(jnp.float32), -1)
    _, eid = jax.lax.top_k(probs, cfg.top_k)
    eflat = eid.reshape(-1)
    return np.asarray(eflat), np.asarray(jm._dispatch_indices(eflat, C))


def _port_routes(params, cfg, x, C):
    h = rms_norm(params["ln"], torch.from_numpy(x))
    return pm._Routes(params, cfg, h.reshape(-1, h.shape[-1]), C)


# --------------------------------------------------------------------------
# routing
# --------------------------------------------------------------------------
@pytest.mark.parametrize("tokens", [1, 4, 16, 37, 100, 2048, 8192])
@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_matches_jax(arch, tokens):
    for cfg in (jax_config.get_config(arch), jax_config.smoke_config(arch),
                dataclasses.replace(jax_config.smoke_config(arch), capacity_factor=0.3)):
        assert pm.capacity(tokens, cfg) == jm._capacity(tokens, cfg)


def _ids(case):
    rng = np.random.default_rng(7)
    return {"random": (rng.integers(0, 8, 300), 48),
            "dropping": (rng.integers(0, 8, 300), 24),
            "one-expert": (np.full(40, 3), 8),
            "tie-heavy": (rng.integers(0, 2, 101) * 5, 16),
            "sorted-runs": (np.repeat(np.arange(6), 13), 8),
            "all-fit": (rng.permutation(np.arange(64) % 16), 8)}[case]


@pytest.mark.parametrize("case", ["random", "dropping", "one-expert", "tie-heavy",
                                  "sorted-runs", "all-fit"])
def test_dispatch_indices_match_jax(case):
    eid, C = _ids(case)
    got = pm.dispatch_indices(torch.from_numpy(eid), C).numpy()
    want = np.asarray(jm._dispatch_indices(jnp.asarray(eid, jnp.int32), C))
    np.testing.assert_array_equal(got, want)
    assert (got <= C).all()
    if case in ("dropping", "one-expert", "tie-heavy", "sorted-runs"):
        assert (got == C).any()                         # pairs were dropped


@pytest.mark.parametrize("k", [1, 2, 3])
def test_top_k_breaks_ties_like_lax(k):
    rng = np.random.default_rng(3)
    probs = rng.random((50, 8)).astype(np.float32)
    probs[:10] = 0.125                                  # all tied
    probs[10:20, 5] = probs[10:20, 2]                   # two tied columns
    probs[20:30, 1:4] = probs[20:30, :1]                # four tied, lowest first
    vals, idx = pm.top_k(torch.from_numpy(probs), k)
    jvals, jidx = jax.lax.top_k(jnp.asarray(probs), k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))


# --------------------------------------------------------------------------
# the local path
# --------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_matches_jax(arch, dtype):
    jcfg, cfg = _cfgs(arch)
    tree = _numpy_params(arch)
    x = _x(1, (2, 20, cfg.d_model))
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    y, aux = pm.moe_apply(_port(tree, tdt), cfg, torch.from_numpy(x).to(tdt))
    jy, jaux = jm.moe_apply(jax.tree.map(jnp.asarray, tree), jcfg, jnp.asarray(x, jdt))
    assert y.dtype == tdt and y.shape == x.shape
    assert rel(y, jy) <= TOL[dtype]
    assert abs(float(aux) - float(jaux)) <= AUX_TOL[dtype]


@pytest.mark.parametrize("arch", ARCHS)
def test_dropped_pairs_match_jax(arch):
    """A capacity factor of 0.25: 8 slots an expert against ~20 (top-1) or
    ~40 (top-2) pairs, so most pairs are dropped; the kept ones, their
    slots, ``y`` and ``aux`` as in JAX."""
    jcfg, cfg = _cfgs(arch, capacity_factor=0.25)
    tree = _numpy_params(arch)
    x = _x(2, (2, 40, cfg.d_model))
    params = _port(tree)
    C = pm.capacity(80, cfg)
    routes = _port_routes(params, cfg, x, C)
    eid, slot = _jax_routes(tree, jcfg, x, C)
    np.testing.assert_array_equal(routes.eflat.numpy(), eid)
    np.testing.assert_array_equal(routes.slot.numpy(), slot)
    assert (slot == C).sum() > len(slot) // 4
    for e in range(cfg.n_experts):                      # every slot filled once
        kept = slot[(eid == e) & (slot < C)]
        np.testing.assert_array_equal(np.sort(kept), np.arange(len(kept)))
    y, aux = pm.moe_apply(params, cfg, torch.from_numpy(x))
    jy, jaux = jm.moe_apply(jax.tree.map(jnp.asarray, tree), jcfg, jnp.asarray(x))
    assert rel(y, jy) <= TOL["float32"]
    assert abs(float(aux) - float(jaux)) <= AUX_TOL["float32"]


@pytest.mark.parametrize("arch", ARCHS)
def test_router_with_two_equal_columns(arch):
    """Experts 0 and 1 get the same router column, so every token's
    probabilities tie between them: the lower id goes first, as
    ``lax.top_k`` puts it; top-1 never routes to expert 1."""
    jcfg, cfg = _cfgs(arch)
    tree = _numpy_params(arch)
    w = tree["router"]["w"].copy()
    w[:, 1] = w[:, 0]
    tree = dict(tree, router={"w": w})
    x = _x(3, (2, 24, cfg.d_model))
    params = _port(tree)
    routes = _port_routes(params, cfg, x, pm.capacity(48, cfg))
    assert torch.equal(routes.probs[:, 0], routes.probs[:, 1])
    eid, slot = _jax_routes(tree, jcfg, x, routes.C)
    np.testing.assert_array_equal(routes.eflat.numpy(), eid)
    np.testing.assert_array_equal(routes.slot.numpy(), slot)
    pairs = eid.reshape(-1, cfg.top_k)
    if cfg.top_k == 1:
        assert (pairs != 1).all() and (pairs == 0).any()
    else:
        both = (pairs == 0).any(1) & (pairs == 1).any(1)
        assert both.any() and (pairs[both] == [0, 1]).all()
    y, _ = pm.moe_apply(params, cfg, torch.from_numpy(x))
    jy, _ = jm.moe_apply(jax.tree.map(jnp.asarray, tree), jcfg, jnp.asarray(x))
    assert rel(y, jy) <= TOL["float32"]


def test_mlp_apply_without_residual_matches_jax():
    """The shared expert's MLP as the MoE calls it: no residual, its own
    norm of the already normed input."""
    from repro.models.layers import mlp_apply as jax_mlp_apply
    from repro_torch.models.layers import mlp_apply

    tree = _numpy_params("llama4-scout-17b-a16e")["shared"]
    x = _x(4, (2, 9, 64))
    for residual in (False, True):
        got = mlp_apply(_port(tree), torch.from_numpy(x), residual=residual)
        want = jax_mlp_apply(jax.tree.map(jnp.asarray, tree), jnp.asarray(x),
                             residual=residual)
        assert rel(got, want) <= TOL["float32"]


def test_expert_stacks_drawn_one_expert_at_a_time():
    """``Init.stacked`` draws each expert alone, in the compute dtype on
    the device; on the meta device it makes the shape only."""
    from repro_torch.models.layers import Init

    init = Init(torch.Generator().manual_seed(5), torch.bfloat16, torch.device("cpu"))
    w = init.stacked(3, (4, 6), 0.5)
    ref = Init(torch.Generator().manual_seed(5), torch.bfloat16, torch.device("cpu"))
    assert w.dtype == torch.bfloat16 and w.shape == (3, 4, 6)
    for i in range(3):
        assert torch.equal(w[i], ref.normal((4, 6), 0.5))
    meta = Init(None, torch.bfloat16, torch.device("meta")).stacked(128, (7168, 4864), 1.0)
    assert meta.is_meta and meta.shape == (128, 7168, 4864)


# --------------------------------------------------------------------------
# expert parallel: shards, a world of one, and a world of four
# --------------------------------------------------------------------------
def _fake_mesh(shape, coords):
    names = ("data", "model")
    return types.SimpleNamespace(mesh_dim_names=names,
                                 size=lambda dim: shape[dim],
                                 get_local_rank=lambda axis: coords[names.index(axis)])


@pytest.mark.parametrize("coords", [(0, 0), (0, 1), (1, 0), (1, 1)])
def test_shard_moe_params_slices(coords):
    """Rank (data i, model j) of a (2, 2) mesh holds experts [2j, 2j + 2)
    and rows [i n / 2, (i + 1) n / 2) of each expert's first weight axis;
    the rest whole."""
    params = _port(_numpy_params("arctic-480b"))
    got = pm.shard_moe_params(params, _fake_mesh(MESH, coords))
    i, j = coords
    for name in ("wi", "wg", "wo"):
        w = params[name]
        half = w.shape[1] // 2
        assert torch.equal(got[name], w[2 * j:2 * j + 2, i * half:(i + 1) * half])
        assert got[name].is_contiguous()
    for name in ("ln", "router", "dense_mlp"):
        assert got[name] is params[name]


def test_expert_parallel_needs_shards():
    cfg = port_config.smoke_config("llama4-scout-17b-a16e")
    params = _port(_numpy_params("llama4-scout-17b-a16e"))
    with pytest.raises(ValueError, match="shard_moe_params"):
        pm.moe_apply(params, cfg, torch.zeros((1, 4, 64)),
                     mesh=_fake_mesh(MESH, (0, 0)))
    with pytest.raises(ValueError, match="does not split"):
        pm.shard_moe_params(params, _fake_mesh((1, 3), (0, 0)))


@pytest.mark.parametrize("arch", ARCHS)
def test_world_of_one_matches_local(arch):
    """One gloo rank on a (1, 1) mesh runs the collectives and gives the
    local path's answer; a mesh without a ``"model"`` dimension takes the
    local path."""
    _, cfg = _cfgs(arch)
    params = _port(_numpy_params(arch))
    x = torch.from_numpy(_x(5, (2, 16, cfg.d_model)))
    want, want_aux = pm.moe_apply(params, cfg, x)
    mesh = t_mesh.make_mesh((1, 1), ("data", "model"), device="cpu")
    try:
        got, aux = pm.moe_apply(pm.shard_moe_params(params, mesh), cfg, x, mesh=mesh)
        data_only = t_mesh.make_mesh((1,), ("data",), device="cpu")
        local, _ = pm.moe_apply(params, cfg, x, mesh=data_only)
    finally:
        t_mesh.destroy_process_group()
    assert torch.equal(got, want) and float(aux) == float(want_aux)
    assert torch.equal(local, want)


def _cases() -> dict:
    """The spawned world's cases: the layer of both archs (f32), llama4's
    with a capacity factor of 0.5 (8 slots against ~12 pairs an expert and
    rank, so pairs drop), and llama4-scout's smoke model (3 layers) for
    ``Model.prefill(dist=...)`` with an f32 KV cache."""
    out = {}
    for name, arch, kw in (("llama4", ARCHS[0], {}), ("arctic", ARCHS[1], {}),
                           ("llama4-dropping", ARCHS[0], dict(capacity_factor=0.5))):
        _, cfg = _cfgs(arch, **kw)
        out[name] = ("layer", cfg, _numpy_params(arch), _x(6, (4, 24, cfg.d_model)))
    _, cfg = configs(ARCHS[0], "float32", "float32")
    _, cfg = _cfgs(ARCHS[0], capacity_factor=8.0)
    x = _x(9, (4, 24, cfg.d_model))
    out["grad"] = ("grad", cfg, _numpy_params(ARCHS[0]), x, _x(10, x.shape))
    _, cfg = configs(ARCHS[0], "float32", "float32")
    toks = np.random.default_rng(8).integers(0, 256, (4, 12)).astype(np.int32)
    out["prefill"] = ("prefill", cfg, _tree(ARCHS[0], True, 0), toks, 16)
    return out


def _jax_answers(cases: dict) -> dict:
    mesh = jax_make_mesh(MESH, ("data", "model"))
    out = {}
    with mesh:
        for name, case in cases.items():
            jcfg = jax_config.ModelConfig(**dataclasses.asdict(case[1]))
            if case[0] == "grad":
                continue
            if case[0] == "layer":
                fn = jax.jit(lambda p, x, c=jcfg: jm.moe_apply(p, c, x, mesh=mesh))
                y, aux = fn(jax.tree.map(jnp.asarray, case[2]), jnp.asarray(case[3]))
                out[name] = (np.asarray(y), float(aux))
            else:
                model = JaxModel(jcfg, remat=False)
                fn = jax.jit(lambda p, b, m=model, s=case[4]: m.prefill(
                    p, b, s, dist=JaxDistContext(mesh=mesh)))
                logits, cache = fn(jax.tree.map(jnp.asarray, case[2]),
                                   {"tokens": jnp.asarray(case[3])})
                out[name] = (np.asarray(logits), jax.tree.map(np.asarray, cache))
    return out


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """``(per-rank outputs, JAX answers, cases)``: the world spawned
    first, the JAX answers computed while it runs, then joined."""
    tmp = tmp_path_factory.mktemp("moe")
    cases = _cases()
    with open(tmp / "cases.pkl", "wb") as f:
        pickle.dump(cases, f)
    world = int(np.prod(MESH))
    deadline = time.monotonic() + DEADLINE_S
    ctx = mp.start_processes(ranks.run_rank,
                             args=(world, MESH, str(tmp / "store"),
                                   str(tmp / "cases.pkl"), str(tmp)),
                             nprocs=world, join=False, start_method="spawn")
    try:
        want = _jax_answers(cases)
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                pytest.fail(f"the spawned ranks did not finish in {DEADLINE_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(10)
    got = []
    for r in range(world):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            got.append(pickle.load(f))
    return got, want, cases


def _rows(a, coords):
    rows = a.shape[0] // MESH[0]
    return a[coords[0] * rows:(coords[0] + 1) * rows]


@pytest.mark.parametrize("name", ["llama4", "arctic", "llama4-dropping"])
def test_expert_parallel_matches_jax(spawned, name):
    got, want, cases = spawned
    jy, jaux = want[name]
    assert sorted(r["coords"] for r in got) == [(i, j) for i in range(MESH[0])
                                                for j in range(MESH[1])]
    for r in got:
        y, aux = r[name]
        assert y.shape == _rows(jy, r["coords"]).shape
        assert rel(torch.from_numpy(y), _rows(jy, r["coords"])) <= EP_TOL, r["coords"]
        assert abs(aux - jaux) <= EP_AUX_TOL
        assert aux == got[0][name][1]                  # replicated
        twin = next(t for t in got if t["coords"][0] == r["coords"][0])
        assert np.array_equal(y, twin[name][0])         # the same over "model"
    if name == "llama4-dropping":
        _, cfg, tree, x = cases[name]
        params = _port(tree)
        C = pm.capacity(x.shape[1] * x.shape[0] // MESH[0], cfg)
        dropped = [(_port_routes(params, cfg, _rows(x, (i, 0)), C).slot == C).sum()
                   for i in range(MESH[0])]
        assert all(d > 0 for d in dropped), dropped


def test_expert_parallel_prefill_matches_jax(spawned):
    """``Model.prefill(dist=DistContext(mesh))`` of llama4-scout's smoke
    model on each rank's batch shard: its logits and every layer's K/V
    against the JAX prefill on the (2, 2) mesh."""
    got, want, cases = spawned
    jlogits, jcache = want["prefill"]
    cfg = cases["prefill"][1]
    for r in got:
        logits, layers = r["prefill"]
        assert rel(torch.from_numpy(logits), _rows(jlogits, r["coords"])) <= EP_TOL
        assert len(layers) == cfg.num_layers
        for i, slot in enumerate(layers):
            for leaf in ("k", "v"):
                ref = _rows(jcache["blocks"]["p0"]["attn"][leaf][i], r["coords"])
                assert rel(torch.from_numpy(slot[leaf]), ref) <= EP_TOL, (i, leaf)


def test_expert_parallel_gradients_match_local(spawned):
    """The gradient of ``sum(y * ct)`` through the expert-parallel layer
    on the (2, 2) world, with a capacity factor of 8 (no pair dropped):
    each rank's ``x`` rows, its expert slices (summed over data by the
    gather's reduce-scatter, the mean over the two model ranks that send
    the same tokens) and the router, norm and shared expert summed over
    data, against the local layer's on the whole batch."""
    got, _, cases = spawned
    _, cfg, tree, x, ct = cases["grad"]
    params = {k: v for k, v in _port(tree).items()}
    from repro_torch.tree import leaves_with_path, map_tree

    params = map_tree(lambda t: t.requires_grad_(True), params)
    xt = torch.from_numpy(x).requires_grad_(True)
    y, _ = pm.moe_apply(params, cfg, xt)
    (y * torch.from_numpy(ct)).sum().backward()
    for r in got:
        g = r["grad"]
        i, j = r["coords"]
        assert rel(torch.from_numpy(g["x"]), _rows(xt.grad.numpy(), r["coords"])) <= EP_TOL
        for path, leaf in leaves_with_path(params):
            want = leaf.grad
            if path in ("['wi']", "['wg']", "['wo']"):
                E, A = want.shape[:2]
                want = want[j * E // 2:(j + 1) * E // 2, i * A // 2:(i + 1) * A // 2]
            assert float(want.abs().max()) > 0, path
            assert rel(torch.from_numpy(g[path]), want) <= EP_TOL, (path, r["coords"])
