"""The port's sharding rules (``repro_torch.models.sharding``) against the
JAX package's ``models/sharding.py``, on meshes without ranks.

The rules read only a mesh's dimension names and sizes: the JAX side gets
a stand-in with ``.shape`` and ``.axis_names``, the port's side a
``MeshShape``.  Each arch's smoke configuration runs on the meshes ``(8,
1)``, ``(4, 2)``, ``(2, 4)`` and ``(1, 8)``, its full configuration on the
production meshes ``(16, 16)`` and ``(2, 16, 16)`` (with ``"pod"``), under
both policies.  The JAX parameters and caches are abstract
(``jax.eval_shape``), the port's are on the ``meta`` device.  Every spec is
held exactly, leaf for leaf: a scanned layer's port spec is the JAX spec of
its stacked leaf without the leading None.
"""
import functools
import types

import jax
import numpy as np
import pytest
import torch

from repro.models import config as jax_config
from repro.models import sharding as js
from repro.models.model import Model as JaxModel
from repro.optim import get_optimizer as jax_get_optimizer
from repro_torch.configs import ARCH_IDS
from repro_torch.models import config as port_config
from repro_torch.models import sharding as ps
from repro_torch.models.convert import jax_paths, scanned_layers
from repro_torch.models.model import Model

SMALL = ((8, 1), (4, 2), (2, 4), (1, 8))
PRODUCTION = ((16, 16), (2, 16, 16))


def _meshes(shape):
    names = ("pod", "data", "model")[-len(shape):]
    jmesh = types.SimpleNamespace(shape=dict(zip(names, shape)), axis_names=names)
    return jmesh, ps.MeshShape(tuple(shape), names)


@functools.lru_cache(maxsize=None)
def _models(arch: str, full: bool):
    get = "get_config" if full else "smoke_config"
    jcfg = getattr(jax_config, get)(arch)
    cfg = getattr(port_config, get)(arch)
    jparams = jax.eval_shape(JaxModel(jcfg, remat=False).init, jax.random.key(0))
    params = Model(cfg, device="meta").init()
    return jcfg, cfg, jparams, params


def _port_layout(jtree: dict, cfg, cache: bool = False) -> dict:
    """A JAX spec tree in the port's layout: one entry per layer, a scanned
    layer's specs without their leading None (a cache layer's one group,
    ``attn`` or the recurrent kind's, unwrapped)."""
    def inner(t):
        return next(iter(t.values())) if cache else t

    def unstack(t):
        return jax.tree.map(lambda s: tuple(s)[1:], inner(t), is_leaf=_is_spec)

    def plain(t):
        return jax.tree.map(tuple, t, is_leaf=_is_spec)

    n_scan, n_pat = scanned_layers(cfg), len(cfg.block_pattern)
    out = {k: plain(v) for k, v in jtree.items()
           if k not in ("blocks", "tail", "encoder")}
    out["layers"] = ([unstack(jtree["blocks"][f"p{i % n_pat}"]) for i in range(n_scan)]
                     + [plain(inner(t)) for t in jtree["tail"]])
    if "encoder" in jtree:
        enc = jtree["encoder"]
        out["encoder"] = {"layers": [unstack(enc["blocks"]["p0"])] * cfg.encoder_layers,
                          "ln": plain(enc["ln"])}
    return out


def _is_spec(x):
    return isinstance(x, (jax.sharding.PartitionSpec, ps.P))


def _assert_same(got, want, path="") -> int:
    """``got`` (port specs) equals ``want`` (tuples) leaf for leaf; returns
    the leaves compared."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        return sum(_assert_same(got[k], want[k], f"{path}/{k}") for k in want)
    if isinstance(want, list):
        assert len(got) == len(want), path
        return sum(_assert_same(g, w, f"{path}[{i}]")
                   for i, (g, w) in enumerate(zip(got, want)))
    assert isinstance(got, ps.P), (path, got)
    assert tuple(got) == tuple(want), (path, got, want)
    return 1


def _cases():
    for arch in ARCH_IDS:
        for shape in SMALL:
            yield arch, False, shape
        for shape in PRODUCTION:
            yield arch, True, shape


CASES = list(_cases())
IDS = [f"{a}-{'full' if f else 'smoke'}-{'x'.join(map(str, s))}" for a, f, s in CASES]


@pytest.mark.parametrize("arch,full,shape", CASES, ids=IDS)
def test_param_and_state_specs_match_jax(arch, full, shape):
    jcfg, cfg, jparams, params = _models(arch, full)
    jmesh, mesh = _meshes(shape)
    for policy in ("2d", "fsdp_only"):
        want = js.param_specs(jparams, jmesh, jcfg, js.POLICIES[policy])
        got = ps.param_specs(params, mesh, cfg, ps.POLICIES[policy])
        n = _assert_same(got, _port_layout(want, cfg))
        assert n == len(jax.tree.leaves(params, is_leaf=torch.is_tensor))
        # the optimizer-state rule, on the JAX trees themselves: the same
        # function of the same leaves (its quirk included, C-ref 16)
        jstate = jax.eval_shape(jax_get_optimizer("adafactor").init, jparams)
        state_specs = js.opt_state_specs(want, jstate)
        port_specs = jax.tree.map(lambda s: ps.P(*s), want, is_leaf=_is_spec)
        meta = jax.tree.map(lambda a: torch.empty(a.shape, device="meta"), jstate)
        port_state = ps.opt_state_specs(port_specs, meta)
        flat_want = jax.tree.leaves(state_specs, is_leaf=_is_spec)
        flat_got = ps._spec_leaves(port_state)
        assert [tuple(s) for s in flat_got] == [tuple(s) for s in flat_want]


@pytest.mark.parametrize("arch,full,shape", CASES, ids=IDS)
def test_cache_and_batch_specs_match_jax(arch, full, shape):
    jcfg, cfg, _, _ = _models(arch, full)
    jmesh, mesh = _meshes(shape)
    s_cache = 4096 if full else 64
    for B in (16, 4, 1):
        jcache = jax.eval_shape(lambda: JaxModel(jcfg, remat=False).init_cache(B, s_cache))
        cache = Model(cfg, device="meta").init_cache(B, s_cache)
        want = js.cache_specs(jcache, jmesh, jcfg)
        got = ps.cache_specs(cache, mesh, cfg)
        want_port = _port_layout(want, cfg, cache=True)
        assert tuple(got["idx"]) == tuple(want_port.pop("idx")) == ()
        got = {k: v for k, v in got.items() if k != "idx"}
        _assert_same(got, want_port)
        shapes = {"tokens": (B, 32), "labels": (B, 32), "patches": (B, 8, 64)}
        jb = js.batch_specs(jmesh, {k: jax.ShapeDtypeStruct(s, np.int32)
                                    for k, s in shapes.items()})
        pb = ps.batch_specs(mesh, {k: np.zeros(s, np.int32) for k, s in shapes.items()})
        _assert_same(pb, jax.tree.map(tuple, jb, is_leaf=_is_spec))


def test_jax_paths_name_the_reference_leaves():
    """Every port leaf's JAX path is a leaf of the JAX tree, and the port's
    leaf has the JAX leaf's shape without its stacked axis where scanned."""
    jcfg, cfg, jparams, params = _models("whisper-medium", False)
    paths = jax_paths(params, cfg)
    flat = dict((js._path_str(p), leaf) for p, leaf in
                jax.tree_util.tree_flatten_with_path(jparams)[0])
    seen = set()
    for path, leaf in zip(jax.tree.leaves(paths), jax.tree.leaves(params,
                                                                   is_leaf=torch.is_tensor)):
        want = flat[path].shape
        stacked = "blocks/" in path
        assert tuple(leaf.shape) == (want[1:] if stacked else want), path
        seen.add(path)
    assert seen == set(flat)


def test_placements_and_slices_on_a_stand_in_mesh():
    """Placements follow the spec in the mesh's order; a rank's block is
    its row-major index among the named dimensions."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = types.SimpleNamespace(mesh_dim_names=("data", "model"), shape=(2, 4),
                                 size=lambda d: (2, 4)[d],
                                 get_local_rank=lambda a: {"data": 1, "model": 2}[a])
    assert ps.placements(ps.P(("data", "model"), None), mesh) == (Shard(0), Shard(0))
    assert ps.placements(ps.P(None, "model"), mesh) == (Replicate(), Shard(1))
    with pytest.raises(ValueError, match="order"):
        ps.placements(ps.P(("model", "data")), mesh)
    full = torch.arange(16 * 8).reshape(16, 8)
    assert torch.equal(ps.local_slice(full, ps.P(("data", "model"), None), mesh),
                       full[12:14])
    assert torch.equal(ps.local_slice(full, ps.P("data", "model"), mesh),
                       full[8:16, 4:6])
    assert torch.equal(ps.local_slice(full, ps.P(None, None), mesh), full)
    with pytest.raises(ValueError, match="split"):
        ps.local_slice(torch.zeros(6, 3), ps.P(None, "model"), mesh)
    with pytest.raises(ValueError, match="length"):
        ps.MeshShape((2, 2), ("data",))
