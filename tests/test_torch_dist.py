"""The port's distributed solve (``strategy="distributed"``,
:mod:`repro_torch.core.dist`) against the JAX package's.

* Host side: ``shard_schedule`` and ``build_packed_dist_layout`` array for
  array against JAX for 1, 2, 4 and 8 ranks, plain and coarsened, both
  directions; the collective counts and bytes.
* Ranks: worlds of 2 and 4 gloo processes (``spawn``, a ``FileStore``, one
  spawn per world for the module, under a hard deadline) run every case of
  ``tests/_torch_dist_ranks.py`` — both layouts x ``all_gather``/``psum`` x
  plain/rewrite/coarsen on the JAX tests' random factor and a small lung2,
  both directions, one and three right-hand sides — then a refresh and a
  guarded solve.  The parent computes the JAX ``distributed`` answers
  while the ranks run (the random factor on ``Mesh(jax.devices()[:2])``,
  lung2 on four devices: each JAX compile takes seconds, and a row's
  arithmetic does not depend on the shard it lands in), and holds every
  rank's answer against them, every rank against rank 0 (bitwise), the
  world of 2 against the world of 4, and the collectives per solve against
  JAX's ``num_collectives`` for that world.
* In process: a world of one (gloo) ``build_pair``, and the option errors.
"""
import pickle
import time
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from jax.sharding import Mesh

import repro.core.codegen as j_codegen
import repro.core.coarsen as j_coarsen
import repro.core.dist as j_dist
import repro.sparse as jsparse
from repro.compat import enable_x64
from repro.core import RewriteConfig as JaxRewriteConfig
from repro.core import SpTRSV as JaxSpTRSV

import repro_torch.core.codegen as t_codegen
import repro_torch.core.coarsen as t_coarsen
import repro_torch.core.dist as t_dist
import repro_torch.sparse as tsparse
from repro_torch.core import CSRMatrix, GuardConfig, SpTRSV
from repro_torch.launch import mesh as t_mesh
from repro_torch.launch.mesh import init_process_group, local_mesh, make_mesh

import _torch_dist_ranks as ranks
from _torch_parity import TOL, assert_same, systems, to_port

WORLDS = (2, 4)
# seconds the spawned worlds may take, start to finish, before they are
# killed and the tests fail
DEADLINE_S = 240.0
# the mesh size of each matrix's JAX reference
JAX_WORLD = {"random": 2, "lung2": 4}


# -------------------------------------------------------------------------
# host side: the sharded schedule and the packed layout
# -------------------------------------------------------------------------
def _schedules(name, transpose, coarsen):
    sj, st, lj, lt = systems(name, transpose)
    a = j_codegen.build_schedule(sj, lj, upper=transpose)
    b = t_codegen.build_schedule(st, lt, upper=transpose)
    if coarsen:
        a = j_coarsen.coarsen_schedule(a, j_coarsen.CoarsenConfig())
        b = t_coarsen.coarsen_schedule(b, t_coarsen.CoarsenConfig())
    return a, b


@pytest.mark.parametrize("ndev", [1, 2, 4, 8])
@pytest.mark.parametrize("coarsen", [False, True])
@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("name", ["lung2", "random"])
def test_sharded_schedule_and_layout_match(name, transpose, coarsen, ndev):
    a, b = _schedules(name, transpose, coarsen)
    dj, dt = j_dist.shard_schedule(a, ndev), t_dist.shard_schedule(b, ndev)
    assert_same(dt, dj)
    assert (dt.num_levels, dt.num_collectives) == (dj.num_levels,
                                                   dj.num_collectives)
    for strategy in t_dist.DIST_STRATEGIES:
        for itemsize, batch in ((4, 1), (8, 1), (8, 3)):
            assert dt.collective_bytes(itemsize, strategy, batch) == \
                dj.collective_bytes(itemsize, strategy, batch)
    pj = j_dist.build_packed_dist_layout(a, ndev)
    pt = t_dist.build_packed_dist_layout(b, ndev)
    assert_same(pt, pj)
    assert_same(pt.stats(), pj.stats())
    for seg in pt.segments:
        if seg.kind == "plain":
            assert seg.R_pad % ndev == 0 and seg.off + seg.R_pad <= pt.n_pad


def test_collective_accounting_with_coarsening():
    """One collective per sharded segment, none per replicated chain; a
    batch multiplies the payload and keeps the count."""
    _, b = _schedules("lung2", False, False)
    _, co = _schedules("lung2", False, True)
    d_plain, d_co = t_dist.shard_schedule(b, 4), t_dist.shard_schedule(co, 4)
    assert d_plain.num_collectives == b.num_segments
    assert d_co.num_collectives == sum(s.depth == 1 for s in co.slabs)
    assert d_co.num_collectives < d_plain.num_collectives
    assert d_co.collective_bytes(batch=8) == 8 * d_co.collective_bytes()
    assert d_co.collective_bytes(4, "psum") == \
        d_co.num_collectives * 2 * (b.n + 1) * 4


# -------------------------------------------------------------------------
# spawned gloo ranks against the JAX distributed solve
# -------------------------------------------------------------------------
def _jax_answers() -> dict:
    """The JAX ``distributed`` answers (f64, three right-hand sides) of every
    (matrix, transform) and direction on ``Mesh(jax.devices()[:w])`` with
    ``w = JAX_WORLD[matrix]``, and the collectives per solve JAX's schedule
    gives for each world of :data:`WORLDS`."""
    out = {}
    with enable_x64():
        for name in ranks.MATRICES:
            mesh = Mesh(np.array(jax.devices()[:JAX_WORLD[name]]), ("data",))
            L = ranks.matrix(name, jsparse)
            B = jnp.asarray(ranks.rhs(L.n))
            for transform in ranks.TRANSFORMS:
                pair = JaxSpTRSV.build_pair(
                    L, strategy="distributed", mesh=mesh,
                    **ranks.transform_kwargs(name, transform,
                                             JaxRewriteConfig))
                for s in pair:
                    out[name, transform, s.transpose] = (
                        np.asarray(s.solve(B)),
                        {w: j_dist.shard_schedule(s.schedule, w).num_collectives
                         for w in WORLDS})
    return out


def _spawn(world: int, tmp):
    store = tmp / f"store{world}"
    out = tmp / f"out{world}"
    out.mkdir()
    ctx = mp.start_processes(ranks.run_rank, args=(world, str(store), str(out)),
                             nprocs=world, join=False, start_method="spawn")
    return ctx, out


def _join(ctx, deadline: float) -> None:
    try:
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                pytest.fail(f"the spawned ranks did not finish in {DEADLINE_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(10)


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """``{world: (per-rank results, JAX answers)}``: both worlds spawned
    first, the JAX answers computed while they run, then joined."""
    tmp = tmp_path_factory.mktemp("dist")
    deadline = time.monotonic() + DEADLINE_S
    started = {w: _spawn(w, tmp) for w in WORLDS}
    try:
        want = _jax_answers()
    finally:
        for ctx, _ in started.values():
            _join(ctx, deadline)
    got = {}
    for w, (_, out) in started.items():
        got[w] = []
        for r in range(w):
            with open(out / f"rank{r}.pkl", "rb") as f:
                got[w].append(pickle.load(f))
    return {w: (got[w], want) for w in WORLDS}


def test_rank_matrices_are_the_jax_ones():
    for name in ranks.MATRICES:
        assert_same(ranks.matrix(name, tsparse),
                    to_port(ranks.matrix(name, jsparse)))


@pytest.mark.parametrize("transform", ranks.TRANSFORMS)
@pytest.mark.parametrize("name", sorted(ranks.MATRICES))
@pytest.mark.parametrize("world", WORLDS)
def test_ranks_match_jax(spawned, world, name, transform):
    results, want = spawned[world]
    answers = results[0]["answers"]
    for layout in ranks.LAYOUTS:
        for ds in ranks.DIST_STRATEGIES:
            for transpose in (False, True):
                ref, n_colls = want[name, transform, transpose]
                n_coll = n_colls[world]
                for m in ranks.WIDTHS:
                    key = (name, transform, layout, ds, transpose, m)
                    expect = ref[:, 0] if m == 1 else ref
                    np.testing.assert_allclose(answers[key], expect,
                                               **TOL[np.float64],
                                               err_msg=str(key))
                    counts = results[0]["counts"][key]
                    assert counts[ds] == n_coll, (key, counts, n_coll)
                    assert sum(counts.values()) == n_coll, (key, counts)
                    if ds == "psum":
                        # psum adds zeros to zeros: the same bits as the
                        # value all_gather (signed zeros aside)
                        assert np.array_equal(
                            answers[key],
                            answers[key[:3] + ("all_gather",) + key[4:]])


@pytest.mark.parametrize("world", WORLDS)
def test_every_rank_returns_rank0s_answer(spawned, world):
    results, _ = spawned[world]
    assert len(results) == world
    for r in range(1, world):
        assert results[r]["answers"].keys() == results[0]["answers"].keys()
        for key, x in results[r]["answers"].items():
            assert np.array_equal(x, results[0]["answers"][key],
                                  equal_nan=True), (r, key)
        assert results[r]["counts"] == results[0]["counts"]


def test_answers_do_not_depend_on_the_world(spawned):
    """A row's terms are the same whichever shard holds it: the world of 2
    and the world of 4 agree to rounding (a batched shard's sum over the
    ELL width may vectorise in another order)."""
    small, big = (spawned[w][0][0]["answers"] for w in WORLDS)
    assert small.keys() == big.keys()
    for key, x in small.items():
        np.testing.assert_allclose(x, big[key], **TOL[np.float64],
                                   err_msg=str(key))


@pytest.mark.parametrize("world", WORLDS)
def test_ranks_refresh_and_guard(spawned, world):
    """Refresh (in place for the permuted layout, cold for the scatter one)
    equals a fresh build on the new values and solves the new system; a
    guarded ``psum`` solve verifies and solves the original system."""
    answers = spawned[world][0][0]["answers"]
    L = ranks.matrix("lung2", jsparse)
    B = ranks.rhs(L.n)
    data = jsparse.refresh_values(L, seed=2)
    dense_new = CSRMatrix(L.indptr, L.indices, data, L.shape).to_dense()
    dense = L.to_dense()
    for layout in ranks.LAYOUTS:
        for transpose in (False, True):
            got = answers["refresh", layout, transpose]
            np.testing.assert_allclose(got, answers["fresh", layout, transpose],
                                       **TOL[np.float64])
            A = dense_new.T if transpose else dense_new
            np.testing.assert_allclose(got, np.linalg.solve(A, B),
                                       **TOL[np.float64])
            A = dense.T if transpose else dense
            np.testing.assert_allclose(answers["guard", layout, transpose],
                                       np.linalg.solve(A, B), **TOL[np.float64])


# -------------------------------------------------------------------------
# in process: a world of one, and the option errors
# -------------------------------------------------------------------------
@pytest.fixture
def world_of_one():
    mesh = make_mesh((1,), ("data",), device="cpu")
    try:
        yield mesh
    finally:
        t_mesh.destroy_process_group()


@pytest.mark.parametrize("layout", ["permuted", "scatter"])
def test_world_of_one_build_pair(world_of_one, layout):
    L = to_port(ranks.matrix("lung2", jsparse))
    B = torch.from_numpy(ranks.rhs(L.n))
    dense = L.to_dense()
    ref = SpTRSV.build_pair(L, strategy="levelset", coarsen=True, device="cpu")
    for ds in t_dist.DIST_STRATEGIES:
        pair = SpTRSV.build_pair(L, strategy="distributed", mesh=world_of_one,
                                 dist_strategy=ds, layout=layout, coarsen=True,
                                 device="cpu")
        for s, r in zip(pair, ref):
            assert s.strategy == "distributed" and s.layout == layout
            assert s.stats()["refreshable_in_place"] == (layout == "permuted")
            for b in (B[:, 0].contiguous(), B):
                t_dist.reset_collectives()
                x = s.solve(b)
                assert t_dist.collectives[ds] == \
                    sum(sl.depth == 1 for sl in s.schedule.slabs)
                np.testing.assert_allclose(x.numpy(), r.solve(b).numpy(),
                                           **TOL[np.float64])
                A = dense.T if s.transpose else dense
                np.testing.assert_allclose(x.numpy(),
                                           np.linalg.solve(A, b.numpy()),
                                           **TOL[np.float64])


def test_world_of_one_mixed_precision_guard(world_of_one):
    """bf16 value storage, refined to the f64 tolerance by the guard."""
    L = to_port(ranks.matrix("random", jsparse))
    b = torch.from_numpy(ranks.rhs(L.n)[:, 0].copy())
    s = SpTRSV.build(L, strategy="distributed", mesh=world_of_one,
                     guard=GuardConfig(precision="mixed"), device="cpu")
    assert s._values[0].dtype == torch.bfloat16
    np.testing.assert_allclose(s.solve(b).numpy(),
                               np.linalg.solve(L.to_dense(), b.numpy()),
                               rtol=1e-9, atol=1e-10)


def test_distributed_option_errors(world_of_one):
    L = to_port(ranks.matrix("random", jsparse))
    with pytest.raises(ValueError, match="needs a mesh"):
        SpTRSV.build(L, strategy="distributed", device="cpu")
    with pytest.raises(ValueError, match="needs a mesh"):
        SpTRSV.build_pair(L, strategy="distributed", device="cpu")
    with pytest.raises(ValueError, match="dist_strategy"):
        SpTRSV.build(L, strategy="distributed", mesh=world_of_one,
                     dist_strategy="ring", device="cpu")
    with pytest.raises(ValueError, match="no dimension"):
        SpTRSV.build(L, strategy="distributed", mesh=world_of_one,
                     mesh_axis="model", device="cpu")
    card_mesh = types.SimpleNamespace(device_type="cuda",
                                      mesh_dim_names=("data",),
                                      size=lambda dim: 1)
    with pytest.raises(ValueError, match="mesh is on 'cuda'"):
        SpTRSV.build_pair(L, strategy="distributed", mesh=card_mesh,
                          device="cpu")
    with pytest.raises(RuntimeError, match="already exists"):
        init_process_group(1, device="cpu")


def test_local_mesh_spans_the_world(world_of_one):
    mesh = local_mesh(device="cpu")
    assert mesh.mesh_dim_names == ("data", "model")
    assert (t_dist.axis_size(mesh, "data"), t_dist.axis_size(mesh, "model")) \
        == (1, 1)
    with pytest.raises(ValueError, match="divide"):
        local_mesh(2, device="cpu")


def test_world_of_one_store_goes_with_its_group():
    make_mesh((1,), ("data",), device="cpu")
    store_dir = Path(t_mesh._store_dir)
    assert store_dir.is_dir()
    t_mesh.destroy_process_group()
    assert t_mesh._store_dir is None and not store_dir.exists()


def test_mesh_needs_a_store_for_many_ranks():
    with pytest.raises(ValueError, match="store"):
        init_process_group(2, device="cpu", rank=0)
    with pytest.raises(ValueError, match="differ"):
        make_mesh((1, 1), ("data",), device="cpu")
