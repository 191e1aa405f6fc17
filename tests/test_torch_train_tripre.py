"""tripre, the SpTRSV-preconditioned optimizer, against the JAX package on
the CPU: ``banded_ichol`` exactly, ``make_banded_solvers``' levels,
rewrite statistics and solution, and six ``update`` steps across a
refresh over the same tree.  Then the two reference faults it meets at the
model level: the JAX ``tripre`` preconditions no matrix of a scanned block
(ROADMAP C-ref 13), and a jitted JAX train step with it cannot run
(C-ref 14); the port's launcher takes its steps with it.  And the
reference's incomplete Cholesky, which breaks down on a Gram of the
per-layer tree (C-ref 15)."""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_train_parity import worst, one_torch_thread  # noqa: F401

from repro.configs import smoke_config as jax_smoke_config
from repro.models.model import Model as JaxModel
from repro.optim.optimizers import get_optimizer as jax_get_optimizer
from repro.train.steps import make_train_step as jax_make_train_step
from repro_torch.configs import smoke_config
from repro_torch.models.model import Model
from repro_torch.tree import leaves_with_path

# the modules (each package's ``optim`` exports the function ``tripre``)
jax_tripre_mod = importlib.import_module("repro.optim.tripre")
tripre_mod = importlib.import_module("repro_torch.optim.tripre")

# f32 solves and updates: the same rewrite and level order in both, summed
# in another order
SOLVE_TOL = 1e-5
UPDATE_TOL = 1e-5


def _gram(n: int, seed: int) -> np.ndarray:
    g = np.random.default_rng(seed).standard_normal((n, 3 * n)).astype(np.float32)
    return (g @ g.T / g.shape[1]).astype(np.float32)


@pytest.mark.parametrize("n, band", [(40, 4), (64, 8)])
def test_banded_ichol_is_the_reference(n, band):
    G = _gram(n, n)
    got = tripre_mod.banded_ichol(G, band)
    want = jax_tripre_mod.banded_ichol(G, band)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert np.allclose(np.triu(got, 1), 0) and np.allclose(np.tril(got, -band - 1), 0)


@pytest.mark.parametrize("use_rewrite", [True, False])
def test_banded_solvers_match_jax(use_rewrite):
    L_np = tripre_mod.banded_ichol(_gram(48, 3), 8)
    solve, fwd, bwd = tripre_mod.make_banded_solvers(L_np, use_rewrite=use_rewrite,
                                                     device="cpu")
    jsolve, jfwd, jbwd = jax_tripre_mod.make_banded_solvers(L_np, use_rewrite=use_rewrite)
    for s, js in ((fwd, jfwd), (bwd, jbwd)):
        assert s.analysis.num_levels == js.analysis.num_levels
        if use_rewrite:
            got, want = (dataclasses.asdict(x.rewrite_result.stats) for x in (s, js))
            assert got.keys() == want.keys()
            for key in got:
                assert np.array_equal(got[key], want[key]), key
            assert s.rewrite_result.stats.levels_after < s.rewrite_result.stats.levels_before
        else:
            assert s.rewrite_result is None
    g = np.random.default_rng(4).standard_normal((48, 5)).astype(np.float32)
    want = np.asarray(jax.vmap(jsolve, in_axes=1, out_axes=1)(jnp.asarray(g)))
    got = solve(torch.from_numpy(g))
    assert got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() <= SOLVE_TOL * np.abs(want).max()
    dense = np.linalg.solve(L_np.T, np.linalg.solve(L_np, g.astype(np.float64)))
    assert np.abs(got.numpy() - dense).max() <= 1e-4 * np.abs(dense).max()


def test_factor_raises_the_shift_where_the_reference_breaks_down():
    """ROADMAP C-ref 15: on a low-rank Gram the reference's banded
    incomplete Cholesky floors a pivot at 1e-12 and overflows; the port's
    refresh raises the diagonal shift tenfold until no pivot breaks down,
    and keeps the reference's factor where it holds."""
    g = np.random.default_rng(0).standard_normal((16, 3)).astype(np.float32) * 10
    G = (g @ g.T / 3).astype(np.float32)
    with np.errstate(over="ignore", invalid="ignore"):
        ref = jax_tripre_mod.banded_ichol(G, 4)
    assert not np.isfinite(ref).all() or np.diag(ref).min() <= 1e-6
    L, shift = tripre_mod.factor(G, 4)
    assert shift > tripre_mod.SHIFT and np.isfinite(L).all()
    assert np.diag(L).min() > 1e-6
    assert np.array_equal(L, tripre_mod.banded_ichol(G, 4, shift))
    healthy = _gram(40, 40)
    L, shift = tripre_mod.factor(healthy, 4)
    assert shift == tripre_mod.SHIFT
    assert np.array_equal(L, jax_tripre_mod.banded_ichol(healthy, 4))


def _tree(rng):
    """Matrices on both sides of ``max_dim`` 24, wide and tall, a vector and
    a 3-D leaf (neither eligible)."""
    shapes = {"wide": (12, 40), "tall": (30, 8), "vec": (16,), "cube": (4, 6, 5),
              "big": [(30, 30), (50, 20)]}
    return jax.tree.map(lambda s: rng.standard_normal(s).astype(np.float32), shapes,
                        is_leaf=lambda s: isinstance(s, tuple))


def test_tripre_updates_match_jax_across_a_refresh():
    rng = np.random.default_rng(9)
    params = _tree(rng)
    opts = dict(lr=1e-2, band=4, refresh_every=5, max_dim=24, weight_decay=0.01)
    jo, po = jax_tripre_mod.tripre(**opts), tripre_mod.tripre(**opts)
    jp, pp = jax.tree.map(jnp.asarray, params), jax.tree.map(torch.tensor, params)
    js, ps = jo.init(jp), po.init(pp)
    eligible = {k for k, G in leaves_with_path(ps["G"]) if G.numel()}
    assert eligible == {"['wide']", "['tall']", "['big'][1]"}
    for step in range(6):      # refreshes at steps 1 and 6
        g = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32),
                         params)
        jp, js = jo.update(jax.tree.map(jnp.asarray, g), js, jp)
        pp, ps = po.update(jax.tree.map(torch.tensor, g), ps, pp)
        for what, got, want in (("params", pp, jp), ("m", ps["m"], js["m"]),
                                ("G", ps["G"], js["G"])):
            err, leaf = worst(got, jax.tree.map(lambda a: torch.tensor(np.asarray(a)),
                                                want))
            assert err <= UPDATE_TOL, (step, what, leaf, err)
    assert int(ps["step"]) == 6 and len(po.stats["refresh_s"]) == 2
    assert set(po.stats["factors"]) == eligible
    for f in po.stats["factors"].values():
        assert f["levels_after"] <= f["levels_before"] == f["n"]
        assert f["shift"] == tripre_mod.SHIFT


def test_jax_tripre_preconditions_no_scanned_block_matrix():
    """ROADMAP C-ref 13: the JAX model stacks each scanned block, so its
    block matrices are 3-D and its norm scales 2-D ``(reps, D)``; its
    ``tripre`` gives a Gram to the embedding and to the 12 stacked scales
    (1x1 each) of gemma3-1b's smoke model, and to none of its matrices.
    The port's per-layer tree gives one to every 2-D block matrix."""
    cfg = jax_smoke_config("gemma3-1b")
    params = jax.eval_shape(JaxModel(cfg, remat=False).init, jax.random.key(0))
    params = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), params)
    G = jax_tripre_mod.tripre().init(params)["G"]
    grams = {jax.tree_util.keystr(k): g.shape
             for k, g in jax.tree_util.tree_flatten_with_path(G)[0] if g.size}
    assert len(grams) == 13
    assert grams.pop("['embed']['tok']") == (64, 64)
    assert all(k.endswith("['ln']['scale']") and s == (1, 1) for k, s in grams.items())
    pcfg = smoke_config("gemma3-1b")
    pp = Model(pcfg, device="cpu").init(torch.Generator().manual_seed(0), masters=True)
    port = {k for k, g in leaves_with_path(tripre_mod.tripre().init(pp)["G"]) if g.numel()}
    # o, and the MLP's wi, wg, wo in every layer, and the embedding
    assert len(port) == 4 * pcfg.num_layers + 1
    assert "['layers'][0]['ffn']['wi']['w']" in port


def test_jitted_jax_train_step_with_tripre_raises():
    """ROADMAP C-ref 14: tripre reads ``int(state["step"])``, a tracer under
    the JAX Trainer's jit.  (Its Trainer then retries the step without end,
    so the step is called directly.)"""
    cfg = jax_smoke_config("gemma3-1b")
    model = JaxModel(cfg, remat=False)
    params = model.init(jax.random.key(0))
    opt = jax_get_optimizer("tripre", lr=1e-3, total_steps=4, band=4, max_dim=256)
    toks = np.zeros((2, 8), np.int32)
    batch = {"tokens": toks, "labels": toks}
    with pytest.raises(jax.errors.ConcretizationTypeError):
        jax.jit(jax_make_train_step(model, opt))(params, opt.init(params), batch)


def test_port_launcher_takes_its_steps_with_tripre(tmp_path):
    from repro_torch.launch import train

    out = train.main(["--smoke", "--device", "cpu", "--optimizer", "tripre",
                      "--steps", "3", "--seq", "16", "--batch", "2",
                      "--ckpt-dir", str(tmp_path), "--max-recoveries", "0"])
    assert out["final_step"] == 3 and out["recoveries"] == 0
    assert len(out["history"]) == 3 and np.isfinite(out["history"]).all()
    stats = out["optimizer"].stats
    assert len(stats["factors"]) == 4 * 6 + 1 and len(stats["refresh_s"]) == 1
