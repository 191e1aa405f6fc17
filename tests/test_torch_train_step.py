"""The optimizers and the train step against the JAX package on the CPU:
the schedule and the clipping, each optimizer's updates on the same
gradients, and one ``make_train_step`` step of each optimizer (f32).

The model is gemma3-1b's smoke configuration with one pattern repetition
and two tail layers (:mod:`_torch_lm_parity`): adafactor factors and
clips per leaf, and with one repetition the JAX stacked leaves and the
port's per-layer leaves agree (``repro_torch.optim.optimizers``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm_parity import pair
from _torch_train_parity import batch, to_port, worst, one_torch_thread  # noqa: F401

from repro.optim import optimizers as jopt
from repro.train.steps import make_train_step as jax_make_train_step
from repro_torch.optim import optimizers as popt
from repro_torch.train.steps import make_train_step

ARCH = "gemma3-1b"
# f32 parameters and optimizer state after one step, max-norm relative per
# leaf
STEP_TOL = 1e-4
# adamw's first step moves an element by lr * g / (|g| + eps): where the
# gradient is within rounding of 0 its direction is rounding too, so its
# parameters are held to lr / 10 of the largest entry's scale (measured
# 2.8e-4) and its moments m and v to STEP_TOL
ADAMW_PARAM_TOL = 1e-3
# the optimizers alone on the same gradients
UPDATE_TOL = 1e-6


def test_cosine_schedule_matches_jax():
    for warmup, total in ((3, 10), (0, 6), (100, 1000)):
        want = jopt.cosine_schedule(3e-3, warmup, total)
        got = popt.cosine_schedule(3e-3, warmup, total)
        for step in range(0, total + 3):
            w = float(want(jnp.asarray(step, jnp.int32)))
            g = got(torch.tensor(step, dtype=torch.int32))
            assert g.dtype == torch.float32
            # near the end 1 + cos(pi t) cancels: one ulp of the cosine,
            # XLA's against torch's, is base_lr * 6e-8
            np.testing.assert_allclose(float(g), w, rtol=1e-6, atol=3e-3 * 1e-7)


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_by_global_norm_matches_jax(max_norm):
    rng = np.random.default_rng(3)
    tree = {"a": rng.standard_normal((5, 7)).astype(np.float32),
            "b": [rng.standard_normal(4).astype(np.float32),
                  {"c": rng.standard_normal((2, 3, 2)).astype(np.float32)}]}
    want, wn = jopt.clip_by_global_norm(jax.tree.map(jnp.asarray, tree), max_norm)
    got, gn = popt.clip_by_global_norm(jax.tree.map(torch.tensor, tree), max_norm)
    np.testing.assert_allclose(float(gn), float(wn), rtol=1e-6)
    for w, g in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)


OPTIMIZERS = ("adamw", "adafactor", "sgd")


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_optimizer_updates_match_jax(name):
    """Three updates of each optimizer on the same gradients, over a tree
    of matrices, vectors and a 3-D leaf."""
    rng = np.random.default_rng(11)
    shapes = {"w": (6, 9), "b": (9,), "e": [(4, 3, 5), (7, 7)]}
    params = jax.tree.map(lambda s: rng.standard_normal(s).astype(np.float32),
                          shapes, is_leaf=lambda s: isinstance(s, tuple))
    jo = jopt.get_optimizer(name, lr=1e-2, total_steps=10)
    po = popt.get_optimizer(name, lr=1e-2, total_steps=10)
    jp, pp = jax.tree.map(jnp.asarray, params), jax.tree.map(torch.tensor, params)
    js, ps = jo.init(jp), po.init(pp)
    for _ in range(3):
        g = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32),
                         params)
        jp, js = jo.update(jax.tree.map(jnp.asarray, g), js, jp)
        pp, ps = po.update(jax.tree.map(torch.tensor, g), ps, pp)
    assert int(ps["step"]) == 3 and ps["step"].dtype == torch.int32
    err, leaf = worst(pp, jax.tree.map(lambda a: torch.tensor(np.asarray(a)), jp))
    assert err <= UPDATE_TOL, (leaf, err)


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_train_step_matches_jax(name):
    p = pair(ARCH, "float32")
    b = batch(p.cfg, seed=2)
    jo = jopt.get_optimizer(name, lr=1e-2, total_steps=10)
    po = popt.get_optimizer(name, lr=1e-2, total_steps=10)
    jp, js, jm = jax.jit(jax_make_train_step(p.jm, jo))(p.jp, jo.init(p.jp), b)
    pp, ps, pm = make_train_step(p.pm, po)(p.pp, po.init(p.pp), b)
    np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(pm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-5)
    assert int(ps["step"]) == 1
    for moment in ("m", "v") if name == "adamw" else ("m",) if name == "sgd" else ():
        err, leaf = worst(ps[moment], to_port(js[moment], p.cfg))
        assert err <= STEP_TOL, (moment, leaf, err)
    err, leaf = worst(pp, to_port(jp, p.cfg))
    assert err <= (ADAMW_PARAM_TOL if name == "adamw" else STEP_TOL), (leaf, err)
