"""The train step's mechanics on the CPU: the bf16 step under
``cast_params`` against the JAX package (the leaves it casts, the loss and
the update), recomputed layers (``remat``) against stored ones,
``micro_steps=4`` against one step on the whole batch, the eval step and
label masking.  gemma3-1b's smoke configuration with one pattern
repetition and two tail layers (:mod:`_torch_lm_parity`)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm_parity import _tree, configs, pair
from _torch_train_parity import batch, to_port, worst, one_torch_thread  # noqa: F401

from repro.optim import optimizers as jopt
from repro.train.steps import make_train_step as jax_make_train_step
from repro_torch.models.model import Model
from repro_torch.optim import optimizers as popt
from repro_torch.tree import leaves, leaves_with_path
from repro_torch.train.steps import (cast_for_compute, loss_and_grads,
                                     make_eval_step, make_train_step)

ARCH = "gemma3-1b"
# the bf16 step: the JAX package's and the port's bf16 products and
# attention round apart (measured 2.6e-2 per leaf, as far as either is
# from the f32 gradient)
BF16_TOL = 5e-2


def _bf16_pair():
    jcfg, cfg = configs(ARCH, "bfloat16")
    tree = _tree(ARCH, True, 0)
    from repro.models.model import Model as JaxModel
    return (JaxModel(jcfg, remat=False), jax.tree.map(jnp.asarray, tree),
            Model(cfg, device="cpu"), to_port(tree, cfg), cfg)


def test_cast_params_casts_the_leaves_jax_casts():
    """A scanned layer's norm scales are rank 2 in the JAX layout and cast;
    a tail layer's are not."""
    jm, jp, pm, pp, cfg = _bf16_pair()
    want = to_port(jax.tree.map(lambda a: np.full(a.shape, float(a.ndim >= 2)), jp), cfg)
    got = cast_for_compute(pp, pm)
    for (k, g), (_, w) in zip(leaves_with_path(got), leaves_with_path(want)):
        assert (g.dtype == torch.bfloat16) == bool(w.flatten()[0]), k
    assert got["layers"][0]["mix"]["ln"]["scale"].dtype == torch.bfloat16
    assert got["layers"][-1]["mix"]["ln"]["scale"].dtype == torch.float32


def test_bf16_train_step_matches_jax():
    jm, jp, pm, pp, cfg = _bf16_pair()
    b = batch(cfg, seed=2)
    jo, po = jopt.sgd_momentum(1e-2), popt.sgd_momentum(1e-2)
    jnew, _, jmet = jax.jit(jax_make_train_step(jm, jo))(jp, jo.init(jp), b)
    pnew, _, pmet = make_train_step(pm, po)(pp, po.init(pp), b)
    np.testing.assert_allclose(float(pmet["loss"]), float(jmet["loss"]), rtol=2e-3)
    # the update lr * clipped gradient, leaf by leaf
    jnew = to_port(jnew, cfg)
    upd = jax.tree.map(lambda a, b: a - b, pnew, pp)
    jupd = jax.tree.map(lambda a, b: a - b, jnew, pp)
    err, leaf = worst(upd, jupd)
    assert err <= BF16_TOL, (leaf, err)


def test_remat_matches_stored_activations():
    p = pair(ARCH, "float32")
    b = batch(p.cfg, seed=4)
    plain = Model(p.cfg, remat=False, device="cpu")
    g1, m1 = loss_and_grads(p.pm, p.pp, b)
    g0, m0 = loss_and_grads(plain, p.pp, b)
    assert p.pm.remat and float(m1["loss"]) == float(m0["loss"])
    err, leaf = worst(g1, g0)
    assert err <= 1e-6, (leaf, err)


def test_micro_steps_match_full_batch():
    p = pair(ARCH, "float32")
    b = batch(p.cfg, B=8, seed=5)
    opt = popt.get_optimizer("sgd", lr=1e-2)
    p1, _, m1 = make_train_step(p.pm, opt, micro_steps=1)(p.pp, opt.init(p.pp), b)
    p4, _, m4 = make_train_step(p.pm, opt, micro_steps=4)(p.pp, opt.init(p.pp), b)
    d = max(float((a - c).abs().max()) for a, c in zip(leaves(p1), leaves(p4)))
    assert d < 5e-3            # the JAX package's own test's bound
    np.testing.assert_allclose(float(m4["grad_norm"]), float(m1["grad_norm"]),
                               rtol=0.5)
    with pytest.raises(ValueError, match="micro steps"):
        make_train_step(p.pm, opt, micro_steps=3)(p.pp, opt.init(p.pp), b)


def test_eval_step_is_the_loss_without_a_gradient():
    p = pair(ARCH, "float32")
    b = batch(p.cfg, seed=6)
    m = make_eval_step(p.pm)(p.pp, b)
    _, want = loss_and_grads(p.pm, p.pp, b)
    assert m["loss"].grad_fn is None
    np.testing.assert_allclose(float(m["loss"]), float(want["loss"]), rtol=1e-6)
    assert int(m["ntok"]) == b["tokens"].size - b["tokens"].shape[0]


def test_a_short_batch_masks_its_labels():
    p = pair(ARCH, "float32")
    b = batch(p.cfg, seed=6)
    b = dict(b, labels=np.where(np.arange(16) < 4, b["labels"], -1).astype(np.int32))
    m = make_eval_step(p.pm)(p.pp, b)
    assert int(m["ntok"]) == 8
