"""The data pipeline and the checkpoint format against the JAX package:
``SyntheticLM``'s batches byte for byte (dense, audio and vlm families,
host shards, the prefetching loader), and checkpoints that either package
writes and the other restores, with the same manifest."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_train_parity import one_torch_thread  # noqa: F401

from repro.checkpoint import manager as jax_ckpt
from repro.data import SyntheticLM as JaxSyntheticLM
from repro_torch.checkpoint import CheckpointManager, restore_pytree, save_pytree
from repro_torch.data import SyntheticLM, make_loader

FAMILIES = {"dense": dict(), "audio": dict(family="audio", d_model=24),
            "vlm": dict(family="vlm", d_model=24, prefix_len=5)}


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("seq", [16, 64])
def test_synthetic_batches_are_the_reference(family, seq):
    kw = FAMILIES[family]
    for host in range(2):
        a = SyntheticLM(300, seq, 4, seed=3, host_id=host, num_hosts=2, **kw)
        b = JaxSyntheticLM(300, seq, 4, seed=3, host_id=host, num_hosts=2, **kw)
        for step in (0, 1, 7):
            x, y = a.batch(step), b.batch(step)
            assert x.step == y.step == step
            for name in ("tokens", "labels"):
                got, want = getattr(x, name), getattr(y, name)
                assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
            assert (x.extras is None) == (y.extras is None) == (family == "dense")
            for name, arr in (y.extras or {}).items():
                assert x.extras[name].tobytes() == arr.tobytes()


def test_loader_resumes_at_its_step():
    ds = SyntheticLM(100, 16, 2, seed=5)
    it = make_loader(ds, start_step=3)
    try:
        for step in (3, 4, 5):
            got = next(it)
            assert got.step == step
            assert np.array_equal(got.tokens, ds.batch(step).tokens)
    finally:
        it.close()


def _tree():
    """Every kind of leaf a trainer saves: f32 and bf16 parameters in dicts
    and a list, an int32 step scalar, an empty Gram."""
    rng = np.random.default_rng(0)
    return {"params": {"layers": [{"w": rng.standard_normal((3, 4)).astype(np.float32)},
                                  {"w": rng.standard_normal((3, 4)).astype(np.float32)}],
                       "embed": {"tok": rng.standard_normal((5, 2)).astype(np.float32)}},
            "opt": {"step": np.int32(7), "G": np.zeros((0, 0), np.float32)}}


def _port(tree):
    t = jax.tree.map(torch.tensor, tree)
    t["params"]["embed"]["tok"] = t["params"]["embed"]["tok"].bfloat16()
    return t


def _jax(tree):
    t = jax.tree.map(jnp.asarray, tree)
    t["params"]["embed"]["tok"] = t["params"]["embed"]["tok"].astype(jnp.bfloat16)
    return t


def _manifest(path):
    with open(os.path.join(path, "manifest.json")) as f:
        m = json.load(f)
    return m["leaves"]


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    tree = _tree()
    jax_ckpt.save_pytree(_jax(tree), str(tmp_path))
    template = jax.tree.map(torch.zeros_like, _port(tree))
    got = restore_pytree(template, str(tmp_path))
    assert got["params"]["embed"]["tok"].dtype == torch.bfloat16
    assert got["opt"]["step"].dtype == torch.int32 and int(got["opt"]["step"]) == 7
    want = _port(tree)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert g.dtype == w.dtype and torch.equal(g, w)


def test_port_checkpoint_restores_in_jax_with_the_same_manifest(tmp_path):
    tree = _tree()
    save_pytree(_port(tree), str(tmp_path / "port"))
    jax_ckpt.save_pytree(_jax(tree), str(tmp_path / "jax"))
    mp, mj = _manifest(tmp_path / "port"), _manifest(tmp_path / "jax")
    assert mp == mj
    assert mp["['params']['embed']['tok']"]["dtype"] == "bfloat16"
    got = jax_ckpt.restore_pytree(jax.tree.map(jnp.zeros_like, _jax(tree)),
                                  str(tmp_path / "port"))
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(_jax(tree))):
        assert g.dtype == w.dtype and np.array_equal(np.asarray(g), np.asarray(w))


def test_checkpoint_manager_atomic_and_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = {"x": torch.zeros(3)}
    for s in (5, 10, 15):
        mgr.save(tree, s)
    mgr.save_async({"x": torch.ones(3)}, 20)
    mgr.wait()
    assert mgr.steps() == [15, 20]
    os.makedirs(tmp_path / "tmp.99")      # a killed save is ignored
    assert mgr.latest_step() == 20
    got, man = mgr.restore({"x": torch.zeros(3, dtype=torch.float64)})
    assert man["step"] == 20 and got["x"].dtype == torch.float64
    assert torch.equal(got["x"], torch.ones(3, dtype=torch.float64))
    got, man = mgr.restore({"x": torch.ones(3)}, step=15)
    assert man["step"] == 15 and torch.equal(got["x"], torch.zeros(3))
    with pytest.raises(ValueError, match="shape"):
        mgr.restore({"x": torch.zeros(4)})
    with pytest.raises(NotImplementedError, match="ROADMAP A12"):
        mgr.restore({"x": torch.zeros(3)}, shardings={"x": None})
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore({"x": torch.zeros(3)})
