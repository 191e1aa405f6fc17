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
    got, _ = mgr.restore({"x": torch.zeros(3)}, shardings={"x": None})
    assert torch.equal(got["x"], torch.ones(3))        # None: unsharded
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore({"x": torch.zeros(3)})


def test_restore_onto_shardings_of_a_one_rank_mesh(tmp_path):
    """``restore(shardings=)`` puts each leaf with a sharding on the mesh as
    a DTensor (its block: the whole leaf on one rank) and a leaf or subtree
    whose sharding is None whole; a save of the DTensor tree writes the
    unsharded save's files."""
    from torch.distributed.tensor import DTensor

    from repro_torch.launch.mesh import destroy_process_group, make_mesh
    from repro_torch.models.sharding import P, NamedSharding

    tree = {"w": torch.arange(12.0).reshape(4, 3), "opt": {"s": torch.ones(2)}}
    CheckpointManager(str(tmp_path / "a")).save(tree, 1)
    mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
    try:
        got, man = CheckpointManager(str(tmp_path / "a")).restore(
            {"w": torch.zeros(4, 3), "opt": {"s": torch.zeros(2)}},
            shardings={"w": NamedSharding(mesh, P("data", "model")), "opt": None})
        assert isinstance(got["w"], DTensor) and not isinstance(got["opt"]["s"], DTensor)
        assert torch.equal(got["w"].full_tensor(), tree["w"])
        CheckpointManager(str(tmp_path / "b")).save(got, 1)
    finally:
        destroy_process_group()
    with np.load(tmp_path / "a" / "step_1" / "arrays.npz") as a, \
            np.load(tmp_path / "b" / "step_1" / "arrays.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert np.array_equal(a[k], b[k])
