"""The port's trainer and launchers on the CPU: the JAX package's trainer
tests (``tests/test_train_substrate.py``) on the port (each optimizer
lowers the loss, tripre stays bounded, a failed step rolls back and a new
trainer resumes), then ``launch.train`` and ``launch.serve --ckpt`` on a
trained checkpoint, and the trainer and launcher where no world of ranks
shards them (``tests/test_torch_train_sharded.py`` holds the sharded
runs)."""
import numpy as np
import pytest
import torch

from _torch_train_parity import one_torch_thread  # noqa: F401

from repro_torch.configs import smoke_config
from repro_torch.data import SyntheticLM
from repro_torch.launch import serve, train
from repro_torch.models.model import Model
from repro_torch.optim import get_optimizer
from repro_torch.train import TrainConfig, Trainer
from repro_torch.train.steps import loss_and_grads, loss_fn, make_train_step


def _model(arch="gemma3-1b"):
    cfg = smoke_config(arch)
    return Model(cfg, remat=False, device="cpu"), cfg


def _params(model):
    return model.init(torch.Generator().manual_seed(0), masters=True)


@pytest.mark.parametrize("opt_name", ["adamw", "adafactor", "sgd"])
def test_optimizer_reduces_loss(opt_name):
    model, cfg = _model()
    params = _params(model)
    opt = get_optimizer(opt_name, lr=3e-3, total_steps=30)
    state = opt.init(params)
    data = SyntheticLM(cfg.vocab_size, 32, 4, seed=1)
    step = make_train_step(model, opt)
    losses = []
    for i in range(12):
        b = data.batch(i)
        params, state, m = step(params, state, {"tokens": b.tokens, "labels": b.labels})
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0], (opt_name, losses)
    assert np.isfinite(losses).all()


def test_tripre_optimizer_runs_and_stays_bounded():
    model, cfg = _model("xlstm-350m")
    params = _params(model)
    opt = get_optimizer("tripre", lr=1e-3, total_steps=20, band=4,
                        refresh_every=5, max_dim=256)
    state = opt.init(params)
    data = SyntheticLM(cfg.vocab_size, 16, 2, seed=2)
    losses = []
    for i in range(8):
        b = data.batch(i)
        batch = {"tokens": b.tokens, "labels": b.labels}
        g, _ = loss_and_grads(model, params, batch)
        params, state = opt.update(g, state, params)
        with torch.no_grad():
            losses.append(float(loss_fn(model, params, batch)[0]))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] * 1.5, losses
    assert len(opt.stats["refresh_s"]) == 2         # steps 1 and 6


def test_trainer_failure_recovery_and_resume(tmp_path):
    model, cfg = _model("xlstm-350m")
    data = SyntheticLM(cfg.vocab_size, 16, 2, seed=0)
    opt = get_optimizer("adamw", lr=1e-3, total_steps=20)
    fail_at = {7}

    def failure_hook(step):
        if step in fail_at:
            fail_at.discard(step)
            return True
        return False

    tc = TrainConfig(steps=10, ckpt_every=3, ckpt_dir=str(tmp_path),
                     log_every=100, resume="auto")
    out = Trainer(model, opt, data, tc, failure_hook=failure_hook).run()
    assert out["final_step"] == 10
    assert out["recoveries"] == 1
    assert np.isfinite(out["history"]).all()
    # step 7 failed before it counted: rolled back to step 6, which ran twice
    assert len(out["history"]) == 11 and len(out["step_seconds"]) == 11
    assert out["save_bytes"] > 0 and out["save_seconds"] >= 0
    tc2 = TrainConfig(steps=12, ckpt_every=100, ckpt_dir=str(tmp_path),
                      log_every=100, resume="auto")
    out2 = Trainer(model, opt, data, tc2).run()
    assert out2["final_step"] == 12
    assert len(out2["history"]) == 2  # only steps 10..12 re-run


def test_trainer_ends_past_max_recoveries(tmp_path):
    model, cfg = _model()
    tc = TrainConfig(steps=3, ckpt_dir=str(tmp_path), resume="none",
                     max_recoveries=2)
    tr = Trainer(model, get_optimizer("sgd"), SyntheticLM(cfg.vocab_size, 8, 2), tc,
                 failure_hook=lambda step: True)
    with pytest.raises(RuntimeError, match="injected failure at step 0"):
        tr.run()
    assert tr.recoveries == 3


def test_launchers_train_then_serve_the_checkpoint(tmp_path):
    out = train.main(["--smoke", "--device", "cpu", "--steps", "4", "--seq", "16",
                      "--batch", "2", "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"])
    assert out["final_step"] == 4 and out["recoveries"] == 0
    assert len(out["history"]) == 4
    reqs = serve.main(["--smoke", "--device", "cpu", "--ckpt", str(tmp_path),
                       "--requests", "3", "--max-new", "2"])
    assert all(r.done for r in reqs)
    # the served weights are the trained step's, cast to the serving dtypes
    from repro_torch.checkpoint import CheckpointManager
    model = Model(smoke_config("gemma3-1b"), device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    tree, man = CheckpointManager(str(tmp_path)).restore({"params": params})
    assert man["step"] == 4
    assert not torch.equal(tree["params"]["layers"][0]["ffn"]["wi"]["w"],
                           params["layers"][0]["ffn"]["wi"]["w"])


def test_launcher_resumes_its_directory(tmp_path):
    args = ["--smoke", "--device", "cpu", "--seq", "16", "--batch", "2",
            "--ckpt-dir", str(tmp_path)]
    train.main(args + ["--steps", "2"])
    out = train.main(args + ["--steps", "3", "--arch", "gemma3-1b"])
    assert out["final_step"] == 3 and len(out["history"]) == 1


def test_launcher_trains_unsharded_in_a_world_of_one(tmp_path, monkeypatch):
    """As the JAX launcher: without a world above one, ``--model-parallel``
    builds no mesh."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    args = ["--smoke", "--device", "cpu", "--seq", "16", "--batch", "2",
            "--steps", "1", "--ckpt-dir", str(tmp_path)]
    out = train.main(args + ["--model-parallel", "2"])
    assert out["mesh"] is None and out["final_step"] == 1
    assert out["history"] == train.main(args + ["--resume", "none"])["history"]


def test_trainer_on_a_mesh_of_one_rank_matches_unsharded(tmp_path):
    """``Trainer(mesh=)`` on a (1, 1) gloo mesh: DTensor parameters and
    state, the same losses as the trainer without a mesh (a one-rank
    collective is the identity), and a checkpoint an unsharded trainer
    resumes."""
    from torch.distributed.tensor import DTensor

    from repro_torch.launch.mesh import destroy_process_group, make_mesh

    model, cfg = _model()
    data = SyntheticLM(cfg.vocab_size, 16, 2, seed=4)

    def run(mesh, d, steps=2):
        tc = TrainConfig(steps=steps, ckpt_every=2, ckpt_dir=str(d))
        trainer = Trainer(model, get_optimizer("adamw", lr=1e-3, total_steps=10),
                          data, tc, mesh=mesh)
        return trainer, trainer.run()

    _, want = run(None, tmp_path / "plain")
    mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
    try:
        trainer, got = run(mesh, tmp_path / "mesh")
        params, state, _ = trainer.init_state()
        assert isinstance(params["layers"][0]["mix"]["q"]["w"], DTensor)
        assert isinstance(state["m"]["embed"]["tok"], DTensor)
    finally:
        destroy_process_group()
    assert got["history"] == want["history"]
    _, resumed = run(None, tmp_path / "mesh", steps=3)
    assert len(resumed["history"]) == 1 and resumed["final_step"] == 3
