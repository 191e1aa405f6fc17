"""The port's LM path for llama4-scout-17b-a16e and arctic-480b against the
JAX package's, at their smoke configurations with three layers (d_model
64, 4 query / 2 KV heads of 16, 4 experts of d_ff 128, vocab 256):
llama4-scout routes each token to one expert and adds a shared expert,
arctic to two and adds a dense MLP.  ``prefill`` and two ``decode_step``s
(each decode step routes the slots' tokens with a capacity of 8), every
cache leaf, the ``ServeEngine`` token streams and logits with two slots,
and the launcher.  Norm scales carry seeded noise
(``tests/_torch_lm_parity.py``); the port runs on the CPU.  The MoE layer
itself, its routing and its expert-parallel path are held in
``tests/test_torch_moe.py``.

Tolerances, as max |port - jax| <= tol * max |jax|: f32 with an f32 KV
cache 1e-5 (the same f32 arithmetic summed in another order); bf16 2e-2
(the two frameworks round bf16 products and activations at different
points).

Routing flips.  Where two experts' router probabilities are within a
rounding step, the two frameworks may route a token apart (seen in bf16:
experts at 0.4085 / 0.4085 in the port, 0.4068 / 0.4100 in JAX), and that
token's hidden state then differs by far more than rounding.  So the
whole-model tests record every MoE call's (token, choice) routes in both
packages: a route that differs must be a near tie in the port's own
probabilities (the two experts within NEAR_TIE of each other, relative),
the number of such flips is held to FLIPS_MAX, and the cache entries of a
flipped token (at its position, in the layers after the flip) and the
logits of a step whose token flipped are left out of the comparison;
everything else is held at the tolerance above."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm_parity import jax_layers, pair, rel, run_both, run_engine, tokens
from repro.models import moe as jm
from repro.models.layers import dense as jax_dense
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro_torch.launch import serve as launch_serve
from repro_torch.models import moe as pm
from repro_torch.serve.engine import Request, ServeEngine

ARCHS = ("llama4-scout-17b-a16e", "arctic-480b")
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# (prompt length, s_cache)
CASES = {"fits": (20, 32), "longer-than-cache": (40, 24)}
STEPS = 2
# a route may differ between the packages only where the port's
# probabilities of the two experts are this close, relative
NEAR_TIE = {"float32": 1e-5, "bfloat16": 1e-2}
FLIPS_MAX = {"float32": 0, "bfloat16": 4}


def _recorded_run(p, monkeypatch, prompt, s_cache):
    """:func:`run_both` with every MoE call's routes recorded in both
    packages, in call order: ``(run_both's result, [(port expert ids (T,
    k), port probabilities (T, E))], [JAX expert ids (T, k)])``."""
    port, ref = [], []

    class Recording(pm._Routes):
        def __init__(self, params, cfg, x2, C):
            super().__init__(params, cfg, x2, C)
            port.append((self.eflat.reshape(-1, self.k).numpy(), self.probs.numpy()))

    local = jm._moe_local

    def recording_local(params, cfg, x2):
        probs = jax.nn.softmax(jax_dense(params["router"], x2).astype(jnp.float32), -1)
        jax.debug.callback(lambda e: ref.append(np.asarray(e)),
                           jax.lax.top_k(probs, cfg.top_k)[1], ordered=True)
        return local(params, cfg, x2)

    monkeypatch.setattr(pm, "_Routes", Recording)
    monkeypatch.setattr(jm, "_moe_local", recording_local)
    traced = dataclasses.replace(p, prefill=jax.jit(p.jm.prefill, static_argnums=2),
                                 decode=jax.jit(p.jm.decode_step))
    return run_both(traced, prompt, s_cache, STEPS, seed=4), port, ref


def _flips(p, port, ref, S, s_cache, dtype):
    """The (row, position, cache slot or None, first layer after the flip)
    of every token that routed apart; each such route a near tie in the
    port.  A prompt token sits at its position, if the cache holds it; a
    decoded one at ``min(position, s_cache - 1)``, as a global layer
    writes it."""
    L = p.cfg.num_layers
    assert len(port) == len(ref) == L * (1 + STEPS)
    out = []
    for call, ((eid, probs), jeid) in enumerate(zip(port, ref)):
        for t, c in zip(*np.nonzero(eid != jeid)):
            pe, je = probs[t, eid[t, c]], probs[t, jeid[t, c]]
            assert abs(pe - je) <= NEAR_TIE[dtype] * pe, (call, t, pe, je)
            step, layer = divmod(call, L)
            if step == 0:
                row, pos = divmod(t, S)
                slot = pos if pos < s_cache else None
            else:
                row, pos = t, S + step - 1
                slot = min(pos, s_cache - 1)
            out.append((row, pos, slot, layer + 1))
    assert len(out) <= FLIPS_MAX[dtype], out
    return out


def _masked(a, flips, layer):
    """A cache leaf ``(B, S, ...)`` of ``layer`` with the entries of the
    tokens that flipped before it set to 0."""
    a = np.array(a, np.float32)
    for row, _, slot, after in flips:
        if layer >= after and slot is not None:
            a[row, slot] = 0.0
    return a


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch, case, dtype, monkeypatch):
    """f32 with an f32 KV cache, bf16 with the arch's bf16 cache: the routes
    of every MoE call, logits of the prefill and of each step, and every
    K/V leaf after the prefill and after the last step."""
    p = pair(arch, dtype, "float32" if dtype == "float32" else None)
    S, s_cache = CASES[case]
    (logits, first, last), port, ref = _recorded_run(p, monkeypatch,
                                                     tokens(3, (2, S)), s_cache)
    flips = _flips(p, port, ref, S, s_cache, dtype)
    for step, (got, want) in enumerate(logits):
        assert got.shape == want.shape == (2, 1, p.cfg.vocab_pad)
        keep = [r for r in range(2) if (r, S - 1 + step) not in
                {(row, pos) for row, pos, _, _ in flips}]
        assert rel(got[keep], np.asarray(jnp.asarray(want, jnp.float32))[keep]) \
            <= TOL[dtype], step
    for cache, jcache in (first, last):
        assert cache["idx"] == int(jcache["idx"])
        for i, (slot, ref_slot) in enumerate(zip(cache["layers"], jax_layers(p, jcache))):
            assert slot.keys() == ref_slot.keys() == {"k", "v"}
            for name, want in ref_slot.items():
                got = slot[name]
                assert got.shape == want.shape and str(got.dtype) == f"torch.{want.dtype}"
                want = _masked(jnp.asarray(want, jnp.float32), flips, i)
                got = torch.from_numpy(_masked(got.float().numpy(), flips, i))
                assert rel(got, want) <= TOL[dtype], (i, name)
    assert last[0]["idx"] == S + STEPS


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_layers_are_attention_ffns(arch):
    """Every layer of the model is attention with an MoE FFN: the stacked
    experts, the router, and the shared expert (llama4) or the dense MLP
    (arctic); decode routes the slots' tokens with C = 8."""
    p = pair(arch, "float32")
    for layer in p.pp["layers"]:
        ffn = layer["ffn"]
        E, D, F = p.cfg.n_experts, p.cfg.d_model, p.cfg.d_ff
        assert ffn["wi"].shape == ffn["wg"].shape == (E, D, F)
        assert ffn["wo"].shape == (E, F, D) and ffn["router"]["w"].shape == (D, E)
        assert ("shared" in ffn) == p.cfg.shared_expert
        assert ("dense_mlp" in ffn) == p.cfg.moe_dense_residual
    assert pm.capacity(2, p.cfg) == 8


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_engine_matches_jax_engine(arch):
    """Token streams and every logits array of the two engines with two
    slots, f32 with an f32 KV cache."""
    p = pair(arch, "float32", "float32")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 256, (n,)).astype(np.int32) for n in (5, 11, 5)]
    kw = dict(s_cache=24, max_new=6)
    jreqs, jlogits, jeng = run_engine(JaxServeEngine, JaxRequest, p.jm, p.jp, prompts, **kw)
    preqs, plogits, peng = run_engine(ServeEngine, Request, p.pm, p.pp, prompts, **kw)
    assert all(r.done and len(r.out) == 7 for r in preqs)
    assert [r.out for r in preqs] == [r.out for r in jreqs]
    assert peng.steps == jeng.steps and peng.prefills == 3
    assert len(plogits) == len(jlogits)
    for got, want in zip(plogits, jlogits):
        assert got.shape == want.shape
        assert rel(torch.from_numpy(got), want) <= TOL["float32"]


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_smoke_on_cpu(arch, capsys):
    reqs = launch_serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                              "--requests", "3", "--max-new", "4"])
    assert all(r.done and len(r.out) == 5 for r in reqs)
    out = capsys.readouterr().out
    assert f"[serve] {arch} (smoke) on cpu" in out
    assert "[serve] 3/3 requests, 15 tokens" in out
