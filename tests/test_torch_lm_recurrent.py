"""The port's LM path for recurrentgemma-2b against the JAX package's, at
its smoke configuration with one pattern repetition and two tail blocks
(``rec, rec, attn_local`` then ``rec, rec``; d_model and d_rnn 64, 4 query
heads / 1 KV head of 16, window 8, vocab 256): the causal convolution, the
RG-LRU block (prefill on ``linear_recurrence(method="doubling")``, its
decode state, one decode step at a time), ``prefill`` and 12
``decode_step``s (so the local layer's ring wraps) with every cache leaf
(``h``, ``conv``, the ring's ``k`` / ``v``), the ``ServeEngine`` and the
launcher.  Norm scales, biases and the convolution's ``b`` carry seeded
noise (``tests/_torch_lm_parity.py``); the port runs on the CPU.

Tolerances, as max |port - jax| <= tol * max |jax|:

- f32, the prefill's logits and its ``h`` and KV cache (f32): 1e-5, the
  same f32 arithmetic summed in another order;
- bf16: 2e-2, since the two frameworks round bf16 products and
  activations at different points;
- the ``conv`` state is bf16 in every run, as in the JAX package: under
  f32 compute an input that differs by one f32 rounding step can round
  one bf16 step apart, up to 2^-7 of the largest entry: 8e-3.  Every
  decode step reads that state, so an f32 run's decode logits and its
  caches after decoding are held at 8e-3 too, as are the bf16 KV cache
  under f32 compute and the logits read through it."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm_parity import (assert_cache_close, pair, rel, run_both,
                              run_engine, tokens)
from repro.models import recurrent as jr
from repro.models.model import _rec_state_from_prefill
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro_torch.launch import serve as launch_serve
from repro_torch.models import recurrent as pr
from repro_torch.serve.engine import Request, ServeEngine

ARCH = "recurrentgemma-2b"
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
OWN_KV_TOL = 8e-3
CACHE_TOL = {"float32": {"kv": 1e-5, "h": 1e-5, "conv": 8e-3},
             "bfloat16": {"kv": 2e-2, "h": 2e-2, "conv": 2e-2}}
# after a decode step, which reads the bf16 conv state
DECODE_TOL = {"float32": 8e-3, "bfloat16": 2e-2}
# (prompt length, s_cache) against the smoke window of 8
CASES = {"shorter-than-window": (5, 32), "longer-than-window": (20, 32),
         "cache-shorter-than-window": (20, 6)}
STEPS = 12


def _dt(dtype):
    return getattr(torch, dtype), getattr(jnp, dtype)


def _rec_block(p, layer=0):
    """Layer ``layer`` (< the pattern's length) of both packages' trees."""
    return (p.pp["layers"][layer]["mix"],
            jax.tree.map(lambda a: a[0], p.jp["blocks"][f"p{layer}"]["mix"]))


# --------------------------------------------------------------------------
# the RG-LRU block
# --------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv_matches_jax(dtype):
    p = pair(ARCH, dtype)
    tdt, jdt = _dt(dtype)
    port, ref = _rec_block(p)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, 64)).astype(np.float32)
    state = rng.standard_normal((2, p.cfg.conv_width - 1, 64)).astype(np.float32)
    for st in (None, state):
        got, got_state = pr.causal_conv(
            port["conv"], torch.from_numpy(x).to(tdt),
            None if st is None else torch.from_numpy(st).to(torch.bfloat16))
        want, want_state = jr._causal_conv(
            ref["conv"], jnp.asarray(x, jdt),
            None if st is None else jnp.asarray(st, jnp.bfloat16))
        assert got.dtype == tdt and rel(got, want) <= TOL[dtype]
        assert rel(got_state, want_state) <= TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [1, 3, 30])
def test_rglru_block_and_state_match_jax(S, dtype):
    """The block's output (doubling), and the decode state after the last
    position against the JAX prefill's ``_rec_state_from_prefill``; S = 1
    and 3 are shorter than the conv's history."""
    p = pair(ARCH, dtype)
    tdt, jdt = _dt(dtype)
    port, ref = _rec_block(p, 1)
    x = np.random.default_rng(S).standard_normal((2, S, 64)).astype(np.float32)
    got, (h, conv) = pr.rglru_block_apply(port, p.cfg, torch.from_numpy(x).to(tdt),
                                          return_state=True)
    jx = jnp.asarray(x, jdt)
    want = jr.rglru_block_apply(ref, p.jcfg, jx)
    slot = {"h": jnp.zeros((2, 64), jnp.float32),
            "conv": jnp.zeros((2, 3, 64), jnp.bfloat16)}
    state = _rec_state_from_prefill(ref, p.jcfg, jx, slot)
    assert got.dtype == tdt and rel(got, want) <= TOL[dtype]
    assert h.dtype == torch.float32 and rel(h, state["h"]) <= TOL[dtype]
    assert rel(conv.to(torch.bfloat16), state["conv"]) <= CACHE_TOL[dtype]["conv"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rglru_decode_steps_match_jax(dtype):
    """Six steps from a nonzero state, the cache updated in place."""
    p = pair(ARCH, dtype)
    tdt, jdt = _dt(dtype)
    port, ref = _rec_block(p)
    rng = np.random.default_rng(2)
    h0 = rng.standard_normal((2, 64)).astype(np.float32)
    c0 = rng.standard_normal((2, 3, 64)).astype(np.float32)
    # the port updates its cache in place, and jnp.asarray may alias h0's
    # buffer on the CPU: the port gets its own copy
    cache = {"h": torch.tensor(h0), "conv": torch.from_numpy(c0).to(torch.bfloat16)}
    jcache = {"h": jnp.asarray(h0), "conv": jnp.asarray(c0, jnp.bfloat16)}
    h_tensor = cache["h"]
    for t in range(6):
        x = rng.standard_normal((2, 1, 64)).astype(np.float32)
        got = pr.rglru_block_decode(port, p.cfg, torch.from_numpy(x).to(tdt), cache)
        want, jcache = jr.rglru_block_decode(ref, p.jcfg, jnp.asarray(x, jdt), jcache)
        assert got.dtype == tdt and rel(got, want) <= TOL[dtype], t
        assert rel(cache["h"], jcache["h"]) <= CACHE_TOL[dtype]["h"], t
        assert rel(cache["conv"], jcache["conv"]) <= CACHE_TOL[dtype]["conv"], t
    assert cache["h"] is h_tensor and cache["conv"].dtype == torch.bfloat16


def test_lam_stays_f32():
    """The JAX package uses ``lam`` in f32 under bf16 compute; so does the
    port, carried across and from its own init."""
    p = pair(ARCH, "bfloat16")
    for layer, kind in zip(p.pp["layers"], p.cfg.kinds()):
        if kind == "rec":
            assert layer["mix"]["lam"].dtype == torch.float32
            assert layer["mix"]["w_a"]["w"].dtype == torch.bfloat16
    own = p.pm.init(torch.Generator().manual_seed(0))
    lam = own["layers"][0]["mix"]["lam"]
    assert lam.dtype == torch.float32
    np.testing.assert_array_equal(lam.numpy(), p.pp["layers"][0]["mix"]["lam"].numpy())


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_prefill_and_decode_match_jax(case, dtype):
    """f32 with an f32 KV cache, bf16 with the arch's bf16 cache: logits of
    the prefill and of every step, and every leaf (``h``, ``conv``, the
    ring) after the prefill and after the last step."""
    p = pair(ARCH, dtype, "float32" if dtype == "float32" else None)
    S, s_cache = CASES[case]
    logits, first, last = run_both(p, tokens(1, (2, S)), s_cache, STEPS, seed=2)
    for step, (got, want) in enumerate(logits):
        assert got.shape == want.shape == (2, 1, p.cfg.vocab_pad)
        assert rel(got, want) <= (DECODE_TOL if step else TOL)[dtype], step
    assert_cache_close(p, *first, CACHE_TOL[dtype])
    tol = DECODE_TOL[dtype]
    assert_cache_close(p, *last, {"kv": tol, "h": tol, "conv": tol})
    ring = last[0]["layers"][2]["k"]
    assert ring.shape[1] == min(p.cfg.window, s_cache)
    assert last[0]["idx"] == S + STEPS


@pytest.mark.parametrize("case", sorted(CASES))
def test_own_kv_cache_matches_jax(case):
    """f32 compute with the arch's bf16 KV cache."""
    p = pair(ARCH, "float32")
    S, s_cache = CASES[case]
    logits, first, last = run_both(p, tokens(1, (2, S)), s_cache, STEPS, seed=2)
    assert rel(*logits[0]) <= TOL["float32"]
    for step, (got, want) in enumerate(logits[1:]):
        assert rel(got, want) <= OWN_KV_TOL, step
    assert_cache_close(p, *first, dict(CACHE_TOL["float32"], kv=OWN_KV_TOL))
    assert_cache_close(p, *last, {"kv": OWN_KV_TOL, "h": OWN_KV_TOL, "conv": OWN_KV_TOL})


def test_serve_engine_matches_jax_engine():
    """Token streams and every logits array of the two engines, f32 with the
    bf16 KV cache: the joined slot's ``h`` and ``conv`` are copied as its
    ``k`` / ``v`` are; 12 new tokens wrap the ring."""
    p = pair(ARCH, "float32")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 256, (n,)).astype(np.int32) for n in (5, 11, 5)]
    kw = dict(s_cache=16, max_new=12)
    jreqs, jlogits, jeng = run_engine(JaxServeEngine, JaxRequest, p.jm, p.jp, prompts, **kw)
    preqs, plogits, peng = run_engine(ServeEngine, Request, p.pm, p.pp, prompts, **kw)
    assert all(r.done and len(r.out) == 13 for r in preqs)
    assert [r.out for r in preqs] == [r.out for r in jreqs]
    assert peng.steps == jeng.steps and peng.prefills == 3
    assert len(plogits) == len(jlogits)
    for got, want in zip(plogits, jlogits):
        assert got.shape == want.shape
        assert rel(got, want) <= OWN_KV_TOL


def test_launcher_smoke_on_cpu(capsys):
    reqs = launch_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                              "--requests", "3", "--max-new", "10"])
    assert all(r.done and len(r.out) == 11 for r in reqs)
    out = capsys.readouterr().out
    assert f"[serve] {ARCH} (smoke) on cpu" in out
    assert "[serve] 3/3 requests, 33 tokens" in out
