"""The port's LM path for gemma3-1b, gemma3-12b and qwen1.5-32b against the
JAX package's, at their smoke configurations with one pattern repetition
and two tail blocks (gemma3: 5 local + 1 global layer, then 2 local; qwen:
3 layers; d_model 64, window 8, vocab 256): the score softcap in
``flash_attention`` / ``decode_attention``, QKV bias, the int8 KV cache,
the local layers' ring cache (prompts shorter and longer than the window,
and a cache shorter than the window), ``prefill`` and 12 ``decode_step``s
(so the ring wraps), every cache leaf, the ``ServeEngine`` and the
launcher's default run.  Norm scales and biases carry seeded noise
(``tests/_torch_lm_parity.py``); the port runs on the CPU.

Tolerances, as max |port - jax| <= tol * max |jax|:

- logits, f32 (with an f32 KV cache): 1e-5, the same f32 arithmetic summed
  in another order;
- logits, bf16: 2e-2, since the two frameworks round bf16 products and
  activations at different points;
- under f32 compute with the arch's own cache, a cached f32 key that
  differs by one rounding step can round one step of the cache's type
  apart: bf16 entries 8e-3 (one bf16 step is up to 2^-7 of the largest
  entry), int8 entries compared dequantized within one quantization step,
  their scales 1e-5; the logits read through either 8e-3 (one bf16 step,
  or 1/127 of an int8 key);
- the conv state is bf16 in every run: 8e-3 under f32 compute;
- the bf16 run's caches 2e-2; its int8 entries within two steps (a bf16
  key may itself be one bf16 step, half an int8 step, apart)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm_parity import (assert_cache_close, pair, rel, run_both,
                              run_engine, tokens)
from repro.models import layers as jl
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro_torch.launch import serve as launch_serve
from repro_torch.models import layers as pl
from repro_torch.serve.engine import Request, ServeEngine

ARCHS = ("gemma3-1b", "gemma3-12b", "qwen1.5-32b")
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
OWN_KV_TOL = 8e-3
CACHE_TOL = {"float32": {"kv": 1e-5, "h": 1e-5, "conv": 8e-3},
             "bfloat16": {"kv": 2e-2, "scale": 2e-2, "int8_steps": 2, "h": 2e-2,
                          "conv": 2e-2}}
# (prompt length, s_cache) against the smoke window of 8
CASES = {"shorter-than-window": (5, 32), "longer-than-window": (20, 32),
         "cache-shorter-than-window": (20, 6)}
STEPS = 12


def _dt(dtype):
    return getattr(torch, dtype), getattr(jnp, dtype)


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cap", [30.0, 2.0])
@pytest.mark.parametrize("kind,window", [("causal", 0), ("window", 24)])
def test_flash_attention_softcap_matches_jax(kind, window, cap, dtype):
    """The capped flash attention (the kernel's plain version here) against
    the JAX model's scan-based one, GQA, ragged S; a cap of 2 bites on
    most scores."""
    tdt, jdt = _dt(dtype)
    rng = np.random.default_rng(3)
    arrs = [2 * rng.standard_normal(s).astype(np.float32)
            for s in ((2, 100, 4, 16), (2, 100, 2, 16), (2, 100, 2, 16))]
    got = pl.flash_attention(*(torch.from_numpy(a).to(tdt) for a in arrs),
                             kind=kind, window=window, softcap_val=cap)
    want = jl.flash_attention(*(jnp.asarray(a, jdt) for a in arrs), kind=kind,
                              window=window, block_q=32, block_k=32, softcap_val=cap)
    assert rel(got, want) <= TOL[dtype]
    plain = pl.flash_attention(*(torch.from_numpy(a).to(tdt) for a in arrs),
                               kind=kind, window=window)
    assert rel(plain, want) > TOL[dtype]           # the cap changed the answer


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
def test_decode_attention_softcap_and_int8_match_jax(kv, dtype):
    tdt, jdt = _dt(dtype)
    rng = np.random.default_rng(4)
    q = 3 * rng.standard_normal((3, 1, 4, 16)).astype(np.float32)
    if kv == "int8":
        kc, vc = (rng.integers(-127, 128, (3, 20, 2, 16)).astype(np.int8) for _ in range(2))
        scale = rng.uniform(0.001, 0.05, (3, 20, 2, 2)).astype(np.float32)
        tk, tv = torch.from_numpy(kc), torch.from_numpy(vc)
        jk, jv = jnp.asarray(kc), jnp.asarray(vc)
        ts, js = torch.from_numpy(scale), jnp.asarray(scale)
    else:
        kc, vc = (rng.standard_normal((3, 20, 2, 16)).astype(np.float32) for _ in range(2))
        tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (kc, vc))
        jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (kc, vc))
        ts = js = None
    tq, jq = torch.from_numpy(q).to(tdt), jnp.asarray(q, jdt)
    for cap in (0.0, 30.0, 1.5):
        for cur in (1, 13, 20):
            got = pl.decode_attention(tq, tk, tv, cur, softcap_val=cap, kv_scale=ts)
            want = jl.decode_attention(jq, jk, jv, jnp.asarray(cur),
                                       softcap_val=cap, kv_scale=js)
            assert got.dtype == tq.dtype and rel(got, want) <= TOL[dtype], (cap, cur)


def test_quantize_int8_matches_jax_bitwise():
    """Same f32 arithmetic, both round half to even: ties included."""
    rng = np.random.default_rng(5)
    t = rng.standard_normal((4, 1, 3, 16)).astype(np.float32)
    t[0, 0, 0, :5] = [127.0, 0.5, 1.5, 2.5, -0.5]     # scale 1: exact ties
    t[0, 0, 0, 5:] = 0.0
    t[1, 0, 1] = 0.0                                    # all zero: scale 1e-6/127
    q, s = pl.quantize_int8(torch.from_numpy(t))
    jq, js = jl._quantize_int8(jnp.asarray(t))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert q[0, 0, 0, :5].tolist() == [127, 0, 2, 2, 0]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_attention_blocks_match_jax(arch, dtype):
    """Layer 0 (local for gemma3) and layer 5 or 2 (global) with the noisy
    parameters: bias, softcap and the window mask as the block's kind."""
    p = pair(arch, dtype)
    tdt, jdt = _dt(dtype)
    x = np.random.default_rng(6).standard_normal((2, 30, p.cfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(30), (2, 1))
    P = len(p.cfg.block_pattern)
    for i in sorted({0, P - 1}):
        kind = p.cfg.block_pattern[i]
        mask = "window" if kind == "attn_local" else "causal"
        jblock = jax.tree.map(lambda a: a[0], p.jp["blocks"][f"p{i}"]["mix"])
        got = pl.attention_apply(p.pp["layers"][i]["mix"], p.cfg,
                                 torch.from_numpy(x).to(tdt), torch.from_numpy(pos),
                                 kind=mask)
        want = jax.jit(lambda prm, xx, ps, m=mask: jl.attention_apply(
            prm, p.jcfg, xx, ps, kind=m))(jblock, jnp.asarray(x, jdt), jnp.asarray(pos))
        assert got.dtype == tdt and rel(got, want) <= TOL[dtype], (i, kind)


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch, case, dtype):
    """f32 with an f32 KV cache (so that no cache entry rounds), bf16 with
    the arch's own cache: logits of the prefill and of every step, and
    every cache leaf after the prefill and after the last step."""
    p = pair(arch, dtype, "float32" if dtype == "float32" else None)
    S, s_cache = CASES[case]
    logits, first, last = run_both(p, tokens(1, (2, S)), s_cache, STEPS, seed=2)
    for step, (got, want) in enumerate(logits):
        assert got.shape == want.shape == (2, 1, p.cfg.vocab_pad)
        assert rel(got, want) <= TOL[dtype], step
    for cache, jcache in (first, last):
        assert_cache_close(p, cache, jcache, CACHE_TOL[dtype])
    assert last[0]["idx"] == S + STEPS


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("arch", ARCHS)
def test_own_kv_cache_matches_jax(arch, case):
    """f32 compute with the arch's own KV cache (bf16 for gemma3, int8 with
    f32 scales for qwen)."""
    p = pair(arch, "float32")
    kv = p.cfg.kv_cache_dtype
    S, s_cache = CASES[case]
    logits, first, last = run_both(p, tokens(1, (2, S)), s_cache, STEPS, seed=2)
    for step, (got, want) in enumerate(logits):
        assert rel(got, want) <= OWN_KV_TOL, step
    tol = {"kv": OWN_KV_TOL, "scale": 1e-5}
    for cache, jcache in (first, last):
        assert_cache_close(p, cache, jcache, tol)
    if kv == "int8":
        assert cache["layers"][0]["k"].dtype == torch.int8
        assert cache["layers"][0]["scale"].shape == (2, s_cache, p.cfg.n_kv_heads, 2)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_engine_matches_jax_engine(arch):
    """Token streams and every logits array of the two engines, f32 with
    the arch's own cache; 12 new tokens each, so that the local rings
    wrap, and a request that joins a slot another one left."""
    p = pair(arch, "float32")
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


def test_launcher_default_is_gemma3_1b(capsys):
    """No ``--arch``: the launcher serves gemma3-1b, as the JAX launcher;
    10 new tokens wrap the smoke window of 8."""
    reqs = launch_serve.main(["--smoke", "--device", "cpu", "--requests", "3",
                              "--max-new", "10"])
    assert all(r.done and len(r.out) == 11 for r in reqs)
    out = capsys.readouterr().out
    assert "[serve] gemma3-1b (smoke) on cpu" in out
    assert "[serve] 3/3 requests, 33 tokens" in out


def test_one_slot_engine_copies_every_layer():
    """The port's engine copies every layer's cache into the slot for any
    slot count; the JAX engine's splice skips the tail blocks' leaves of a
    one-slot engine (ROADMAP C-ref 8), so this is held against the port's
    own prefill."""
    p = pair("gemma3-1b", "float32")
    prompt = tokens(3, (9,))
    eng = ServeEngine(p.pm, p.pp, batch_slots=1, s_cache=16)
    eng.submit(Request(0, prompt, max_new=1))
    eng._join(0, eng.queue.popleft())
    _, cache = p.pm.prefill(p.pp, torch.from_numpy(prompt[None]), 16)
    assert len(cache["layers"]) == p.cfg.num_layers == 8
    for big, small in zip(eng.cache["layers"], cache["layers"]):
        for name, leaf in small.items():
            assert torch.equal(big[name], leaf), name
