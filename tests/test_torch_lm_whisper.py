"""The port's LM path for whisper-medium against the JAX package's, at its
smoke configuration with three decoder blocks (d_model 64, 4 heads of 16,
2 encoder blocks, vocab 256) and 20 encoder frames: the encoder over
``enc_embed`` (sinusoidal positions, full attention without RoPE),
``prefill`` (last logits, every cache leaf and ``enc_out``), decode with
cross-attention over ``enc_out``, ``from_jax``, the ``ServeEngine`` with a
stub per request and the launcher.  Norm scales (``ln_kv`` too) and biases
carry seeded noise (``tests/_torch_lm_parity.py``); the port runs on the
CPU.

Decode is held against the JAX ``forward`` over the prompt and the decoded
tokens, not against the JAX ``decode_step``, which gives every new token
position 0's embedding (ROADMAP C-ref 11); the port adds position
``cache["idx"]``.

Tolerances, as max |port - jax| <= tol * max |jax|: f32 (with an f32 KV
cache) 1e-5, the same f32 arithmetic summed in another order; bf16 2e-2,
since the two frameworks round bf16 products and activations at different
points (the caches and ``enc_out`` too)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm_parity import (assert_cache_close, pair, rel, run_both, run_engine,
                              tokens)
from repro_torch.launch import serve as launch_serve
from repro_torch.models.convert import F32_LEAVES
from repro_torch.serve.engine import Request, ServeEngine

ARCH = "whisper-medium"
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
CACHE_TOL = {"float32": {"kv": 1e-5}, "bfloat16": {"kv": 2e-2}}
FRAMES = 20
# (prompt length, s_cache)
CASES = {"fits": (9, 32), "longer-than-cache": (20, 12)}
STEPS = 4


def _pair(dtype):
    return pair(ARCH, dtype, "float32" if dtype == "float32" else None)


def _frames(seed, B, Se=FRAMES):
    return np.random.default_rng(seed).standard_normal((B, Se, 64)).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encoder_matches_jax(dtype):
    p = _pair(dtype)
    enc = _frames(1, 2)
    got = p.pm._encode(p.pp, torch.from_numpy(enc))
    want = jax.jit(p.jm._encode)(p.jp, jnp.asarray(enc))
    assert got.dtype == getattr(torch, dtype) and got.shape == (2, FRAMES, 64)
    assert rel(got, want) <= TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_prefill_matches_jax(case, dtype):
    """Logits of the last position and every cache leaf: each decoder
    layer's K/V (no RoPE) and the encoder's output."""
    p = _pair(dtype)
    S, s_cache = CASES[case]
    logits, (cache, jcache), _ = run_both(p, tokens(1, (2, S)), s_cache, 0, seed=2,
                                          stub={"enc_embed": _frames(3, 2)})
    (got, want), = logits
    assert got.shape == want.shape == (2, 1, p.cfg.vocab_pad)
    assert rel(got, want) <= TOL[dtype]
    assert_cache_close(p, cache, jcache, CACHE_TOL[dtype])
    assert cache["idx"] == S
    assert cache["enc_out"].shape == jcache["enc_out"].shape == (2, FRAMES, 64)
    assert cache["enc_out"].dtype == getattr(torch, dtype)
    assert rel(cache["enc_out"], jcache["enc_out"]) <= TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_matches_jax_forward(dtype):
    """Prefill and STEPS decode steps against the JAX ``forward`` logits of
    the prompt and those tokens at the matching positions; in f32 the JAX
    ``decode_step`` is off by far more (position 0's embedding, C-ref 11)."""
    p = _pair(dtype)
    S = 9
    prompt, enc = tokens(1, (2, S)), _frames(3, 2)
    logits, _, (cache, jcache) = run_both(p, prompt, 32, STEPS, seed=2,
                                          stub={"enc_embed": enc})
    steps = tokens(2, (STEPS, 2, 1))          # the tokens run_both decoded
    seq = np.concatenate([prompt] + list(steps), axis=1)
    full, _ = jax.jit(p.jm.forward)(p.jp, {"tokens": jnp.asarray(seq),
                                           "enc_embed": jnp.asarray(enc)})
    for i, (got, jax_step) in enumerate(logits):
        want = full[:, S - 1 + i][:, None]
        assert rel(got, want) <= TOL[dtype], i
        if dtype == "float32" and i:
            assert rel(jax_step, want) > 1e3 * TOL[dtype], i
    assert cache["idx"] == S + STEPS


def test_from_jax_carries_encoder_and_cross_attention():
    """Every decoder layer's ``xattn`` (with ``ln_kv``), the encoder's
    blocks (slice ``r`` of the stacked ``p0``) and its ``ln``: bf16
    weights, f32 norm scales, values equal to the JAX leaves."""
    p = pair(ARCH, "bfloat16")
    tree = jax.tree.map(np.asarray, p.jp)
    enc = p.pp["encoder"]
    assert len(enc["layers"]) == p.cfg.encoder_layers == 2
    pairs = [(layer["xattn"], jax.tree.map(lambda a, r=r: a[r], tree["blocks"]["p0"])["xattn"])
             for r, layer in enumerate(p.pp["layers"])]
    pairs += [(layer, jax.tree.map(lambda a, r=r: a[r], tree["encoder"]["blocks"]["p0"]))
              for r, layer in enumerate(enc["layers"])]
    pairs += [(enc["ln"], tree["encoder"]["ln"])]

    def same(port, ref):
        assert port.keys() == ref.keys()
        for key, val in ref.items():
            if isinstance(val, dict):
                same(port[key], val)
                continue
            t = port[key]
            assert t.dtype == (torch.float32 if key in F32_LEAVES else torch.bfloat16)
            np.testing.assert_array_equal(
                t.float().numpy(), torch.from_numpy(np.array(val, np.float32)).to(
                    t.dtype).float().numpy())

    for port, ref in pairs:
        same(port, ref)
    assert "ln_kv" in p.pp["layers"][0]["xattn"]


def test_engine_slots_keep_their_own_encoder_states():
    """Two requests of equal prompt length with different frames in a
    two-slot engine give each the tokens and decode logits a one-slot
    engine gives it alone: ``enc_out`` is per slot."""
    p = _pair("float32")
    prompts = [tokens(4, (7,)), tokens(5, (7,))]
    extras = [{"enc_embed": _frames(6 + i, 1)[0]} for i in range(2)]
    reqs, logits, eng = run_engine(ServeEngine, Request, p.pm, p.pp, prompts,
                                   slots=2, max_new=5, extras=extras)
    assert eng.cache["enc_out"].shape == (2, FRAMES, 64)
    assert not torch.equal(eng.cache["enc_out"][0], eng.cache["enc_out"][1])
    steps = np.stack(logits[2:])[:, :, 0]             # (step, slot, V)
    for i in range(2):
        alone, one, _ = run_engine(ServeEngine, Request, p.pm, p.pp, [prompts[i]],
                                   slots=1, max_new=5, extras=[extras[i]])
        assert alone[0].out == reqs[i].out and len(reqs[i].out) == 6
        assert rel(torch.from_numpy(steps[:, i]), np.stack(one[1:])[:, 0, 0]) <= 1e-5


def test_stubs_are_checked():
    """A whisper request needs its frames (2-D, as many as the engine's
    other requests'), and takes no patches; ``prefill`` needs ``(B, Se,
    D)`` frames."""
    p = _pair("float32")
    eng = ServeEngine(p.pm, p.pp, batch_slots=2, s_cache=16)
    prompt = tokens(4, (5,))
    frames = _frames(1, 1)[0]
    for extras in (None, {"patches": frames}, {"enc_embed": frames, "patches": frames},
                   {"enc_embed": frames[None]}):
        with pytest.raises(ValueError):
            eng.submit(Request(0, prompt, extras=extras))
    eng.submit(Request(0, prompt, extras={"enc_embed": frames}))
    with pytest.raises(ValueError, match="encoder frames"):
        eng.submit(Request(1, prompt, extras={"enc_embed": frames[:-1]}))
    toks = torch.from_numpy(tokens(4, (2, 5)))
    with pytest.raises(ValueError, match="needs enc_embed"):
        p.pm.prefill(p.pp, toks, 16)
    with pytest.raises(ValueError, match="takes no patches"):
        p.pm.prefill(p.pp, toks, 16, enc_embed=torch.zeros(2, 3, 64),
                     patches=torch.zeros(2, 3, 64))
    with pytest.raises(ValueError, match="expected"):
        p.pm.prefill(p.pp, toks, 16, enc_embed=torch.zeros(2, 3, 32))


def test_untied_embeddings_match_jax():
    """Whisper with ``tied_embeddings=False``: the logits read the ``out``
    table, in prefill and decode (against the JAX ``forward``)."""
    p = pair(ARCH, "float32", "float32", tied=False)
    assert set(p.pp["embed"]) == {"tok", "out"}
    prompt, enc = tokens(1, (2, 6)), _frames(3, 2)
    logits, _, _ = run_both(p, prompt, 16, 1, seed=2, stub={"enc_embed": enc})
    seq = np.concatenate([prompt, tokens(2, (1, 2, 1))[0]], axis=1)
    full, _ = jax.jit(p.jm.forward)(p.jp, {"tokens": jnp.asarray(seq),
                                           "enc_embed": jnp.asarray(enc)})
    for i, (got, _) in enumerate(logits):
        assert rel(got, full[:, 5 + i][:, None]) <= TOL["float32"], i


def test_launcher_smoke_on_cpu(capsys):
    """The launcher draws each request's frames from its seed."""
    reqs = launch_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                              "--requests", "3", "--max-new", "4"])
    assert all(r.done and len(r.out) == 5 for r in reqs)
    assert all(r.extras["enc_embed"].shape == (launch_serve.SMOKE_ENC_FRAMES, 64)
               for r in reqs)
    assert "[serve] 3/3 requests, 15 tokens" in capsys.readouterr().out
