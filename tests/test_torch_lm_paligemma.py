"""The port's LM path for paligemma-3b against the JAX package's, at its
smoke configuration with three layers (d_model 64, 4 query heads / 1 KV
head of 16, vocab 256) and a prefix of 4 patches: ``patch_proj`` over the
patches, put before the text, the prefix-LM mask ``(k <= q) | (k <
prefix_len)`` in prefill, ``prefill`` and ``decode_step`` (RoPE positions
and ``idx`` count the patches) with every cache leaf, a sequence longer
than the cache, untied embeddings, ``from_jax``, the ``ServeEngine`` with a
stub per request and the launcher.  Norm scales carry seeded noise
(``tests/_torch_lm_parity.py``); the port runs on the CPU.

The JAX model's prefix mask skips key blocks past the causal diagonal, so
its answer holds only while the prefix fits its first key block (ROADMAP
C-ref 12): here 4 patches in a block of at least 24 keys.

Tolerances, as max |port - jax| <= tol * max |jax|: f32 (with an f32 KV
cache) 1e-5, the same f32 arithmetic summed in another order; bf16 2e-2,
since the two frameworks round bf16 products and activations at different
points (the caches too)."""
import numpy as np
import pytest
import torch

from _torch_lm_parity import (assert_cache_close, pair, rel, run_both, run_engine,
                              tokens)
from repro_torch.launch import serve as launch_serve
from repro_torch.serve.engine import Request, ServeEngine

ARCH = "paligemma-3b"
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
CACHE_TOL = {"float32": {"kv": 1e-5}, "bfloat16": {"kv": 2e-2}}
# (text prompt length, s_cache): the prefix of 4 and the text fit the
# cache, or not (the cache keeps the sequence's first s_cache keys)
CASES = {"fits": (20, 32), "longer-than-cache": (20, 16)}
STEPS = 4


def _pair(dtype, tied=True):
    return pair(ARCH, dtype, "float32" if dtype == "float32" else None, tied=tied)


def _patches(seed, B, n=4):
    return np.random.default_rng(seed).standard_normal((B, n, 64)).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_prefill_and_decode_match_jax(case, dtype):
    """Logits of the prefill and of every step, every cache leaf after the
    prefill and after the last step; ``idx`` counts the patches."""
    p = _pair(dtype)
    T, s_cache = CASES[case]
    logits, first, last = run_both(p, tokens(1, (2, T)), s_cache, STEPS, seed=2,
                                   stub={"patches": _patches(3, 2)})
    for step, (got, want) in enumerate(logits):
        assert got.shape == want.shape == (2, 1, p.cfg.vocab_pad)
        assert rel(got, want) <= TOL[dtype], step
    for cache, jcache in (first, last):
        assert_cache_close(p, cache, jcache, CACHE_TOL[dtype])
    assert first[0]["idx"] == p.cfg.prefix_len + T
    assert last[0]["idx"] == p.cfg.prefix_len + T + STEPS


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_untied_embeddings_match_jax(dtype):
    """``tied_embeddings=False``: prefill and decode logits read the
    ``out`` table, as the JAX model's."""
    p = _pair(dtype, tied=False)
    assert set(p.pp["embed"]) == {"tok", "out"}
    logits, _, _ = run_both(p, tokens(1, (2, 9)), 32, 2, seed=2,
                            stub={"patches": _patches(3, 2)})
    for step, (got, want) in enumerate(logits):
        assert rel(got, want) <= TOL[dtype], step


def test_prefix_is_bidirectional():
    """Under the prefix-LM mask the first patch attends to the last one:
    moving the last patch moves position 0's keys in the second layer's
    cache; a text token moves no earlier position's keys."""
    p = _pair("float32")
    patches, prompt = _patches(3, 1), tokens(1, (1, 9))

    def layer1_keys(pt, pr):
        _, cache = p.pm.prefill(p.pp, torch.from_numpy(pr), 32,
                                patches=torch.from_numpy(pt))
        return cache["layers"][1]["k"][0, :13]

    base = layer1_keys(patches, prompt)
    moved = patches.copy()
    moved[0, -1] += 1.0
    assert (layer1_keys(moved, prompt)[0] - base[0]).abs().max() > 1e-3
    later = prompt.copy()
    later[0, -1] = (later[0, -1] + 1) % 256
    got = layer1_keys(patches, later)
    assert torch.allclose(got[:12], base[:12], rtol=0, atol=1e-6)
    assert (got[12] - base[12]).abs().max() > 1e-3


def test_from_jax_carries_patch_proj():
    p = pair(ARCH, "bfloat16")
    w = p.pp["patch_proj"]["w"]
    assert w.dtype == torch.bfloat16 and w.shape == (64, 64)
    want = torch.from_numpy(np.array(p.jp["patch_proj"]["w"], np.float32))
    np.testing.assert_array_equal(w.float().numpy(),
                                  want.to(torch.bfloat16).float().numpy())


def test_engine_slots_keep_their_own_patches():
    """Two requests of equal prompt length with different patches in a
    two-slot engine give each the tokens and decode logits a one-slot
    engine gives it alone."""
    p = _pair("float32")
    prompts = [tokens(4, (7,)), tokens(4, (7,))]
    extras = [{"patches": _patches(6 + i, 1)[0]} for i in range(2)]
    reqs, logits, eng = run_engine(ServeEngine, Request, p.pm, p.pp, prompts,
                                   slots=2, max_new=5, extras=extras)
    assert eng.cache["idx"] == 4 + 7 + 5
    steps = np.stack(logits[2:])[:, :, 0]             # (step, slot, V)
    assert rel(torch.from_numpy(steps[:, 0]), steps[:, 1]) > 1e-3
    for i in range(2):
        alone, one, _ = run_engine(ServeEngine, Request, p.pm, p.pp, [prompts[i]],
                                   slots=1, max_new=5, extras=[extras[i]])
        assert alone[0].out == reqs[i].out and len(reqs[i].out) == 6
        assert rel(torch.from_numpy(steps[:, i]), np.stack(one[1:])[:, 0, 0]) <= 1e-5


def test_stubs_are_checked():
    """A paligemma request needs its patches and takes no frames;
    ``prefill`` needs ``(B, prefix_len, D)`` patches."""
    p = _pair("float32")
    eng = ServeEngine(p.pm, p.pp, batch_slots=2, s_cache=16)
    prompt = tokens(4, (5,))
    patches = _patches(1, 1)[0]
    for extras in (None, {"enc_embed": patches}, {"patches": patches[0]}):
        with pytest.raises(ValueError):
            eng.submit(Request(0, prompt, extras=extras))
    toks = torch.from_numpy(tokens(4, (2, 5)))
    with pytest.raises(ValueError, match="needs patches"):
        p.pm.prefill(p.pp, toks, 16)
    with pytest.raises(ValueError, match="expected"):
        p.pm.prefill(p.pp, toks, 16, patches=torch.zeros(2, 5, 64))


def test_launcher_smoke_on_cpu(capsys):
    """The launcher draws each request's ``prefix_len`` patches from its
    seed."""
    reqs = launch_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                              "--requests", "3", "--max-new", "4"])
    assert all(r.done and len(r.out) == 5 for r in reqs)
    assert all(r.extras["patches"].shape == (4, 64) for r in reqs)
    assert "[serve] 3/3 requests, 15 tokens" in capsys.readouterr().out
