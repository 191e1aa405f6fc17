"""The port's LM path for xlstm-350m against the JAX package's, at its
smoke configuration with one pattern repetition and two tail blocks (7
mLSTM, 1 sLSTM, then 2 mLSTM; d_model 64, 4 state heads, vocab 256): the
mLSTM's chunkwise scan (one chunk, several, from a given state), both
blocks and their decode states after a prompt (against the JAX prefill's
``_mlstm_state_from_prefill`` / ``_slstm_state_from_prefill``), one decode
step at a time, the prompt lengths the chunkwise scan refuses, the sLSTM's
f32 recurrent matrices under bf16 compute, ``prefill`` and two
``decode_step``s with every cache leaf, the ``ServeEngine`` and the
launcher.  Norm scales and the convolutions' ``b`` carry seeded noise
(``tests/_torch_lm_parity.py``); the port runs on the CPU.

Tolerances, as max |port - jax| <= tol * max |jax|:

- outputs and logits, f32: 1e-5, the same f32 arithmetic summed in
  another order; bf16: 2e-2, since the two frameworks round bf16 products
  and activations at different points;
- the recurrent states (``C``, ``n``, ``m``; ``c``, ``n``, ``m``, ``h``)
  after a prompt, f32: 1e-4.  The mLSTM's log scale ``m`` and the weights
  of ``C`` and ``n`` are exponents of differences of cumulative log-forget
  sums over a chunk (about 0.7 a step, so ~180 over 256 steps), and one
  f32 step of such a sum is 1.5e-5: seen 2.4e-5 at 512 tokens.  bf16:
  4e-2, since a state sums a whole prompt's bf16-rounded gates (seen
  2.9e-2 at 20 tokens, where the logits are within 5e-3);
- the ``conv`` state is bf16 in every run, as in the JAX package: under
  f32 compute an input that differs by one f32 rounding step can round
  one bf16 step apart, up to 2^-7 of the largest entry: 8e-3.  Every
  decode step reads that state, so an f32 run's decode logits and its
  states after decoding are held at 8e-3 too (bf16 states at 4e-2)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm_parity import (assert_cache_close, pair, rel, run_both,
                              run_engine, tokens)
from repro.models import recurrent as jr
from repro.models.model import _mlstm_state_from_prefill, _slstm_state_from_prefill
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro_torch.launch import serve as launch_serve
from repro_torch.models import recurrent as pr
from repro_torch.serve.engine import Request, ServeEngine

ARCH = "xlstm-350m"
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
STATE_TOL = {"float32": 1e-4, "bfloat16": 4e-2}
DECODE_TOL = {"float32": 8e-3, "bfloat16": 2e-2}
STATES = ("C", "n", "m", "c", "h")
CACHE_TOL = {dt: dict(dict.fromkeys(STATES, STATE_TOL[dt]), conv=conv)
             for dt, conv in (("float32", 8e-3), ("bfloat16", 2e-2))}
STEPS = 2
MLSTM, SLSTM = 0, 7       # layers of the pattern


def _dt(dtype):
    return getattr(torch, dtype), getattr(jnp, dtype)


def _block(p, layer):
    """Layer ``layer`` (< the pattern's length) of both packages' trees."""
    return (p.pp["layers"][layer]["mix"],
            jax.tree.map(lambda a: a[0], p.jp["blocks"][f"p{layer}"]["mix"]))


def _x(seed, S, dtype):
    x = np.random.default_rng(seed).standard_normal((2, S, 64)).astype(np.float32)
    tdt, jdt = _dt(dtype)
    return torch.from_numpy(x).to(tdt), jnp.asarray(x, jdt)


def _state_close(got, want, tol):
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and rel(g, w) <= tol


# --------------------------------------------------------------------------
# the mLSTM
# --------------------------------------------------------------------------
@pytest.mark.parametrize("case", ["one-chunk", "four-chunks", "from-a-state"])
def test_mlstm_chunk_scan_matches_jax(case):
    """``W = S``, ``W < S``, and from a given state (a finite log scale)."""
    S, chunk = {"one-chunk": (16, 256), "four-chunks": (32, 8),
                "from-a-state": (24, 8)}[case]
    rng = np.random.default_rng(4)
    B, H, d = 2, 4, 8
    q, k, v = (rng.standard_normal((B, S, H, d)).astype(np.float32) for _ in range(3))
    li = rng.standard_normal((B, S, H)).astype(np.float32)
    lf = np.log(1 / (1 + np.exp(-rng.standard_normal((B, S, H)) - 2))).astype(np.float32)
    state = None
    if case == "from-a-state":
        state = (rng.standard_normal((B, H, d, d)).astype(np.float32),
                 rng.standard_normal((B, H, d)).astype(np.float32),
                 rng.standard_normal((B, H)).astype(np.float32))
    t = [torch.from_numpy(a) for a in (q, k, v, li, lf)]
    got, got_state = pr.mlstm_chunk_scan(
        *t, chunk, None if state is None else tuple(torch.from_numpy(a) for a in state))
    want, want_state = jr._mlstm_chunk_scan(
        *(jnp.asarray(a) for a in (q, k, v, li, lf)), chunk,
        None if state is None else tuple(jnp.asarray(a) for a in state))
    assert got.shape == (B, S, H, d) and rel(got, want) <= TOL["float32"]
    _state_close(got_state, want_state, TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [1, 3, 30, 512])
def test_mlstm_block_and_state_match_jax(S, dtype):
    """The block's output and its decode state after the last position
    against the JAX prefill's ``_mlstm_state_from_prefill``; S = 1 and 3
    are shorter than the conv's history, 512 is two chunks of 256."""
    p = pair(ARCH, dtype)
    port, ref = _block(p, MLSTM)
    tx, jx = _x(S, S, dtype)
    got, ((C, n, m), conv) = pr.mlstm_block_apply(port, p.cfg, tx, return_state=True)
    assert got.dtype == tx.dtype and rel(got, jr.mlstm_block_apply(ref, p.jcfg, jx)) <= TOL[dtype]
    H, d = p.cfg.n_state_heads, 2 * 64 // p.cfg.n_state_heads
    slot = {"C": jnp.zeros((2, H, d, d)), "n": jnp.zeros((2, H, d)),
            "m": jnp.zeros((2, H)), "conv": jnp.zeros((2, 3, 128), jnp.bfloat16)}
    want = _mlstm_state_from_prefill(ref, p.jcfg, jx, slot)
    _state_close((C, n, m), (want["C"], want["n"], want["m"]), STATE_TOL[dtype])
    assert rel(conv.to(torch.bfloat16), want["conv"]) <= CACHE_TOL[dtype]["conv"]


def test_mlstm_state_with_another_chunk():
    """A block run in chunks of 8 still returns the state of the JAX
    prefill's own chunk (one chunk of 32 here): a second scan."""
    p = pair(ARCH, "float32")
    port, ref = _block(p, MLSTM)
    tx, jx = _x(5, 32, "float32")
    got, ((C, n, m), _) = pr.mlstm_block_apply(port, p.cfg, tx, chunk=8,
                                               return_state=True)
    assert rel(got, jr.mlstm_block_apply(ref, p.jcfg, jx, chunk=8)) <= TOL["float32"]
    slot = {"conv": jnp.zeros((2, 3, 128), jnp.bfloat16)}
    want = _mlstm_state_from_prefill(ref, p.jcfg, jx, slot)
    _state_close((C, n, m), (want["C"], want["n"], want["m"]), STATE_TOL["float32"])


def test_mlstm_prompt_length_not_a_multiple_of_the_chunk_raises():
    """A prompt longer than 256 steps must be a multiple of 256: the JAX
    package asserts it (``recurrent.py:153-154``, ROADMAP C-ref 9), the
    port raises ``ValueError`` naming the condition, in the block and in
    ``Model.prefill``."""
    p = pair(ARCH, "float32")
    port, ref = _block(p, MLSTM)
    tx, jx = _x(6, 300, "float32")
    with pytest.raises(AssertionError):
        jr.mlstm_block_apply(ref, p.jcfg, jx)
    with pytest.raises(ValueError, match=r"S % min\(chunk, S\) == 0.*300.*256"):
        pr.mlstm_block_apply(port, p.cfg, tx)
    with pytest.raises(ValueError, match="300"):
        p.pm.prefill(p.pp, torch.from_numpy(tokens(6, (1, 300))), 16)
    got = pr.mlstm_block_apply(port, p.cfg, tx[:, :256])         # 256 fits
    assert rel(got, jr.mlstm_block_apply(ref, p.jcfg, jx[:, :256])) <= TOL["float32"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlstm_decode_steps_match_jax(dtype):
    """Six steps from a nonzero state, the cache updated in place."""
    p = pair(ARCH, dtype)
    tdt, jdt = _dt(dtype)
    port, ref = _block(p, MLSTM)
    rng = np.random.default_rng(2)
    H, d = p.cfg.n_state_heads, 2 * 64 // p.cfg.n_state_heads
    init = {"C": rng.standard_normal((2, H, d, d)), "n": rng.standard_normal((2, H, d)),
            "m": rng.standard_normal((2, H)), "conv": rng.standard_normal((2, 3, 128))}
    init = {k: v.astype(np.float32) for k, v in init.items()}
    # the port updates its cache in place: it gets its own copies
    cache = {k: torch.tensor(v).to(torch.bfloat16 if k == "conv" else torch.float32)
             for k, v in init.items()}
    jcache = {k: jnp.asarray(v, jnp.bfloat16 if k == "conv" else jnp.float32)
              for k, v in init.items()}
    leaves = dict(cache)
    for t in range(6):
        x = rng.standard_normal((2, 1, 64)).astype(np.float32)
        got = pr.mlstm_block_decode(port, p.cfg, torch.from_numpy(x).to(tdt), cache)
        want, jcache = jr.mlstm_block_decode(ref, p.jcfg, jnp.asarray(x, jdt), jcache)
        assert got.dtype == tdt and rel(got, want) <= TOL[dtype], t
        for name in ("C", "n", "m", "conv"):
            assert rel(cache[name], jcache[name]) <= CACHE_TOL[dtype][name], (t, name)
    assert all(cache[k] is leaves[k] for k in leaves)


# --------------------------------------------------------------------------
# the sLSTM
# --------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [1, 3, 30])
def test_slstm_block_and_state_match_jax(S, dtype):
    p = pair(ARCH, dtype)
    port, ref = _block(p, SLSTM)
    tx, jx = _x(S + 10, S, dtype)
    got, ((c, n, m, h), conv) = pr.slstm_block_apply(port, p.cfg, tx, return_state=True)
    assert got.dtype == tx.dtype and rel(got, jr.slstm_block_apply(ref, p.jcfg, jx)) <= TOL[dtype]
    slot = {"conv": jnp.zeros((2, 3, 64), jnp.bfloat16)}
    want = _slstm_state_from_prefill(ref, p.jcfg, jx, slot)
    _state_close((c, n, m, h), (want["c"], want["n"], want["m"], want["h"]),
                 STATE_TOL[dtype])
    assert rel(conv.to(torch.bfloat16), want["conv"]) <= CACHE_TOL[dtype]["conv"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_slstm_decode_steps_match_jax(dtype):
    p = pair(ARCH, dtype)
    tdt, jdt = _dt(dtype)
    port, ref = _block(p, SLSTM)
    rng = np.random.default_rng(3)
    init = {k: rng.standard_normal((2, 64)).astype(np.float32) for k in ("c", "n", "m", "h")}
    init["n"] = np.abs(init["n"]) + 0.5
    init["conv"] = rng.standard_normal((2, 3, 64)).astype(np.float32)
    cache = {k: torch.tensor(v).to(torch.bfloat16 if k == "conv" else torch.float32)
             for k, v in init.items()}
    jcache = {k: jnp.asarray(v, jnp.bfloat16 if k == "conv" else jnp.float32)
              for k, v in init.items()}
    for t in range(6):
        x = rng.standard_normal((2, 1, 64)).astype(np.float32)
        got = pr.slstm_block_decode(port, p.cfg, torch.from_numpy(x).to(tdt), cache)
        want, jcache = jr.slstm_block_decode(ref, p.jcfg, jnp.asarray(x, jdt), jcache)
        assert got.dtype == tdt and rel(got, want) <= TOL[dtype], t
        for name in ("c", "n", "m", "h", "conv"):
            assert rel(cache[name], jcache[name]) <= CACHE_TOL[dtype][name], (t, name)


def test_slstm_recurrent_matrices_stay_f32():
    """The JAX package uses ``rz`` / ``ri`` / ``rf`` / ``ro`` in f32 under
    bf16 compute; so does the port, carried across and from its own
    init, while the block's other weights are bf16."""
    p = pair(ARCH, "bfloat16")
    own = p.pm.init(torch.Generator().manual_seed(0))
    for params in (p.pp, own):
        for layer, kind in zip(params["layers"], p.cfg.kinds()):
            mix = layer["mix"]
            if kind == "slstm":
                for name in ("rz", "ri", "rf", "ro"):
                    assert mix[name].dtype == torch.float32
                    assert mix[name].shape == (4, 16, 16)
                assert mix["wz"]["w"].dtype == mix["ffn"]["wi"]["w"].dtype == torch.bfloat16
            else:
                assert mix["q"]["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        p.pp["layers"][SLSTM]["mix"]["ri"].numpy(),
        np.asarray(p.jp["blocks"][f"p{SLSTM}"]["mix"]["ri"][0], np.float32))


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [20, 512])
def test_prefill_and_decode_match_jax(S, dtype):
    """Logits of the prefill and of each step, and every state leaf (``C``,
    ``n``, ``m``; ``c``, ``n``, ``m``, ``h``; ``conv``) after the prefill
    and after the last step; 512 tokens are two mLSTM chunks."""
    p = pair(ARCH, dtype)
    logits, first, last = run_both(p, tokens(S, (2, S)), 32, STEPS, seed=2)
    for step, (got, want) in enumerate(logits):
        assert got.shape == want.shape == (2, 1, p.cfg.vocab_pad)
        assert rel(got, want) <= (DECODE_TOL if step else TOL)[dtype], step
    assert_cache_close(p, *first, CACHE_TOL[dtype])
    assert_cache_close(p, *last, {name: max(tol, DECODE_TOL[dtype])
                                  for name, tol in CACHE_TOL[dtype].items()})
    assert [set(slot) for slot in last[0]["layers"][:8]] == \
        [{"C", "n", "m", "conv"}] * 7 + [{"c", "n", "m", "h", "conv"}]
    assert last[0]["idx"] == S + STEPS


def test_serve_engine_matches_jax_engine():
    """Token streams and every logits array of the two engines, f32, two
    slots: the joined slot's states are copied leaf by leaf."""
    p = pair(ARCH, "float32")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 256, (n,)).astype(np.int32) for n in (5, 11, 5)]
    kw = dict(s_cache=16, max_new=6)
    jreqs, jlogits, jeng = run_engine(JaxServeEngine, JaxRequest, p.jm, p.jp, prompts, **kw)
    preqs, plogits, peng = run_engine(ServeEngine, Request, p.pm, p.pp, prompts, **kw)
    assert all(r.done and len(r.out) == 7 for r in preqs)
    assert [r.out for r in preqs] == [r.out for r in jreqs]
    assert peng.steps == jeng.steps and peng.prefills == 3
    assert len(plogits) == len(jlogits)
    for got, want in zip(plogits, jlogits):
        assert got.shape == want.shape
        assert rel(torch.from_numpy(got), want) <= DECODE_TOL["float32"]


def test_launcher_smoke_on_cpu(capsys):
    reqs = launch_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                              "--requests", "3", "--max-new", "4"])
    assert all(r.done and len(r.out) == 5 for r in reqs)
    out = capsys.readouterr().out
    assert f"[serve] {ARCH} (smoke) on cpu" in out
    assert "[serve] 3/3 requests, 15 tokens" in out
