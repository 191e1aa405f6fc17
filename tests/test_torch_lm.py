"""The port's LM serving path against the JAX package's, at
``smoke_config("granite-3-8b")`` (2 layers, d_model 64, 4 query / 2 KV
heads of 16, vocab 256): the copied configs, the layers, ``prefill`` (last
logits and the K/V written to the cache), several ``decode_step``s, the
``ServeEngine`` token streams and logits, and the launcher.  The JAX
model's parameters are carried over with ``repro_torch.models.convert``;
the port runs on the CPU, i.e. the flash kernel's plain version.

Tolerances, as max |port - jax| <= tol * max |jax| (``_rel``): f32 1e-5
(the same f32 arithmetic summed in another order); bf16 (``dtype=
"bfloat16"``) 2e-2, since the two frameworks round bf16 products and
activations at different points.  The KV cache is bf16 in both variants
(``kv_cache_dtype`` stays bf16 in the smoke config), so an f32 key that
differs by one rounding step can round one bf16 step apart: the cache's
contents are compared at 4e-3 in f32, one bf16 step (2^-8) of the largest
entry."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.models import config as jax_config
from repro.models import layers as jl
from repro.models.model import Model as JaxModel
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro_torch.configs import ARCH_IDS, get, smoke_config
from repro_torch.launch import serve as launch_serve
from repro_torch.models import config as port_config
from repro_torch.models import layers as pl
from repro_torch.models.convert import F32_LEAVES, from_jax
from repro_torch.models.model import DTYPES, Model
from repro_torch.serve.engine import Request, ServeEngine

ARCH = "granite-3-8b"
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
CACHE_TOL = {"float32": 4e-3, "bfloat16": 2e-2}


def _rel(got, want) -> float:
    got = got.float().numpy() if torch.is_tensor(got) else np.asarray(got, np.float32)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _cfg(dtype):
    return dataclasses.replace(smoke_config(ARCH), dtype=dtype)


def _pair(dtype, seed=0):
    """The JAX model and its parameters, and the port's model on the CPU
    with the same parameters."""
    cfg = _cfg(dtype)
    jm = JaxModel(dataclasses.replace(jax_smoke_config(ARCH), dtype=dtype), remat=False)
    jp = jm.init(jax.random.key(seed))
    pm = Model(cfg, device="cpu")
    return jm, jp, pm, from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


# --------------------------------------------------------------------------
# configs
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", sorted(jax_config.ARCHS))
def test_config_copy_matches_jax(arch):
    assert arch in ARCH_IDS
    assert dataclasses.asdict(get(arch)) == dataclasses.asdict(jax_config.get_config(arch))
    assert (dataclasses.asdict(port_config.smoke_config(arch))
            == dataclasses.asdict(jax_config.smoke_config(arch)))
    assert get(arch).params_B() == jax_config.get_config(arch).params_B()


PORTED_ARCHS = ("gemma3-1b", "gemma3-12b", "qwen1.5-32b", "recurrentgemma-2b",
                "xlstm-350m", "llama4-scout-17b-a16e", "arctic-480b",
                "whisper-medium", "paligemma-3b")
# what the port still refuses: a decoder block kind it has no path for (the
# JAX package runs an "attn_bidir" decoder block as full attention; no
# config has one) and a KV cache dtype outside bfloat16 / float32 / int8
UNPORTED_CONFIGS = {"decoder attn_bidir": dict(block_pattern=("attn_bidir",)),
                    "float16 KV cache": dict(kv_cache_dtype="float16")}


@pytest.mark.parametrize("what", UNPORTED_CONFIGS)
def test_unported_archs_raise(what):
    cfg = dataclasses.replace(smoke_config(ARCH), **UNPORTED_CONFIGS[what])
    with pytest.raises(NotImplementedError, match="ROADMAP A12"):
        Model(cfg, device="cpu")


def test_every_arch_is_ported_or_raises():
    """Every arch of the JAX package is ported: none raises."""
    assert sorted(PORTED_ARCHS + (ARCH,)) == sorted(jax_config.ARCHS)
    for arch in jax_config.ARCHS:
        Model(get(arch), device="meta")


def _stub(model, B, rows=12, seed=9):
    """The modality stub ``model.prefill`` takes, as keywords: whisper's
    ``rows`` frames, paligemma's ``prefix_len`` patches."""
    if model.stub is None:
        return {}
    cfg = model.cfg
    rows = rows if model.stub == "enc_embed" else cfg.prefix_len
    return {model.stub: torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (B, rows, cfg.d_model)).astype(np.float32))}


@pytest.mark.parametrize("arch", PORTED_ARCHS)
def test_ported_archs_build_on_cpu(arch):
    """The archs of the later LM slices build, init and run a prefill (with
    their modality stub) and a decode step at their smoke size (the parity
    tests are in ``tests/test_torch_lm_gemma3.py``,
    ``test_torch_lm_recurrent.py``, ``test_torch_lm_moe.py``,
    ``test_torch_lm_xlstm.py``, ``test_torch_lm_whisper.py`` and
    ``test_torch_lm_paligemma.py``)."""
    cfg = smoke_config(arch)
    model = Model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    assert len(params["layers"]) == cfg.num_layers
    logits, cache = model.prefill(params, torch.from_numpy(_tokens(1, (2, 11), 256)), 16,
                                  **_stub(model, 2))
    logits, cache = model.decode_step(params, torch.zeros((2, 1), dtype=torch.long), cache)
    assert logits.shape == (2, 1, cfg.vocab_pad) and torch.isfinite(logits).all()
    assert cache["idx"] == 12 + cfg.prefix_len


def _leaf_shapes(tree, prefix=()):
    """``{path: (shape, dtype name)}`` of a tree's arrays (dicts, lists)."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for key, val in items:
        if isinstance(val, (dict, list)):
            out.update(_leaf_shapes(val, prefix + (key,)))
        else:
            out[prefix + (key,)] = (tuple(val.shape), str(val.dtype).split(".")[-1])
    return out


@pytest.mark.parametrize("arch", (ARCH,) + PORTED_ARCHS)
def test_param_shapes_match_jax_on_meta(arch):
    """At full size, with nothing allocated: the port's parameters on the
    meta device against ``jax.eval_shape`` of the JAX init, leaf for leaf
    (the stacked ``reps`` axis taken off); weights bf16, the leaves the JAX
    package uses in f32 (norm scales, ``lam``, the sLSTM's recurrent
    matrices) f32."""
    cfg = get(arch)
    port = Model(cfg, device="meta").init()
    want = jax.eval_shape(JaxModel(jax_config.get_config(arch)).init, jax.random.key(0))
    P = len(cfg.block_pattern)
    reps = cfg.num_layers // P
    layers = [{k: (shape[1:], dt) for k, (shape, dt)
               in _leaf_shapes(want["blocks"][f"p{i % P}"]).items()}
              for i in range(reps * P)]
    layers += [_leaf_shapes(t) for t in want["tail"]]
    assert len(port["layers"]) == len(layers) == cfg.num_layers
    if cfg.encoder_layers:
        enc = {k: (shape[1:], dt) for k, (shape, dt)
               in _leaf_shapes(want["encoder"]["blocks"]["p0"]).items()}
        assert len(port["encoder"]["layers"]) == cfg.encoder_layers
        layers += [enc] * cfg.encoder_layers
        port["layers"] = port["layers"] + port["encoder"]["layers"]
    for got, ref in zip(port["layers"], layers):
        got = _leaf_shapes(got)
        assert got.keys() == ref.keys()
        for path, (shape, dtype) in got.items():
            assert shape == ref[path][0], path
            assert dtype == ("float32" if path[-1] in F32_LEAVES else "bfloat16"), path
    tops = ("embed", "final_ln") + tuple(k for k in ("patch_proj",) if k in want)
    assert set(port) - {"layers"} == set(tops) | ({"encoder"} if cfg.encoder_layers else set())
    if cfg.encoder_layers:
        tops += ("encoder",)
        port["encoder"] = {"ln": port["encoder"]["ln"]}
        want = dict(want, encoder={"ln": want["encoder"]["ln"]})
    for name in tops:
        got, ref = _leaf_shapes(port[name]), _leaf_shapes(want[name])
        assert {k: v[0] for k, v in got.items()} == {k: v[0] for k, v in ref.items()}


@pytest.mark.parametrize("arch", ["gemma3-1b", "recurrentgemma-2b", "xlstm-350m"])
def test_from_jax_pattern_with_tail(arch):
    """Two repetitions of a longer pattern and a tail of two: layer ``r *
    P + pos`` is slice ``r`` of block ``p<pos>``, then the tail in order;
    bf16 weights, the ``F32_LEAVES`` (norm scales, ``lam``, the sLSTM's
    recurrent matrices) f32."""
    cfg = dataclasses.replace(smoke_config(arch), dtype="bfloat16")
    P = len(cfg.block_pattern)
    cfg = dataclasses.replace(cfg, num_layers=2 * P + 2)
    jcfg = dataclasses.replace(jax_smoke_config(arch), dtype="bfloat16", num_layers=2 * P + 2)
    tree = jax.tree.map(np.asarray, JaxModel(jcfg).init(jax.random.key(4)))
    got = from_jax(tree, cfg, device="cpu")
    want = [jax.tree.map(lambda a, r=r: a[r], tree["blocks"][f"p{pos}"])
            for r in range(2) for pos in range(P)] + list(tree["tail"])
    assert len(tree["tail"]) == 2 and len(got["layers"]) == len(want) == 2 * P + 2

    def same(port, ref):
        assert port.keys() == ref.keys()
        for key, val in ref.items():
            if isinstance(val, dict):
                same(port[key], val)
                continue
            t = port[key]
            assert t.dtype == (torch.float32 if key in F32_LEAVES else torch.bfloat16)
            np.testing.assert_array_equal(
                t.float().numpy(),
                torch.from_numpy(np.array(val, np.float32)).to(t.dtype).float().numpy())

    for port, ref in zip(got["layers"], want):
        same(port, ref)


def test_full_granite_on_meta_has_params_B():
    cfg = get(ARCH)
    params = Model(cfg, device="meta").init()
    counted = 0

    def walk(tree):
        nonlocal counted
        for key, val in tree.items():
            if isinstance(val, dict):
                walk(val)
            elif key != "scale":          # params_B counts no norm scales
                counted += val.numel()
                assert val.dtype == torch.bfloat16, key

    walk(params["embed"])
    for layer in params["layers"]:
        walk(layer)
    assert len(params["layers"]) == 40
    assert params["final_ln"]["scale"].dtype == torch.float32
    # the table is padded to vocab_pad rows; params_B counts vocab_size
    counted -= (cfg.vocab_pad - cfg.vocab_size) * cfg.d_model
    assert counted == round(cfg.params_B() * 1e9) == 8_170_516_480


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_from_jax_defaults_to_the_card(dtype):
    """``from_jax`` resolves its device like every other entry point: the
    card unless the caller asks for the CPU.  On the CPU it gives layer
    ``r * len(pattern) + pos`` as slice ``r`` of the JAX pytree's stacked
    block ``p<pos>``, weights in the compute dtype and norm scales in f32."""
    cfg = _cfg(dtype)
    jm = JaxModel(dataclasses.replace(jax_smoke_config(ARCH), dtype=dtype), remat=False)
    tree = jax.tree.map(np.asarray, jm.init(jax.random.key(3)))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            from_jax(tree, cfg)
    got = from_jax(tree, cfg, device="cpu")
    pattern = cfg.block_pattern
    want = [jax.tree.map(lambda a, r=r: a[r], tree["blocks"][f"p{pos}"])
            for r in range(cfg.num_layers // len(pattern))
            for pos in range(len(pattern))] + list(tree["tail"])
    assert len(got["layers"]) == len(want) == cfg.num_layers

    def same(port, ref):
        assert port.keys() == ref.keys()
        for key, val in ref.items():
            if isinstance(val, dict):
                same(port[key], val)
                continue
            t = port[key]
            assert t.device.type == "cpu"
            assert t.dtype == (torch.float32 if key == "scale" else DTYPES[dtype])
            np.testing.assert_array_equal(
                t.float().numpy(),
                torch.from_numpy(np.array(val, np.float32)).to(t.dtype).float().numpy())

    for port, ref in zip(got["layers"], want):
        same(port, ref)
    same(got["embed"], tree["embed"])
    same(got["final_ln"], tree["final_ln"])


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norm_rope_embed_match_jax(dtype):
    _, jp, _, pp = _pair(dtype)
    cfg = _cfg(dtype)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, cfg.d_model)).astype(np.float32)
    scale = rng.standard_normal(cfg.d_model).astype(np.float32)
    got = pl.rms_norm({"scale": torch.from_numpy(scale)}, torch.from_numpy(x).to(tdt))
    want = jl.rms_norm({"scale": jnp.asarray(scale)}, jnp.asarray(x, jdt))
    assert _rel(got, want) <= TOL[dtype]
    h = rng.standard_normal((2, 9, 3, cfg.hd)).astype(np.float32)
    pos = np.tile(np.arange(5, 14), (2, 1))
    got = pl.apply_rope(torch.from_numpy(h).to(tdt), torch.from_numpy(pos),
                        pl.RopeSpec(cfg.hd, cfg.rope_theta))
    want = jl.apply_rope(jnp.asarray(h, jdt), jnp.asarray(pos),
                         jl.RopeSpec(cfg.hd, cfg.rope_theta))
    assert _rel(got, want) <= TOL[dtype]
    toks = _tokens(2, (2, 9), cfg.vocab_size)
    got = pl.embed_apply(pp["embed"], cfg, torch.from_numpy(toks), tdt)
    want = jl.embed_apply(jp["embed"], cfg, jnp.asarray(toks), jdt)
    assert _rel(got, want) == 0.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind,window", [("causal", 0), ("window", 24)])
def test_flash_attention_matches_model_flash(kind, window, dtype):
    """The layer's flash attention (the kernel's plain version here) against
    the JAX model's scan-based flash attention, GQA, ragged S."""
    rng = np.random.default_rng(3)
    shapes = [(2, 100, 4, 16), (2, 100, 2, 16), (2, 100, 2, 16)]
    arrs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    got = pl.flash_attention(*(torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs),
                             kind=kind, window=window)
    want = jl.flash_attention(*(jnp.asarray(a, getattr(jnp, dtype)) for a in arrs),
                              kind=kind, window=window, block_q=32, block_k=32)
    assert _rel(got, want) <= TOL[dtype]


def test_unported_attention_options_raise():
    """Every attention kind of the JAX package runs; an unknown one raises,
    and the launcher's ``--ckpt`` still raises until checkpoints are
    ported."""
    q = torch.zeros((1, 8, 2, 16))
    for kind in ("full", "causal", "prefix", "window"):
        assert pl.flash_attention(q, q, q, kind=kind, window=4,
                                  prefix_len=3).shape == q.shape
    with pytest.raises(ValueError, match="bidirectional"):
        pl.flash_attention(q, q, q, kind="bidirectional")
    with pytest.raises(NotImplementedError, match="checkpoints"):
        launch_serve.main(["--smoke", "--device", "cpu", "--ckpt", "somewhere"])


@pytest.mark.parametrize("offset", [0, 37])
def test_sinusoidal_positions_match_jax(offset):
    """Whisper's position table, from an offset (a decode step's): equal to
    the JAX package's, both f64 angles rounded to f32."""
    got = pl.sinusoidal_positions(9, 64, offset)
    assert got.dtype == torch.float32 and got.shape == (9, 64)
    np.testing.assert_array_equal(got.numpy(), jl.sinusoidal_positions(9, 64, offset))
    np.testing.assert_array_equal(pl.sinusoidal_positions(1, 64, offset + 4).numpy(),
                                  got.numpy()[4:5])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["full", "prefix", "cross"])
def test_full_prefix_and_cross_attention_blocks_match_jax(case, dtype):
    """The attention block with whisper's and paligemma's masks against the
    JAX block: ``"full"`` without RoPE (the encoder), ``"prefix"`` with
    RoPE (prefix 20 inside the JAX scan's one key block of 50: ROADMAP
    C-ref 12), and cross-attention over 30 encoder states with ``ln_kv``."""
    _, jp, _, pp = _pair(dtype)
    cfg = _cfg(dtype)
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 50, cfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((2, 30, cfg.d_model)).astype(np.float32)
    ln_kv = (0.5 * rng.standard_normal(cfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(50), (2, 1))
    jblock = dict(jax.tree.map(lambda a: a[0], jp["blocks"]["p0"])["mix"],
                  ln_kv={"scale": jnp.asarray(ln_kv)})
    pblock = dict(pp["layers"][0]["mix"], ln_kv={"scale": torch.from_numpy(ln_kv)})
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    kw = {"full": dict(kind="full", rope=False),
          "prefix": dict(kind="prefix", prefix_len=20),
          "cross": dict(kind="full", rope=False)}[case]
    got = pl.attention_apply(pblock, cfg, torch.from_numpy(x).to(tdt),
                             torch.from_numpy(pos),
                             kv_src=torch.from_numpy(enc).to(tdt) if case == "cross" else None,
                             **kw)
    want = jl.attention_apply(jblock, cfg, jnp.asarray(x, jdt), jnp.asarray(pos),
                              kv_src=jnp.asarray(enc, jdt) if case == "cross" else None,
                              **kw)
    assert got.dtype == tdt and _rel(got, want) <= TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_untied_embeddings_match_jax(dtype):
    """``tied_embeddings=False``: the port's init draws an ``out`` table of
    std ``d_model ** -0.5``, and with the JAX parameters carried across its
    prefill and decode logits come from that table, as the JAX model's."""
    over = dict(dtype=dtype, tied_embeddings=False, kv_cache_dtype="float32")
    cfg = dataclasses.replace(smoke_config(ARCH), **over)
    port = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))["embed"]
    assert port["out"].shape == port["tok"].shape == (cfg.vocab_pad, cfg.d_model)
    assert abs(port["out"].float().std().item() * cfg.d_model ** 0.5 - 1.0) < 0.1
    jm = JaxModel(dataclasses.replace(jax_smoke_config(ARCH), **over), remat=False)
    jp = jm.init(jax.random.key(5))
    pm = Model(cfg, device="cpu")
    pp = from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    assert set(pp["embed"]) == {"tok", "out"}
    toks = _tokens(8, (2, 13), 256)
    got, cache = pm.prefill(pp, torch.from_numpy(toks), 32)
    want, jcache = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, 32)
    assert _rel(got, want) <= TOL[dtype]
    t = _tokens(9, (2, 1), 256)
    got, _ = pm.decode_step(pp, torch.from_numpy(t), cache)
    want, _ = jm.decode_step(jp, jnp.asarray(t), jcache)
    assert _rel(got, want) <= TOL[dtype]
    tied = dict(pp, embed={"tok": pp["embed"]["tok"]})
    assert _rel(pm.prefill(tied, torch.from_numpy(toks), 32)[0], want) > 10 * TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_matches_jax(dtype):
    rng = np.random.default_rng(4)
    q = rng.standard_normal((3, 1, 4, 16)).astype(np.float32)
    kc, vc = (rng.standard_normal((3, 20, 2, 16)).astype(np.float32) for _ in range(2))
    tq = torch.from_numpy(q).to(getattr(torch, dtype))
    tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (kc, vc))
    jq = jnp.asarray(q, getattr(jnp, dtype))
    jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (kc, vc))
    for cur in (1, 13, 20):
        got = pl.decode_attention(tq, tk, tv, cur)
        assert _rel(got, jl.decode_attention(jq, jk, jv, jnp.asarray(cur))) <= TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_and_mlp_blocks_match_jax(dtype):
    _, jp, _, pp = _pair(dtype)
    cfg = _cfg(dtype)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 50, cfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(50), (2, 1))
    jblock = jax.tree.map(lambda a: a[1], jp["blocks"]["p0"])   # layer 1
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jx = jnp.asarray(x, getattr(jnp, dtype))
    got = pl.attention_apply(pp["layers"][1]["mix"], cfg, tx, torch.from_numpy(pos))
    want = jl.attention_apply(jblock["mix"], cfg, jx, jnp.asarray(pos))
    assert got.dtype == tx.dtype and _rel(got, want) <= TOL[dtype]
    got = pl.mlp_apply(pp["layers"][1]["ffn"], tx)
    assert _rel(got, jl.mlp_apply(jblock["ffn"], jx)) <= TOL[dtype]


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,s_cache", [(37, 64), (80, 64)], ids=["fits", "longer-than-cache"])
def test_prefill_and_decode_match_jax(S, s_cache, dtype):
    jm, jp, pm, pp = _pair(dtype)
    toks = _tokens(6, (2, S), 256)
    got, cache = pm.prefill(pp, torch.from_numpy(toks), s_cache)
    want, jcache = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, s_cache)
    assert got.shape == want.shape == (2, 1, 256)
    assert _rel(got, want) <= TOL[dtype]
    assert cache["idx"] == int(jcache["idx"]) == S
    for i, slot in enumerate(cache["layers"]):
        for name in ("k", "v"):
            jkv = jcache["blocks"]["p0"]["attn"][name][i]
            assert slot[name].dtype == torch.bfloat16
            assert _rel(slot[name], jkv) <= CACHE_TOL[dtype]
    nxt = _tokens(7, (4, 2, 1), 256)
    for t in nxt:
        got, cache = pm.decode_step(pp, torch.from_numpy(t), cache)
        want, jcache = jm.decode_step(jp, jnp.asarray(t), jcache)
        assert _rel(got, want) <= TOL[dtype]
    assert cache["idx"] == int(jcache["idx"]) == S + len(nxt)


def _run_engine(engine_cls, request_cls, model, params, prompts):
    eng = engine_cls(model, params, batch_slots=2, s_cache=64)
    logits = []

    def record(fn):
        def wrapped(*args):
            out = fn(*args)
            logits.append(np.asarray(out[0] if not torch.is_tensor(out[0])
                                     else out[0].float().numpy(), np.float32))
            return out
        return wrapped

    eng._prefill = record(eng._prefill)
    eng._decode = record(eng._decode)
    reqs = [request_cls(i, p, max_new=4) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run(max_steps=200)
    return reqs, logits, eng


def test_serve_engine_matches_jax_engine():
    jm, jp, pm, pp = _pair("float32")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 256, (n,)).astype(np.int32) for n in (5, 9, 3)]
    jreqs, jlogits, jeng = _run_engine(JaxServeEngine, JaxRequest, jm, jp, prompts)
    preqs, plogits, peng = _run_engine(ServeEngine, Request, pm, pp, prompts)
    assert all(r.done for r in preqs) and all(len(r.out) == 5 for r in preqs)
    assert [r.out for r in preqs] == [r.out for r in jreqs]
    assert peng.steps == jeng.steps and peng.prefills == 3
    assert len(plogits) == len(jlogits)
    for got, want in zip(plogits, jlogits):
        assert got.shape == want.shape
        assert _rel(got, want) <= TOL["float32"]


def test_launcher_smoke_on_cpu(capsys):
    reqs = launch_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                              "--requests", "5", "--max-new", "3"])
    assert all(r.done and len(r.out) == 4 for r in reqs)
    assert "[serve] 5/5 requests, 20 tokens" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["granite-3-8b", "recurrentgemma-2b"])
def test_lm_step_bench_times_decode_on_cpu(arch, tmp_path):
    """``bench/lm_step.py`` (the decode-step timer) on a smoke config on the
    host clock: one record per run, appended to ``--json`` as printed."""
    from pathlib import Path

    from repro_torch.bench import lm_step

    out = tmp_path / "steps.jsonl"
    rec = lm_step.main(["--arch", arch, "--smoke", "--device", "cpu",
                        "--json", str(out)])
    assert rec["layers"] == smoke_config(arch).num_layers
    assert rec["position"] == lm_step.S_CACHE // 2
    assert len(rec["decode_ms_samples"]) == lm_step.SAMPLES
    assert rec["decode_ms"] > 0
    assert rec["tree"] == str(Path(__file__).resolve().parents[1])
    assert out.read_text().splitlines() == [json.dumps(rec)]
