"""Shared set-up of the LM parity tests (``tests/test_torch_lm_*.py``): one
model configuration built by the JAX package and by the port on the same
parameters, the JAX calls jitted once per configuration, and comparisons
of logits and of every cache leaf.

The JAX ``Model.init`` leaves norm scales, biases and the convolution's
``b`` at zero; :func:`pair` overwrites those leaves with seeded noise
before both models take the pytree, so that a dropped bias or scale shows.
The port runs on the CPU, i.e. every kernel's plain version.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.models import config as jax_config
from repro.models.model import Model as JaxModel
from repro_torch.models import config as port_config
from repro_torch.models.convert import from_jax
from repro_torch.models.model import Model

# leaves the JAX init leaves at zero
ZERO_LEAVES = ("scale", "b")


def rel(got, want) -> float:
    """max |got - want| / max |want|."""
    got = got.float().numpy() if torch.is_tensor(got) else np.asarray(got, np.float32)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def configs(arch: str, dtype: str, kv: str | None = None, tail: bool = True, **kw):
    """The smoke configuration of ``arch`` in ``dtype`` (and KV cache dtype
    ``kv``) for both packages.  With ``tail`` it has one pattern repetition
    and two tail blocks, so that the layers of a longer pattern with a tail
    are carried across."""
    over = dict(kw, dtype=dtype)
    if kv is not None:
        over["kv_cache_dtype"] = kv
    if tail:
        over["num_layers"] = len(jax_config.ARCHS[arch].block_pattern) + 2
    return (dataclasses.replace(jax_config.smoke_config(arch), **over),
            dataclasses.replace(port_config.smoke_config(arch), **over))


def noisy(tree, seed: int):
    """``tree`` (numpy leaves) with norm scales, biases and conv biases
    replaced by seeded noise of std 0.5."""
    rng = np.random.default_rng(seed)

    def walk(node):
        out = {}
        for key, val in node.items():
            if isinstance(val, dict):
                out[key] = walk(val)
            elif isinstance(val, list):
                out[key] = [walk(v) for v in val]
            elif key in ZERO_LEAVES:
                out[key] = (0.5 * rng.standard_normal(val.shape)).astype(val.dtype)
            else:
                out[key] = val
        return out

    return walk(tree)


@dataclasses.dataclass
class Pair:
    jcfg: object
    cfg: object
    jm: JaxModel
    jp: dict
    pm: Model
    pp: dict
    prefill: object         # jitted JAX prefill(params, batch, s_cache)
    decode: object          # jitted JAX decode_step(params, tokens, cache)


@functools.lru_cache(maxsize=None)
def _tree(arch: str, tail: bool, seed: int, tied: bool = True) -> dict:
    """The JAX init's f32 masters (the same for every compute dtype), with
    seeded noise in the leaves it leaves at zero."""
    jm = JaxModel(configs(arch, "float32", tail=tail, tied_embeddings=tied)[0],
                  remat=False)
    return noisy(jax.tree.map(np.asarray, jax.jit(jm.init)(jax.random.key(seed))),
                 seed + 100)


@functools.lru_cache(maxsize=None)
def pair(arch: str, dtype: str, kv: str | None = None, tail: bool = True,
         seed: int = 0, tied: bool = True) -> Pair:
    """Both packages' models of :func:`configs` on the same parameters;
    ``tied=False`` unties the embeddings (the JAX init's ``out`` table)."""
    jcfg, cfg = configs(arch, dtype, kv, tail, tied_embeddings=tied)
    jm = JaxModel(jcfg, remat=False)
    tree = _tree(arch, tail, seed, tied)
    pm = Model(cfg, device="cpu")
    return Pair(jcfg, cfg, jm, jax.tree.map(jnp.asarray, tree), pm,
                from_jax(tree, cfg, device="cpu"),
                jax.jit(jm.prefill, static_argnums=2), jax.jit(jm.decode_step))


def tokens(seed, shape, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def jax_layers(p: Pair, jcache) -> list:
    """The JAX cache's per-layer dicts in layer order: slice ``r`` of the
    stacked block ``p<pos>``, then the tail; each as ``{leaf: array}``."""
    cfg = p.cfg
    P = len(cfg.block_pattern)
    reps = cfg.num_layers // P
    out = []
    for i in range(cfg.num_layers):
        slot = (jax.tree.map(lambda a, r=i // P: a[r], jcache["blocks"][f"p{i % P}"])
                if i < reps * P else jcache["tail"][i - reps * P])
        (inner,) = slot.values()            # {"attn": {...}} or {"rec": {...}}
        out.append(inner)
    return out


def _f32(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a, jnp.float32))


def assert_cache_close(p: Pair, cache, jcache, tol: dict) -> None:
    """Every leaf of every layer, in the JAX leaf's dtype and shape: ``tol``
    maps a leaf kind (``"kv"``, ``"scale"``, ``"h"``, ``"conv"``) to a
    tolerance relative to the largest entry; an int8 cache is compared
    dequantized, each entry within ``tol["int8_steps"]`` (default 1)
    quantization steps (a key can round one int8 step apart at a tie)."""
    assert cache["idx"] == int(jcache["idx"])
    for i, (port, ref) in enumerate(zip(cache["layers"], jax_layers(p, jcache))):
        assert port.keys() == ref.keys(), (i, port.keys(), ref.keys())
        for name, want in ref.items():
            got = port[name]
            assert tuple(got.shape) == want.shape, (i, name)
            assert str(got.dtype) == f"torch.{want.dtype}", (i, name, got.dtype)
        if "scale" in ref:
            sp, sj = port["scale"].numpy(), _f32(ref["scale"])
            assert rel(port["scale"], sj) <= tol["scale"], i
            for j, name in enumerate(("k", "v")):
                dp = port[name].float().numpy() * sp[..., j, None]
                dj = _f32(ref[name]) * sj[..., j, None]
                step = np.maximum(sp[..., j], sj[..., j])[..., None]
                steps = tol.get("int8_steps", 1) * (1 + 1e-3)
                assert (np.abs(dp - dj) <= step * steps).all(), (i, name)
        else:
            for name in ref:
                kind = "kv" if name in ("k", "v") else name
                assert rel(port[name], ref[name]) <= tol[kind], (i, name)


def run_both(p: Pair, prompt: np.ndarray, s_cache: int, steps: int, seed: int,
             stub: dict | None = None):
    """Prefill ``prompt`` (with the modality ``stub``, ``{name: numpy
    array}``, where the arch takes one) and decode ``steps`` tokens in both
    packages: ``(logit pairs, (port cache, JAX cache) after prefill, after
    the last step)``."""
    stub = stub or {}
    got, cache = p.pm.prefill(p.pp, torch.from_numpy(prompt), s_cache,
                              **{k: torch.tensor(a) for k, a in stub.items()})
    want, jcache = p.prefill(p.jp, dict({"tokens": jnp.asarray(prompt)},
                                        **{k: jnp.asarray(a) for k, a in stub.items()}),
                             s_cache)
    logits = [(got, want)]
    after_prefill = (dict(cache, layers=[{k: t.clone() for k, t in slot.items()}
                                         for slot in cache["layers"]]), jcache)
    for t in tokens(seed, (steps, prompt.shape[0], 1)):
        got, cache = p.pm.decode_step(p.pp, torch.from_numpy(t), cache)
        want, jcache = p.decode(p.jp, jnp.asarray(t), jcache)
        logits.append((got, want))
    return logits, after_prefill, (cache, jcache)


def run_engine(engine_cls, request_cls, model, params, prompts, *, slots=2,
               s_cache=32, max_new=4, extras=None):
    """Serve ``prompts`` through an engine (request ``i`` with ``extras[i]``
    where given), recording every logits array."""
    eng = engine_cls(model, params, batch_slots=slots, s_cache=s_cache)
    logits = []

    def record(fn):
        def wrapped(*args, **kw):
            out = fn(*args, **kw)
            logits.append(out[0].float().numpy() if torch.is_tensor(out[0])
                          else np.asarray(out[0], np.float32))
            return out
        return wrapped

    eng._prefill = record(eng._prefill)
    eng._decode = record(eng._decode)
    reqs = [request_cls(i, pr, max_new=max_new) for i, pr in enumerate(prompts)]
    for r, ex in zip(reqs, extras or ()):
        r.extras = ex
    for r in reqs:
        eng.submit(r)
    eng.run(max_steps=200)
    return reqs, logits, eng
