"""How far bf16 logits are from f32 ones at the configuration of
``chip_smoke.py``'s card-vs-CPU check for gemma3-1b: its first pattern
repetition (5 local + 1 global layer) at full width, a 1,100-token prompt
past the 1,024-key window, the prefill and 2 decode steps.  The weights
are the JAX init's (seed 0), carried to the port by ``from_jax``; the port
runs on the CPU (the kernels' plain versions).

Per step's logits, as max |a - b| / max |b|, it holds:

- the port's bf16 within 2e-2 of the JAX package's bf16 (the LM parity
  tolerance of ``tests/test_torch_lm_gemma3.py``);
- the port's f32 within 1e-5 of the JAX package's f32;
- the JAX package's own bf16 more than 2e-2 from its f32, and both
  packages' bf16 within BF16_F32_TOL of their f32.  This is the ground of
  the 4e-2 to which ``chip_smoke.py`` holds the card's bf16 against the
  CPU's f32 for this configuration: 2e-2 does not hold for the reference
  itself here.

About 30 s and 6 GB of host memory (the 262,144-row embedding in f32)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.models import config as jax_config
from repro.models.model import Model as JaxModel
from repro_torch.models import config as port_config
from repro_torch.models.convert import from_jax
from repro_torch.models.model import Model

ARCH, LAYERS, PROMPT, STEPS = "gemma3-1b", 6, 1100, 2
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
BF16_F32_TOL = 4e-2


def _rel(a, b) -> list:
    return [float(np.abs(x - y).max() / np.abs(y).max()) for x, y in zip(a, b)]


def test_bf16_gap_from_f32_at_gemma3_1b_first_repetition():
    jfull = dataclasses.replace(jax_config.ARCHS[ARCH], num_layers=LAYERS)
    pfull = dataclasses.replace(port_config.ARCHS[ARCH], num_layers=LAYERS)
    assert pfull.kinds() == ("attn_local",) * 5 + ("attn",)
    tree = jax.tree.map(np.asarray, jax.jit(
        JaxModel(dataclasses.replace(jfull, dtype="float32"), remat=False).init)(
            jax.random.key(0)))
    rng = np.random.default_rng(16)
    prompt = rng.integers(0, pfull.vocab_size, (1, PROMPT)).astype(np.int32)
    nxt = rng.integers(0, pfull.vocab_size, (STEPS, 1, 1)).astype(np.int32)
    s_cache = PROMPT + STEPS
    logits = {}
    for dtype in ("float32", "bfloat16"):
        jm = JaxModel(dataclasses.replace(jfull, dtype=dtype), remat=False)
        jp = jax.tree.map(jnp.asarray, tree)
        out, cache = jax.jit(jm.prefill, static_argnums=2)(
            jp, {"tokens": jnp.asarray(prompt)}, s_cache)
        steps = [np.asarray(jnp.asarray(out, jnp.float32))]
        decode = jax.jit(jm.decode_step)
        for t in nxt:
            out, cache = decode(jp, jnp.asarray(t), cache)
            steps.append(np.asarray(jnp.asarray(out, jnp.float32)))
        logits["jax", dtype] = steps
        del jp, cache

        cfg = dataclasses.replace(pfull, dtype=dtype)
        pm, pp = Model(cfg, device="cpu"), from_jax(tree, cfg, device="cpu")
        out, cache = pm.prefill(pp, torch.from_numpy(prompt.astype(np.int64)), s_cache)
        steps = [out.float().numpy()]
        for t in nxt:
            out, cache = pm.decode_step(pp, torch.from_numpy(t.astype(np.int64)), cache)
            steps.append(out.float().numpy())
        logits["port", dtype] = steps
        del pp, cache

    for dtype, tol in TOL.items():
        assert max(_rel(logits["port", dtype], logits["jax", dtype])) <= tol, dtype
    jax_gap = _rel(logits["jax", "bfloat16"], logits["jax", "float32"])
    port_gap = _rel(logits["port", "bfloat16"], logits["port", "float32"])
    assert max(jax_gap) > TOL["bfloat16"], jax_gap
    assert max(jax_gap) <= BF16_F32_TOL and max(port_gap) <= BF16_F32_TOL, (
        jax_gap, port_gap)
