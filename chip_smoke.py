#!/usr/bin/env python3
"""Build and drive the PyTorch/CUDA port of SpTRSV (``src/repro_torch``) on
one NVIDIA GPU: the level-scheduled and fused solves, the equation
rewriting, the serving tier and the paper's experiments at the size of the
paper's lung2 (``lung2_like(scale=1.0)``:
110,258 rows, 493 levels), the blocked solve on a dense band of the
same row count (``banded_lower(110592, bandwidth=24, fill=1.0)``, the JAX
blocked benchmark's band) and on a band whose panels are too wide to
stage (``banded_lower(8192, bandwidth=300, fill=1.0)``), and the LM
serving path at full width, random weights from a seed: granite-3-8b (4
of 40 layers), then gemma3-1b (6 of 26), recurrentgemma-2b (3 of 26),
gemma3-12b (6 of 48) and qwen1.5-32b (2 of 64), then llama4-scout (2 of
48), arctic (1 of 35) and xlstm-350m (8 of 24), then whisper-medium and
paligemma-3b at full depth.

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit and no result line):

1. print the card's name and power limit; build the CUDA kernels from
   ``src/repro_torch/kernels/csrc`` with nvcc, one process per source, in
   the background while the host generates the matrices and builds the
   solvers and layouts;
   count the tensor-core (``HMMA``) instructions in the flash library's
   SASS, which must not be 0;
2. hold each of the thirteen kernel entry points against its plain torch
   version on the same CUDA tensors at the paths' shapes (f32/f64, m in
   {1, 32}; the scatter layout's level step over lung2's whole forward and
   transpose schedules, one launch per wavefront; the level walk over
   lung2's whole coarsened table in both
   directions, one launch per segment: chains on one block or cluster,
   the transpose's wide rows on up to 32 warps each, and a small lung2 transpose
   whose chains are wide; the single-RHS fused walk on lung2's whole
   forward and transpose fused layouts, the batched fused solve on the
   forward one, and both on a 1,000-row chain, one span per row (the
   walk's time per dependent hop); the blocked walk on the band's layout, the
   wide band's (panels read from device memory), lung2's blocked layout
   (the cooperative grid) and a random layout of mixed block sizes; the
   SpMV on E with and without row lengths, and with v[0] = inf; flash
   attention in bf16/f32 at granite's prefill shape, a ragged
   sliding-window case, each head-dim template 64/128/256, and gemma3-1b's
   and gemma3-12b's prefill shapes with the score softcap of 30, the
   latter at head dim 240 under the 256 template, llama4-scout's and
   arctic's, query groups of 5 and 7, whisper-medium's encoder (full) and
   cross-attention (full, 432 queries over 1,500 keys), and paligemma-3b's
   prefill with its prefix of 256);
3. the paths, each with the launch counts zeroed just before and read just
   after, every kernel of the path launched:
   a. ``SpTRSV.build_pair`` for ``pallas_level``, ``pallas_level`` +
      coarsening and ``pallas_fused`` in f32 and f64, one RHS and a batch
      of 32, forward and transpose (a transpose ``pallas_fused`` batch, ELL
      width 1,975, runs here, in b and in 4 only if its first solve takes
      under TRANSPOSE_FUSED_MAX_S): componentwise backward
      error against the factor, agreement with the plain torch
      ``levelset`` executor, then ``refresh`` and solve again;
   b. the same strategies and ``levelset`` with
      ``rewrite=RewriteConfig()``: backward error against the original
      factor, agreement with the unrewritten ``levelset`` solve, and
      ``refresh`` (which replays the rewrite plan) with the value buffers
      left in place;
   c. ``strategy="blocked"`` on the band and the wide band: residual,
      agreement with ``scipy.sparse.linalg.spsolve_triangular`` in f64 on
      the host, and ``refresh``; one blocked-walk launch per solve, no
      SpMV or per-segment apply launch;
   small matrices of every path are held against a dense solve first;
   d. granite-3-8b (4 of 40 layers) served by ``ServeEngine`` (4 slots, a
      2,048-token cache,
      8 requests with prompts of 512-2,048 tokens, 16 new tokens each):
      every request finishes, every logit is finite, and the flash kernel
      runs once per layer and prefill; then the launcher
      (``repro_torch.launch.serve.main``) with its defaults, and two
      full-width layers on the card (bf16, the kernel) against the same
      weights on the CPU (f32, the plain versions);
   e. the rest of the solver's surface on lung2 (f64): ``serial`` (one
      solve each way, on ``lung2_like(0.3)`` against scipy: phase 3f's
      ``exp1_codegen`` times it on the full lung2) and
      ``levelset_unroll`` (m in {1, 32}) against ``levelset``; ``auto`` on
      the committed ``"cuda"`` calibration row,
      the rewrite left open and given (its plan, modelled costs and
      backward error; phase 4 times it beside the fastest strategy);
      ``sweep`` with the sweep count ``planned_sweeps`` certifies on the
      IC(0) factor of ``poisson2d(332, 332)``, and with one sweep on lung2
      (the levelset fallback spliced in); ``guard`` with injected
      ``zero_pivot`` / ``nan_slab`` faults under each policy and in mixed
      precision (bf16 storage, refined to the f64 tolerance); PCG on
      ``poisson2d(332, 332)`` with IC(0) preconditioners (``auto``,
      ``pallas_fused``, ``pallas_level``, 8 sweeps), one RHS and a batch
      of 32: the true residual checked with scipy and the iteration count
      within 2 of a host PCG (scipy's ``spsolve_triangular``, or the same
      sweeps); then the ``"cuda"`` calibration row re-measured
      (``repro_torch.bench.calibrate``) beside the committed one;
   f. the serving tier: ``SolveService(strategy="auto")`` on lung2 (f64)
      registered with its planned build held, one forward and one
      transpose request answered cold through the serial pair, the build
      released and promoted (bounded wait, no build error), then the same
      requests, steps of 32 and of 1 each way (a width-1 step is one
      single-RHS launch and no batched one, a step of 32 one batched
      launch), ``refresh`` and again; every answer against scipy's
      ``spsolve_triangular`` to 1e-12, cold against promoted to 1e-10; a
      NaN request in a guarded batch of 8 fails alone; then the port's
      ``serve_bench`` at its full size (every request answered, none
      failed, an eviction, the byte budget held, 20 answers against scipy
      to 1e-10) and the paper's experiments (``fig6_levels``,
      ``exp1_codegen``, ``exp2_rewrite``) on the full lung2 with the JAX
      benches' assertions, each writing its shared-schema JSON to
      ``bench_out/BENCH_*_cuda.json``;
   g. the scatter layout (``layout="scatter"``) on lung2 (f64): every
      strategy plain, coarsened and rewritten, m in {1, 32}, both
      directions, held against the permuted ``levelset`` (and against its
      permuted twin where a/b hold one) with one scatter level launch per
      wavefront; ``serial`` on ``lung2_like(0.3)`` (not its transpose
      batch) and ``blocked`` on the band against scipy (one panel SpMV and
      one block apply launch per
      super-level); a scatter ``refresh`` (a cold rebuild) against a fresh
      build; scatter beside permuted ms per solve; then the eight CI
      benches (``refresh``, ``batch_solve``, ``coarsen``, ``blocked``,
      ``sweep``, ``guard``, ``preconditioner``, ``rewrite_planner``) at
      their smoke sizes: answer and structural gates held, planner and
      speed gates printed as met or not, each writing
      ``bench_out/BENCH_<name>_cuda.json``, and phase 3e's calibration row
      as ``BENCH_calibrate_cuda.json``;
   h. ``strategy="distributed"`` on a world of one NCCL rank (NCCL refuses
      two ranks on one card; the CPU tests run 2 and 4 gloo ranks) on lung2
      (f64): both layouts x ``all_gather``/``psum`` x plain, rewritten and
      coarsened, m in {1, 32}, both directions: backward error, agreement
      with ``levelset``, ``psum`` equal to ``all_gather``, the collectives
      per solve equal to ``num_collectives`` (493 plain forward, 58
      rewritten), ms per solve beside ``levelset`` and the difference per
      collective, a permuted refresh, and ``bench/dist_solve.py``
      (``bench_out/BENCH_dist_solve_cuda.json``); then the linear
      recurrence at RecurrentGemma-2B's RG-LRU width, ``(1, 2048, 2560)``
      along ``axis=1``, ``scan`` and ``doubling`` in f32 and f64 against an
      f64 host loop, ``sptrsv`` at T = 512 over 2 lanes, and the chain
      matrix at T = 512 (512 levels, 2 after the rewrite);
   i. the second LM slice's families at full width, random bf16 weights
      from seed 0, each served as granite in d (4 slots, a 2,048-token
      cache, 8 prompts of 512-2,048 tokens, the last 2,048, 16 new tokens):
      gemma3-1b (6 of 26 layers, 5:1 local:global, softcap),
      recurrentgemma-2b (3 of 26 layers, RG-LRU on ``doubling`` and local
      attention), gemma3-12b (6 of 48 layers) and qwen1.5-32b (2 of 64
      layers, QKV bias, int8 KV cache): every request done, finite logits,
      one flash launch per attention layer and prefill, the local rings
      wrapped, qwen's cache int8 with f32 scales; the first pattern
      repetition of gemma3-1b (6 layers, a 1,100-token prompt),
      recurrentgemma-2b (3 layers, 512) and qwen1.5-32b's first layer (512)
      on the card (bf16, the kernel) against
      the same weights on the CPU (the plain versions): the prefill's and 2
      decode steps' logits within 2e-2 of the CPU's bf16, and no further
      from the CPU's f32 than 1.25 times the CPU's bf16 is; then the
      launcher with no argument (gemma3-1b);
   j. the third LM slice's archs, served as in i: llama4-scout (2 of 48
      layers; 16 experts top-1 and a shared expert), arctic (1 of 35
      layers; 128 experts top-2 and a dense MLP) and xlstm-350m (8 of 24
      layers: mLSTM chunkwise, sLSTM one step a position; prompts whole
      multiples of 256): every request done, finite logits, one flash
      launch per attention layer and prefill (none for xLSTM); the card
      against the CPU on llama4-scout's first layer (256 tokens),
      arctic's first (256 tokens, the CPU's bf16 only) and xlstm's first
      8 (512 tokens), with the (token, choice) routes that differ from the
      card's counted; the routes past capacity in a 2,048-token MoE
      prefill; llama4-scout's first MoE layer expert parallel on a world
      of one NCCL rank against the local path; the launcher on
      xlstm-350m at full size and on the MoE archs at their smoke size;
   k. the fourth LM slice's archs at full width and depth, served as in i
      but each request with its modality stub: whisper-medium (24 encoder
      and 24 decoder layers; 1,500 frames of ``enc_embed``, prompts of
      32-432 tokens, a cache of 448) and paligemma-3b (18 layers; 256
      ``patches`` before prompts of 512-1,792 tokens, a cache of 2,048):
      every request done, finite logits, 72 flash launches per whisper
      prefill (24 encoder, 24 causal, 24 cross) and 18 per paligemma
      prefill (the prefix mask); the card against the CPU on whisper's
      first 2 encoder and 2 decoder layers (1,500 frames, 64 tokens) and
      paligemma's first 2 layers (256 patches and 256 tokens); the launcher
      on each at full size;
4. CUDA-event times per solve and per kernel (median and range of three
   batches; a solve slower than the batch budget is timed once), beside
   each kernel's bound, its plain version and a library call, and the
   launches of each kernel in one forward f64 solve; level launches per
   ``pallas_level`` solve (with and without coarsening and rewriting,
   both directions, m in {1, 32}: one per segment) and the level walk's
   time on each lung2 table; the single-RHS fused walk on the transpose
   layout beside its bound, its plain version and
   ``torch.triangular_solve`` on the transpose, and what its wrapper adds
   around each launch (x̂'s fill; the error word's read, which phases 2
   and 3 make after every walk and phase 4 only where it says so, as the
   solver runs by default); the device's busy
   share of a blocked solve, of the coarsened ``pallas_level`` solve and of
   a ``pallas_fused`` solve each way; for the LM, prefill ms per request, decode ms
   per step beside its weight-read bound, and the device's busy share of a
   decode step (granite; each model of 3i, the busy share for
   recurrentgemma-2b; 3j's, with an MoE step's two weight-read bounds,
   every expert and the routed ones only; and 3k's, with whisper's
   recomputed cross-attention K/V beside it), and the flash kernel at
   gemma3-12b's prefill shape with and without its softcap, at arctic's (a
   query group of 7) and at the three mask shapes of phase 3k, each beside
   SDPA or, for the prefix, compiled ``flex_attention``; the scatter level step on lung2's widest wavefront, and
   the block applies of one scatter blocked band solve beside
   ``torch.bmm``.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Exits non-zero without a result when no
GPU is visible or the port's sources are missing.
"""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# Paths' sizes: the paper's lung2, and the JAX blocked benchmark's band
# (benchmarks/blocked.py: bandwidth 24, fill 1.0, max_block 64) at lung2's
# row count rounded to whole 64-row supernodes.
LUNG2_SCALE = 1.0
BAND_N, BAND_WIDTH = 110_592, 24
SMALL_BAND_N = 600
# a band whose f64 panels (K = 300) do not fit a walk stage (ROADMAP C1)
WIDE_BAND_N, WIDE_BAND_WIDTH = 8192, 300
# a lung2 transpose small enough that its coarsened chains are wide (K up
# to 106): the level walk's warp-per-row chain variant
WIDE_CHAIN_SCALE = 0.05

# max |kernel - plain| / max |plain| on the same inputs: nvcc contracts the
# multiply-add to FMA, so the two may differ by rounding.
KERNEL_TOL = {"float64": 1e-12, "float32": 1e-5}
# componentwise backward error max |b - A x| / (|A| |x| + |b|) of a solve
RESIDUAL_TOL = {"float64": 1e-12, "float32": 1e-5}
# max |x_rewritten - x| / max |x| against the unrewritten levelset solve:
# the rewrite changes the arithmetic.  f64: rtol 1e-8 of the JAX package's
# tests/test_core_rewrite.py:39; f32: the f32 dense-solve tolerance of the
# port's CPU tests (tests/test_torch_solver.py).
REWRITE_AGREE_TOL = {"float64": 1e-8, "float32": 1e-4}
# blocked against scipy's f64 solve: rtol 1e-12 of the JAX package's
# tests/test_blocked.py:166 (f64); f32 as above
BLOCKED_AGREE_TOL = {"float64": 1e-12, "float32": 1e-4}
# the blocked walk's mixed layout in phase 2: a random factor whose relaxed
# supernodes give blocks of 1 to 9 rows with pad lanes, several blocks of
# T > 1 per segment
MIXED_N, MIXED_SUPERNODES = 40_000, dict(relax=1.0, max_block=32)
# H100 SXM data sheet: HBM rate; vector (non-tensor-core) FP rates
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}
WIDTHS = (1, 32)

# The LM serving path: granite-3-8b (models/config.py) at full width,
# served as an engine of 4 slots would serve it.
LM_ARCH = "granite-3-8b"
LM_SLOTS, LM_S_CACHE, LM_REQUESTS, LM_MAX_NEW = 4, 2048, 8, 16
LM_PROMPT_LEN = (512, 2048)          # drawn from a seed, both ends included
LM_TIMED_PROMPTS = (512, 2048)
# flash attention against its plain version: both sum in f32, in another
# order; bf16 outputs may then round one bf16 step apart (2e-2, as the JAX
# package's tests/test_flash_kernel.py)
FLASH_TOL = {"bfloat16": 2e-2, "float32": 1e-5}
# (B, S, Hq, Hkv, hd, window, softcap) of the phase-2 flash checks; the
# first is granite's prefill attention at the longest prompt, and is timed;
# the bf16 kernel has a template per head dim 64 / 128 / 256; the last two
# are gemma3's prefill attention with its score softcap (gemma3-12b's head
# dim 240 runs under the 256 template), and the 12b one is timed too; then
# llama4-scout's and arctic's prefill attention, query groups of 5 and 7
# (arctic's is timed)
FLASH_CASES = {"granite prefill": (1, 2048, 32, 8, 128, 0, 0.0),
               "ragged window": (2, 200, 4, 4, 64, 128, 0.0),
               "hd=256": (1, 300, 4, 1, 256, 0, 0.0),
               "hd=64 GQA 8:1": (2, 1000, 8, 1, 64, 0, 0.0),
               "hd=128 ragged": (2, 65, 4, 4, 128, 0, 0.0),
               "hd=256 long": (1, 2048, 8, 2, 256, 0, 0.0),
               "gemma3-1b prefill": (1, 2048, 4, 1, 256, 1024, 30.0),
               "gemma3-12b prefill": (1, 2048, 16, 8, 240, 0, 30.0),
               "llama4-scout prefill": (1, 2048, 40, 8, 128, 0, 0.0),
               "arctic prefill": (1, 2048, 56, 8, 128, 0, 0.0)}
# (B, Sq, Sk, Hq, Hkv, hd, causal, prefix_len) of the masks phase 3k adds,
# checked in phase 2 and timed in phase 4d: whisper-medium's encoder (full)
# and its cross-attention at the longest served prompt (full, Sq != Sk),
# paligemma-3b's prefill at 2,048 with its 256-patch prefix
FLASH_MASK_CASES = {"whisper encoder": (1, 1500, 1500, 16, 16, 64, False, 0),
                    "whisper cross": (1, 432, 1500, 16, 16, 64, False, 0),
                    "paligemma prefix": (1, 2048, 2048, 8, 1, 256, True, 256)}
# both fused solves on a chain in phase 2: one row per span, so one
# dependent hop of the walk and one grid barrier of the batched grid per row
CHAIN_N = 1000
# a transpose pallas_fused batch whose first solve takes longer stays out
# of the paths and the timings
TRANSPOSE_FUSED_MAX_S = 5.0
# phase 3e: PCG on the IC(0) factor of the 5-point Laplacian at lung2's
# size (poisson2d(332, 332): n = 110,224), f64, against a host PCG with
# scipy's triangular solves; the inexact preconditioner's sweep count, the
# batch width, and how far the card's iteration count may be from the host's
PCG_GRID, PCG_TOL, PCG_MAXITER = 332, 1e-8, 2000
PCG_SWEEPS, PCG_M, PCG_ITER_SLACK = 8, 32, 2
# phase 3f: the serving tier on lung2 (f64): every answer against scipy's
# spsolve_triangular, relative; cold against promoted answers (the JAX
# serve_bench's check); the batch width; a bound on every wait for a
# background build; the mixed traffic's answers checked on a sample
SERVE_TOL, SERVE_COLD_TOL, SERVE_BATCH = 1e-12, 1e-10, 32
SERVE_WAIT_S, SERVE_SAMPLE, SERVE_MIXED_TOL = 900, 20, 1e-10
# phase 3g: the scatter layout on lung2 (f64), each case (tag, options,
# the permuted twin phase 3 holds: (group, tag) or None); serial on a
# smaller lung2 (a solve of the full one takes 6-7 s); the batch budget of
# the scatter-beside-permuted times
SCATTER_CASES = (
    [(t, dict(strategy=t), tw) for t, tw in (
        ("levelset", "levelset"), ("levelset_unroll", None),
        ("pallas_level", "pallas_level"), ("pallas_fused", "pallas_fused"),
        ("sweep", None), ("blocked", None), ("auto", None))]
    + [(f"{t}+coarsen", dict(strategy=t, coarsen=True), tw) for t, tw in (
        ("levelset", None), ("levelset_unroll", None),
        ("pallas_level", "pallas_level+coarsen"))]
    + [(f"rewrite:{t}", dict(strategy=t, rewrite=True), tw) for t, tw in (
        ("levelset", "levelset"), ("levelset_unroll", None),
        ("pallas_level", "pallas_level"), ("pallas_fused", "pallas_fused"),
        ("sweep", None), ("blocked", None), ("auto", None))])
SCATTER_TIMED = ("levelset", "pallas_level", "pallas_level+coarsen",
                 "pallas_fused")
SCATTER_SERIAL_SCALE = 0.3
SCATTER_BUDGET_MS = 50.0
# phase 3h: the distributed solve on a world of one NCCL rank on lung2
# (f64): each case (tag, options), the forward collectives expected per
# solve (493 plain, 58 rewritten; a coarsened chain adds none), the batch
# budget of its times; then the recurrence at RecurrentGemma-2B's RG-LRU
# width (d_rnn 2,560) over a 2,048-step sequence, the literal SpTRSV
# pipeline at T = 512 over 2 lanes, and the chain matrix at T = 512
DIST_CASES = (("plain", {}), ("rewrite", dict(rewrite=True)),
              ("coarsen", dict(coarsen=True)))
DIST_FORWARD_COLLECTIVES = {"plain": 493, "rewrite": 58}
DIST_BUDGET_MS = 50.0
DIST_PROBE_ROWS = 4096
RECURRENCE_SHAPE = (1, 2048, 2560)
RECURRENCE_TOL = {"float64": 1e-12, "float32": 1e-5}
RECURRENCE_SPTRSV = (512, 2)
# The served LM models: granite-3-8b in phase 3d, the second LM slice's
# families in phase 3i, each served alike (the same slots, cache, request
# count and prompt lengths, the last prompt 2,048 tokens so that
# RecurrentGemma's ring of 2,048 wraps in decode).  Each arch: (layers
# served, None for all; layers of the card-vs-CPU check, its first pattern
# repetition or less, 0 for none; that check's prompt; the check's limit
# against the CPU's f32).  Depth cuts: qwen1.5-32b's 64 layers are 68.8 GB
# of bf16 weights on an 80 GB card.  The rest are for the time limit: on an
# H100 the script took 1,097.6-1,137.2 s of its 1,200 after the card check
# before phase 3k (granite-3-8b at 10 layers, gemma3-12b 6, qwen1.5-32b 8,
# llama4-scout 8, arctic 2, the others whole; qwen's and llama4-scout's
# checks 2 layers), so phase 3k is paid for by running each earlier LM
# path at one pattern repetition or at most 4 layers, the slowest first:
# xlstm-350m 8 of 24 (phase 3j took 34.0 s for it whole), llama4-scout 2
# of 48 and its check 1 layer (36.1 s), qwen1.5-32b 2 of 64 and its check
# 1 layer (21.6 s), granite-3-8b 4 of 40 (21.4 s), gemma3-1b 6 of 26
# (16.9 s), recurrentgemma-2b 3 of 26 (16.3 s), arctic 1 of 35 (24.8 s,
# most of it the check).  Phase 4d's launcher still serves granite-3-8b
# whole.
#
# The card-vs-CPU check runs the prefill and LM_CPU_STEPS decode steps on
# the card (bf16, the kernel) and on the CPU (the plain versions) in bf16
# and f32, with the same weights.  Against the CPU's bf16 the card is held
# within LM_CPU_TOL, the JAX package's bf16 attention tolerance.  Against
# the CPU's f32 it is held within the arch's limit: LM_CPU_TOL, but 4e-2
# for gemma3-1b's 6 layers at 1,100 tokens, where the JAX package's own
# bf16 logits are 2.5e-2 to 3.1e-2 from its f32 ones
# (tests/test_torch_lm_bf16_gap.py, at this configuration).
#
# Phase 3j serves the third LM slice's archs alike: llama4-scout (MoE,
# 16 experts top-1 and a shared expert; 48 layers are ~214 GB of bf16),
# its check 1 layer at 256 tokens; arctic (MoE, 128 experts top-2 and a
# dense MLP; one layer is 27.2 GB, 35 are ~953 GB), its check 1 layer
# against the CPU's bf16 only (an f32 host copy of one layer's experts is
# 53.5 GB of the host's 96 GiB), f32 limit None; xlstm-350m's check one
# pattern repetition (7 mLSTM, 1 sLSTM) at 512 tokens.  xLSTM prompts are
# multiples of 256 from 512 to 2,048: the mLSTM's chunkwise scan takes a
# prompt longer than its chunk of 256 only in whole chunks (a ValueError
# otherwise, as the JAX package asserts; ROADMAP C-ref 9).  Widths, expert
# counts, top-k and the capacity factor are as published.
LM_CPU_TOL = 2e-2
LM_MODELS = {"granite-3-8b": (4, 2, 512, LM_CPU_TOL),
             "whisper-medium": (None, 2, 64, LM_CPU_TOL),
             "paligemma-3b": (None, 2, 256, LM_CPU_TOL),
             "gemma3-1b": (6, 6, 1100, 4e-2),
             "recurrentgemma-2b": (3, 3, 512, LM_CPU_TOL),
             "gemma3-12b": (6, 0, 0, None),
             "qwen1.5-32b": (2, 1, 512, LM_CPU_TOL),
             "llama4-scout-17b-a16e": (2, 1, 256, LM_CPU_TOL),
             "arctic-480b": (1, 1, 256, None),
             "xlstm-350m": (8, 8, 512, LM_CPU_TOL)}
LM_SLICE3 = ("llama4-scout-17b-a16e", "arctic-480b", "xlstm-350m")
# Phase 3k serves the fourth LM slice's archs at full width and depth, each
# request with the stub it carries (drawn from a seed with numpy, standard
# normal f32, as the JAX package's SyntheticLM draws its extras): whisper-
# medium's 1,500 encoder frames (30 s of audio at 50 frames a second after
# its convolution's stride), prompts of 32-432 tokens and a cache of 448
# (its text context); paligemma-3b's 256 patches (224 pixels in 14-pixel
# patches) before text prompts of 512-1,792 tokens, so that patches and
# text fit a cache of 2,048.  Each arch: the stub's rows, the served prompt
# range, s_cache, the two timed prompt lengths, and the launcher's extra
# flags (paligemma's cache must hold its 256 patches and the prompt).
LM_SLICE4 = {"whisper-medium": dict(rows=1500, prompt=(32, 432), s_cache=448,
                                    timed=(32, 432), launcher=()),
             "paligemma-3b": dict(rows=256, prompt=(512, 1792), s_cache=2048,
                                  timed=(512, 1792), launcher=("--cache", "512"))}
LM_CPU_STEPS = 2
# the MoE arch one of whose layers runs expert parallel on a world of one
# NCCL rank (arctic's layer would need two more copies of its 26.8 GB of
# experts: the shard and the gathered weights), held against the local
# path: both run the same bf16 products, so only another cuBLAS algorithm
# for the copies could part them
EP_ARCH = "llama4-scout-17b-a16e"
EP_TOL = 2e-2
# H100 SXM data sheet: dense bf16 tensor-core rate (the attention bound)
BF16_TENSOR_FLOPS = 989e12

KERNELS = {
    "sptrsv_level": ("src/repro_torch/kernels/csrc/sptrsv_level.cu",
                     "src/repro/kernels/sptrsv_level/lowering_tpu.py:72"),
    "sptrsv_level_batched": ("src/repro_torch/kernels/csrc/sptrsv_level.cu",
                             "src/repro/kernels/sptrsv_level/lowering_tpu.py:110"),
    "sptrsv_level_scatter": ("src/repro_torch/kernels/csrc/sptrsv_level.cu",
                             "src/repro/kernels/sptrsv_level/lowering_tpu.py:72"),
    "sptrsv_level_scatter_batched": ("src/repro_torch/kernels/csrc/sptrsv_level.cu",
                                     "src/repro/kernels/sptrsv_level/lowering_tpu.py:110"),
    "sptrsv_fused": ("src/repro_torch/kernels/csrc/sptrsv_fused.cu",
                     "src/repro/kernels/sptrsv_fused/lowering_tpu.py:76"),
    "sptrsv_fused_batched": ("src/repro_torch/kernels/csrc/sptrsv_fused.cu",
                             "src/repro/kernels/sptrsv_fused/lowering_tpu.py:137"),
    "spmv_ell": ("src/repro_torch/kernels/csrc/spmv_ell.cu",
                 "src/repro/kernels/spmv_ell/lowering_tpu.py:34"),
    "spmv_ell_batched": ("src/repro_torch/kernels/csrc/spmv_ell.cu",
                         "src/repro/kernels/spmv_ell/lowering_tpu.py:34"),
    "trsm_block_apply": ("src/repro_torch/kernels/csrc/trsm_block.cu",
                         "src/repro/kernels/trsm_block/lowering_tpu.py:41"),
    "trsm_block_apply_batched": ("src/repro_torch/kernels/csrc/trsm_block.cu",
                                 "src/repro/kernels/trsm_block/lowering_tpu.py:41"),
    "trsm_block_walk": ("src/repro_torch/kernels/csrc/trsm_block.cu",
                        "src/repro/kernels/trsm_block/lowering_tpu.py:41"),
    "trsm_block_walk_batched": ("src/repro_torch/kernels/csrc/trsm_block.cu",
                                "src/repro/kernels/trsm_block/lowering_tpu.py:41"),
    "flash_attn": ("src/repro_torch/kernels/csrc/flash_attn.cu",
                   "src/repro/kernels/flash_attn/kernel.py:91"),
}
# kernels that no path launches: held against their plain version and
# timed, with 0 launches on the paths (none since the scatter layout's
# blocked solve runs the block apply)
OFF_PATH = ()
LEVEL_TAGS = ("pallas_level", "pallas_level+coarsen", "pallas_fused")
VARIANTS = {"pallas_level": dict(strategy="pallas_level"),
            "pallas_level+coarsen": dict(strategy="pallas_level", coarsen=True),
            "pallas_fused": dict(strategy="pallas_fused"),
            "levelset": dict(strategy="levelset")}


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, *, warm: bool = True, budget_ms: float = 60.0,
            max_reps: int = 20, samples: int = 3) -> tuple[float, float, float]:
    """``(median, min, max)`` ms per call over ``samples`` batches of repeated
    calls between CUDA events (host launch gaps included — what a caller of
    the solve waits).  A first timed call, after an untimed warm-up unless
    ``warm`` is false (the caller has already run ``fn``), sizes each batch
    to about ``budget_ms`` (60 ms, from 200 and then 120, to keep the
    script within its time limit); a call that alone exceeds the budget is
    timed once."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)

    def batch(reps: int) -> float:
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    if warm:
        fn()
    torch.cuda.synchronize()
    first = batch(1)
    if first >= budget_ms:
        return first, first, first
    reps = int(max(1, min(max_reps, budget_ms // max(first, 1e-3))))
    per = sorted(batch(reps) for _ in range(samples))
    return per[len(per) // 2], per[0], per[-1]


def sass_hmma(lib: Path) -> dict:
    """``HMMA`` (tensor-core) instructions per kernel function in the SASS
    of a built library, read with the toolkit's ``cuobjdump``."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                         text=True, check=True, timeout=300).stdout
    counts, fn = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
        elif "HMMA" in line and fn is not None:
            counts[fn] = counts.get(fn, 0) + 1
    return counts


def fmt_ms(t: tuple[float, float, float]) -> str:
    return f"{t[0]:.4f} ms [{t[1]:.4f}-{t[2]:.4f}]"


def device_busy(torch, fn, reps: int = 5) -> str:
    """Device kernel time per call over host wall time per call, read from
    a ``torch.profiler`` trace of ``reps`` calls ("not measured" when the
    profiler records no device activity)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / reps
        kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    except (RuntimeError, AttributeError) as err:
        return f"not measured (profiler: {err})"
    if not kernels:
        return "not measured (profiler recorded no device time)"
    dev_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / reps
    return (f"device {dev_ms:.4f} ms of {wall_ms:.4f} ms wall per call under "
            f"the profiler ({100 * dev_ms / wall_ms:.1f}% busy, "
            f"{len(kernels) // reps} device ops per call)")


def rel_err(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))


def residual(A, x: np.ndarray, b: np.ndarray) -> float:
    """Componentwise backward error of ``A x = b`` (scipy CSR ``A``)."""
    r = np.abs(b - A @ x)
    scale = abs(A) @ np.abs(x) + np.abs(b)
    return float((r / np.maximum(scale, 1e-300)).max())


def bound_ms(nbytes: float, flops: float, dtype: str) -> tuple[float, str]:
    """The larger of bytes over the HBM rate and FLOPs over the vector FP
    rate, and which of the two it is."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def solve_bound_ms(L, m: int, dtype: str) -> tuple[float, str]:
    """Least time for one solve of ``m`` RHS: each input read once, each
    output written once (off-diagonal int32 index + value, diagonal and b
    read, x written; the gathers of x hit the L2), against the FLOPs
    (mul+sub per off-diagonal, one divide per row)."""
    s = 8 if dtype == "float64" else 4
    off = L.nnz - L.n
    return bound_ms(off * (4 + s) + L.n * s + 2 * L.n * m * s,
                    m * (2 * off + L.n), dtype)


def spmv_bound_ms(E, m: int, dtype: str) -> tuple[float, str]:
    """``y = E v``: E's true nonzeros (int32 index + value) and ``v`` read
    once, ``y`` written once; one multiply-add per nonzero and column."""
    s = 8 if dtype == "float64" else 4
    return bound_ms(E.nnz * (4 + s) + 2 * E.n * m * s, 2 * E.nnz * m, dtype)


def walk_bound_ms(lay, m: int, dtype: str) -> tuple[float, str]:
    """One blocked solve of ``m`` RHS: the inverted diagonal blocks, the
    panel (int32 column + value per slot) and ``bhat`` read once, ``x``
    written once; the panel's and the applies' multiply-adds."""
    s = 8 if dtype == "float64" else 4
    panel = lay.cols_flat.size
    return bound_ms(lay.dinv_flat.size * s + panel * (4 + s) + 2 * lay.n * m * s,
                    2 * m * (panel + lay.dinv_flat.size), dtype)


def scatter_step_bound_ms(entries: int, rows: int, m: int,
                          dtype: str) -> tuple[float, str]:
    """One scatter level step of ``m`` RHS: the step's real entries (int32
    column + value), its row ids and diagonal, and ``b`` at its rows read
    once, ``x`` at its rows written once; a multiply-add per entry and a
    divide per row and column."""
    s = 8 if dtype == "float64" else 4
    return bound_ms(entries * (4 + s) + rows * (4 + s) + 2 * rows * m * s,
                    m * (2 * entries + rows), dtype)


def block_apply_bound_ms(shapes, m: int, dtype: str) -> tuple[float, str]:
    """Block applies of ``(B, T)`` shapes: every ``Dinv`` block and ``rhs``
    read once, ``out`` written once; ``2 T^2 m`` FLOPs per block."""
    s = 8 if dtype == "float64" else 4
    nbytes = sum(B * T * T * s + 2 * B * T * m * s for B, T in shapes)
    return bound_ms(nbytes, sum(2 * B * T * T * m for B, T in shapes), dtype)


def leaves(tree):
    """The tensors of a parameter or cache tree (dicts and lists)."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, list):
        for item in tree:
            yield from leaves(item)
    else:
        yield tree


def tree_to(tree, dev, dtype):
    """``tree`` on ``dev``: the leaves the port keeps in f32 (norm scales,
    ``lam``, the sLSTM's recurrent matrices) as they are, every other tensor
    in ``dtype`` (the port's layout of parameters)."""
    from repro_torch.models.convert import F32_LEAVES

    if isinstance(tree, list):
        return [tree_to(item, dev, dtype) for item in tree]
    return {k: tree_to(v, dev, dtype) if isinstance(v, (dict, list))
            else v.to(dev, v.dtype if k in F32_LEAVES else dtype)
            for k, v in tree.items()}


class RouteLog:
    """While active, records every MoE routing of the port
    (``models/moe._Routes``): per call ``(capacity, expert ids (T, k),
    slots (T * k,))`` on the host."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        from repro_torch.models import moe

        calls, self._moe, self._routes = self.calls, moe, moe._Routes

        class Recording(moe._Routes):
            def __init__(self, params, cfg, x2, C):
                super().__init__(params, cfg, x2, C)
                calls.append((C, self.eflat.reshape(-1, self.k).cpu(), self.slot.cpu()))

        moe._Routes = Recording
        return self

    def __exit__(self, *exc):
        self._moe._Routes = self._routes


def route_flips(a: RouteLog, b: RouteLog) -> tuple[int, int]:
    """``(differing (token, choice) routes, routes)`` of two runs of the
    same MoE calls."""
    check(len(a.calls) == len(b.calls), f"{len(a.calls)} against {len(b.calls)} MoE calls")
    return (sum(int((x[1] != y[1]).sum()) for x, y in zip(a.calls, b.calls)),
            sum(x[1].numel() for x in a.calls))


def flash_checks(torch, dev, rng, record, flash_cuda, gqa_attention_ref) -> None:
    """Phase 2 for flash attention: the kernel against its plain version on
    the same CUDA tensors, causal, bf16 and f32."""
    for what, (B, S, Hq, Hkv, hd, window, cap) in FLASH_CASES.items():
        for dt in ("bfloat16", "float32"):
            q, k, v = (torch.from_numpy(rng.standard_normal(
                (B, S, H, hd), dtype=np.float32)).to(dev, getattr(torch, dt))
                for H in (Hq, Hkv, Hkv))
            kw = dict(causal=True, window=window, softcap=cap)
            got = flash_cuda.flash_attn(q, k, v, **kw)
            want = gqa_attention_ref(q, k, v, **kw)
            record("flash_attn", dt, got.float(), want.float(),
                   f"{what} B={B} S={S} Hq={Hq} Hkv={Hkv} hd={hd} "
                   f"window={window} softcap={cap:g}", tol=FLASH_TOL[dt])
    for what, (B, Sq, Sk, Hq, Hkv, hd, causal, prefix) in FLASH_MASK_CASES.items():
        for dt in ("bfloat16", "float32"):
            q, k, v = (torch.from_numpy(rng.standard_normal(
                (B, S, H, hd), dtype=np.float32)).to(dev, getattr(torch, dt))
                for S, H in ((Sq, Hq), (Sk, Hkv), (Sk, Hkv)))
            kw = dict(causal=causal, prefix_len=prefix)
            got = flash_cuda.flash_attn(q, k, v, **kw)
            want = gqa_attention_ref(q, k, v, **kw)
            record("flash_attn", dt, got.float(), want.float(),
                   f"{what} B={B} Sq={Sq} Sk={Sk} Hq={Hq} Hkv={Hkv} hd={hd} "
                   f"causal={causal} prefix_len={prefix}", tol=FLASH_TOL[dt])


def attn_layers(cfg) -> int:
    """The flash launches of one prefill of ``cfg``: its attention layers,
    and for whisper its encoder layers and its decoder's cross-attention."""
    n = sum(kind.startswith("attn") for kind in cfg.kinds())
    return n + (cfg.encoder_layers + n if cfg.family == "audio" else 0)


def lm_stub(rng, model, rows: int, B: int | None = None):
    """The modality stub of ``model``'s requests, ``{name: (rows, D)}`` or
    with a batch axis ``B``, standard normal f32 from ``rng``; ``{}`` for an
    arch without one (paligemma's rows are its ``prefix_len``)."""
    if model.stub is None:
        return {}
    cfg = model.cfg
    rows = rows if model.stub == "enc_embed" else cfg.prefix_len
    shape = (rows, cfg.d_model) if B is None else (B, rows, cfg.d_model)
    return {model.stub: rng.standard_normal(shape, dtype=np.float32)}


def lm_serve(torch, cfg, model, params, reset_counts, counts, *, phase):
    """Phases 3d, 3i, 3j and 3k: ``ServeEngine`` over LM_REQUESTS prompts,
    the last one of the longest length (LM_PROMPT_LEN, or the arch's range
    in LM_SLICE4, whose requests carry their stub), with the launch counts
    zeroed just before the run and read just after.  Returns the counts and
    the engine."""
    from repro_torch.serve.engine import Request, ServeEngine

    from repro_torch.models.recurrent import MLSTM_CHUNK

    serve = LM_SLICE4.get(cfg.name, {})
    plen, s_cache = serve.get("prompt", LM_PROMPT_LEN), serve.get("s_cache", LM_S_CACHE)
    prompt_rng = np.random.default_rng(15)
    lens = prompt_rng.integers(plen[0], plen[1] + 1, LM_REQUESTS)
    lens[-1] = plen[1]
    if "mlstm" in cfg.kinds():          # whole mLSTM chunks (LM_MODELS' comment)
        lens = np.clip(lens // MLSTM_CHUNK * MLSTM_CHUNK, *plen)
    reqs = [Request(i, prompt_rng.integers(0, cfg.vocab_size, (int(n),)).astype(np.int32),
                    max_new=LM_MAX_NEW,
                    extras=lm_stub(prompt_rng, model, serve.get("rows", 0)) or None)
            for i, n in enumerate(lens)]
    eng = ServeEngine(model, params, batch_slots=LM_SLOTS, s_cache=s_cache)
    finite = []

    def watch(fn):
        def wrapped(*args, **stub):
            logits, cache = fn(*args, **stub)
            check(logits.shape[-1] == cfg.vocab_pad, f"logits {tuple(logits.shape)}")
            finite.append(torch.isfinite(logits).all())
            return logits, cache
        return wrapped

    eng._prefill = watch(eng._prefill)
    eng._decode = watch(eng._decode)
    for r in reqs:
        eng.submit(r)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    eng.run(max_steps=10_000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts()
    toks = sum(len(r.out) for r in reqs)
    stub = (f"; each with {model.stub} {reqs[0].extras[model.stub].shape}"
            if model.stub else "")
    print(f"phase {phase}: ServeEngine({cfg.name}, {LM_SLOTS} slots, s_cache="
          f"{s_cache}): prompts {sorted(int(n) for n in lens)}{stub}; "
          f"{sum(r.done for r in reqs)}/{len(reqs)} requests, {toks} tokens, "
          f"{eng.prefills} prefills, {eng.steps} decode steps in {wall:.2f} s "
          f"(first request's tokens {reqs[0].out}); launches {json.dumps(launches)}")
    check(all(r.done and len(r.out) == LM_MAX_NEW + 1 for r in reqs),
          "a request did not finish with max_new tokens")
    check(eng.prefills == LM_REQUESTS, f"{eng.prefills} prefills")
    check(bool(torch.stack(finite).all()), "non-finite logits on the LM path")
    check(launches["flash_attn"] == attn_layers(cfg) * eng.prefills,
          f"flash_attn launched {launches['flash_attn']} times, expected "
          f"{attn_layers(cfg)} x {eng.prefills} prefills")
    return launches, eng


def lm_launcher(torch, cfg, reset_counts, counts, argv, phase) -> None:
    """Phases 3i, 3j and 4d: the launcher with ``argv`` and its own
    defaults (16 short requests, 4 slots, a 128-token cache), serving
    ``cfg``."""
    from repro_torch.launch import serve as launch_serve

    reset_counts()
    reqs = launch_serve.main(argv)
    torch.cuda.synchronize()
    n = counts()["flash_attn"]
    check(all(r.done for r in reqs), "launcher: a request did not finish")
    check(n == attn_layers(cfg) * len(reqs),
          f"launcher: flash_attn launched {n} times, expected "
          f"{attn_layers(cfg)} x {len(reqs)}")
    print(f"phase {phase}: launcher {argv} ({cfg.name}): {len(reqs)} requests "
          f"done, flash_attn launched {n} times")


def lm_cpu_check(torch, dev, cfg, params, n_layers, prompt, f32_tol, flash_cuda,
                 phase) -> None:
    """Phases 3d, 3i, 3j and 3k: the first ``n_layers`` of a served model
    (and of whisper's encoder) on the card (bf16, the kernel) against the
    same weights on the CPU, in bf16 and, unless ``f32_tol`` is None, in
    f32 (the plain versions): logits of a ``prompt``-token prefill (with the
    arch's stub: whisper's frames, paligemma's patches before the prompt)
    and LM_CPU_STEPS decode steps, the cache as long as the sequence and
    the steps.  The card is held within LM_CPU_TOL of the CPU's bf16 and
    within ``f32_tol`` of its f32.  With experts, the (token, choice)
    routes that differ from the card's are counted and printed (a near tie
    may route apart)."""
    import dataclasses

    from repro_torch.models.model import Model

    t0 = time.perf_counter()
    short = dataclasses.replace(cfg, num_layers=n_layers,
                                encoder_layers=min(cfg.encoder_layers, n_layers))
    sub = {"embed": params["embed"], "final_ln": params["final_ln"],
           "layers": params["layers"][:n_layers]}
    if "encoder" in params:
        sub["encoder"] = {"layers": params["encoder"]["layers"][:n_layers],
                          "ln": params["encoder"]["ln"]}
    if "patch_proj" in params:
        sub["patch_proj"] = params["patch_proj"]
    models = {"card": (Model(short, device=dev), sub),
              "cpu bf16": (Model(short, device="cpu"),
                           tree_to(sub, "cpu", torch.bfloat16))}
    if f32_tol is not None:
        models["cpu f32"] = (Model(dataclasses.replace(short, dtype="float32"),
                                   device="cpu"), tree_to(sub, "cpu", torch.float32))
    tok_rng = np.random.default_rng(16)
    toks = torch.from_numpy(tok_rng.integers(0, cfg.vocab_size, (1, prompt)))
    nxt = torch.from_numpy(tok_rng.integers(0, cfg.vocab_size, (LM_CPU_STEPS, 1, 1)))
    stub = {k: torch.from_numpy(a) for k, a in lm_stub(
        tok_rng, models["card"][0], LM_SLICE4.get(cfg.name, {}).get("rows", 0), 1).items()}
    s_cache = prompt + cfg.prefix_len + LM_CPU_STEPS
    logits, routes = {}, {}
    for what, (model, p) in models.items():
        before = flash_cuda.launches["flash_attn"]
        with RouteLog() as routes[what]:
            out, cache = model.prefill(p, toks.to(model.device), s_cache,
                                       **{k: t.to(model.device) for k, t in stub.items()})
            steps = [out.float().cpu()]
            if what == "card":
                torch.cuda.synchronize()
                check(flash_cuda.launches["flash_attn"] - before == attn_layers(short),
                      f"{cfg.name}: card prefill did not run the flash kernel "
                      "once per attention layer")
            for t in nxt:
                out, cache = model.decode_step(p, t.to(model.device), cache)
                steps.append(out.float().cpu())
        logits[what] = steps
    check(all(bool(torch.isfinite(x).all()) for x in logits["card"]),
          f"{cfg.name}: non-finite card logits")

    def errs(a, b):
        return [rel_err(x, y) for x, y in zip(logits[a], logits[b])]

    def fmt(e):
        return ", ".join(f"{x:.3e}" for x in e)

    same = errs("card", "cpu bf16")
    check(max(same) <= LM_CPU_TOL,
          f"{cfg.name}: card vs CPU bf16 logits rel err {max(same):.3e}")
    f32 = "no f32 run"
    if f32_tol is not None:
        gap = errs("card", "cpu f32")
        check(max(gap) <= f32_tol,
              f"{cfg.name}: card bf16 vs CPU f32 logits rel err {max(gap):.3e}")
        f32 = (f"card bf16 vs CPU f32 {fmt(gap)} (tol {f32_tol:g}); CPU bf16 vs "
               f"CPU f32 {fmt(errs('cpu bf16', 'cpu f32'))}")
    flips = ""
    if cfg.n_experts:
        flips = "; routes differing from the card's: " + ", ".join(
            "{} {} of {}".format(what, *route_flips(routes["card"], log))
            for what, log in routes.items() if what != "card")
    enc = (f" and {short.encoder_layers} encoder layers over "
           f"{tuple(stub['enc_embed'].shape[1:])} frames" if "enc_embed" in stub else "")
    enc += (f" after {tuple(stub['patches'].shape[1:])} patches" if "patches" in stub else "")
    print(f"phase {phase}: {cfg.name}: {n_layers} full-width layers "
          f"{short.kinds()}{enc}, {prompt}-token prompt, logits of the prefill and "
          f"{LM_CPU_STEPS} decode steps: card bf16 vs CPU bf16 max rel err "
          f"{fmt(same)} (tol {LM_CPU_TOL:g}); {f32}{flips}; in "
          f"{time.perf_counter() - t0:.1f} s")


def lm_family(torch, dev, rng, arch, reset_counts, counts, flash_cuda,
              phase) -> dict:
    """Phase 3d (granite), 3i, 3j or 3k for one arch of LM_MODELS, random
    bf16 weights from seed 0: ``ServeEngine`` (every request done, finite
    logits, one flash launch per attention layer, and per whisper encoder
    layer and cross-attention block, and prefill); the local layers' rings
    wrapped; an int8 cache with f32 scales; the first pattern repetition on
    the card against the CPU; then phase 4d's times: prefill ms per request,
    decode ms per step beside its weight-read bound and the device's busy
    share of a decode step.  Returns the served run's launch counts and the
    flash launches per prefill."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.model import Model

    depth, n_check, check_prompt, f32_tol = LM_MODELS[arch]
    full = get_config(arch)
    cfg = full if depth is None else dataclasses.replace(full, num_layers=depth)
    t0 = time.perf_counter()
    model = Model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    w_bytes = sum(x.numel() * x.element_size() for x in leaves(params))
    extra = (f"{cfg.n_experts} experts top-{cfg.top_k}, capacity factor "
           f"{cfg.capacity_factor:g}, shared expert {cfg.shared_expert}, dense "
           f"MLP {cfg.moe_dense_residual}, " if cfg.n_experts else "")
    extra += (f"{cfg.encoder_layers} encoder layers, cross-attention, no RoPE, "
            if cfg.encoder_layers else "")
    extra += f"a prefix of {cfg.prefix_len} patches, " if cfg.prefix_len else ""
    print(f"phase {phase}: {arch}: {cfg.num_layers} of {full.num_layers} layers "
          f"({cfg.block_pattern} repeated), d_model {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.hd}, d_ff {cfg.d_ff}, "
          f"{extra}window {cfg.window}, softcap {cfg.logit_softcap:g}, QKV bias "
          f"{cfg.qkv_bias}, {cfg.kv_cache_dtype} KV cache, vocab {cfg.vocab_size} "
          f"(padded {cfg.vocab_pad}): {w_bytes / 1e9:.3f} GB of parameters on "
          f"the card, random from seed 0, in {time.perf_counter() - t0:.1f} s")
    launches, eng = lm_serve(torch, cfg, model, params, reset_counts, counts,
                             phase=phase)
    rings = [slot["k"].shape[1] for kind, slot in zip(model.kinds, eng.cache["layers"])
             if kind == "attn_local"]
    if rings:
        check(eng.cache["idx"] > max(rings),
              f"{arch}: the local rings of {max(rings)} slots never wrapped "
              f"(position {eng.cache['idx']})")
        print(f"phase {phase}: {arch}: {len(rings)} local rings of {max(rings)} "
              f"slots wrapped: the engine ended at position {eng.cache['idx']}")
    if cfg.kv_cache_dtype == "int8":
        slot = eng.cache["layers"][0]
        check(slot["k"].dtype == torch.int8 and slot["v"].dtype == torch.int8
              and slot["scale"].dtype == torch.float32
              and tuple(slot["scale"].shape) == (LM_SLOTS, LM_S_CACHE, cfg.n_kv_heads, 2),
              f"{arch}: the KV cache is not int8 with f32 scales")
        print(f"phase {phase}: {arch}: KV cache int8, scale "
              f"{tuple(slot['scale'].shape)} f32")
    del eng
    if n_check:
        lm_cpu_check(torch, dev, cfg, params, n_check, check_prompt, f32_tol,
                     flash_cuda, phase)
    if cfg.n_experts:
        moe_checks(torch, dev, rng, cfg, model, params, phase)

    serve = LM_SLICE4.get(arch, {})
    s_cache = serve.get("s_cache", LM_S_CACHE)
    stub = {k: torch.from_numpy(a).to(dev)
            for k, a in lm_stub(rng, model, serve.get("rows", 0), 1).items()}
    with_stub = "".join(f" after {tuple(t.shape[1:])} {k}" for k, t in stub.items())
    for n in serve.get("timed", LM_TIMED_PROMPTS):
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, n))).to(dev)
        t = time_ms(torch, lambda: model.prefill(params, toks, s_cache, **stub))
        print(f"phase 4d: prefill {arch} ({cfg.num_layers} layers) S={n}{with_stub}: "
              f"{fmt_ms(t)} per request ({n / t[0] * 1e3:.0f} tokens/s)")
    cache = model.init_cache(LM_SLOTS, s_cache)
    cache["idx"] = s_cache // 2
    if "enc_embed" in stub:             # every slot's encoder output
        cache["enc_out"] = torch.from_numpy(rng.standard_normal(
            (LM_SLOTS, serve["rows"], cfg.d_model), dtype=np.float32)).to(dev, model.dtype)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (LM_SLOTS, 1))).to(dev)
    t = time_ms(torch, lambda: model.decode_step(params, toks, cache))
    # the weights a step reads: all but whisper's encoder and paligemma's
    # patch projection, which only prefill runs
    w_step = sum(x.numel() * x.element_size() for name in ("embed", "final_ln", "layers")
                 for x in leaves(params[name]))
    # the cache entries a step reads: the live slots of each K/V ring or
    # cache (and their scales), every recurrent state and enc_out whole
    live = sum(x.numel() * x.element_size() * (
        min(s_cache // 2 + 1, x.shape[1]) / x.shape[1]
        if name in ("k", "v", "scale") else 1)
        for slot in cache["layers"] for name, x in slot.items())
    if "enc_out" in cache:
        enc = cache["enc_out"]
        live += enc.numel() * enc.element_size()
        # each step recomputes every cross-attention block's K and V over
        # the encoder's output, as the reference does
        xflops = 2 * 2 * enc.shape[0] * enc.shape[1] * cfg.d_model * cfg.n_kv_heads \
            * cfg.hd * cfg.num_layers
        note = (f"; the cross-attention K/V it recomputes {xflops / 1e9:.1f} GFLOP, "
                f"{xflops / BF16_TENSOR_FLOPS * 1e3:.4f} ms at the bf16 tensor rate")
    elif cfg.n_experts:
        # the step reads every expert (the reference's arithmetic); the least
        # it needs is the experts its tokens were routed to, counted here
        with RouteLog() as log:
            model.decode_step(params, toks, dict(cache, layers=[
                {k: v.clone() for k, v in slot.items()} for slot in cache["layers"]]))
        per_expert = 3 * cfg.d_model * cfg.d_ff * 2
        need = w_step - per_expert * cfg.n_experts * len(log.calls) + per_expert * sum(
            len(set(eid.flatten().tolist())) for _, eid, _ in log.calls)
        note = (f"; routed experts only {need / HBM_BYTES_PER_S * 1e3:.4f} ms "
                f"({need / 1e9:.3f} GB: experts routed per layer "
                f"{[len(set(eid.flatten().tolist())) for _, eid, _ in log.calls]} "
                f"of {cfg.n_experts})")
    else:
        note = ""
    print(f"phase 4d: decode {arch} ({cfg.num_layers} layers) {LM_SLOTS} slots at "
          f"position ~{s_cache // 2}: {fmt_ms(t)} per step; weight-read bound "
          f"{w_step / HBM_BYTES_PER_S * 1e3:.4f} ms ({w_step / 1e9:.3f} GB, all "
          f"weights a step reads), with the live cache "
          f"{(w_step + live) / HBM_BYTES_PER_S * 1e3:.4f}"
          f" ms{note}")
    print(f"phase 4d: profile decode step {arch} {LM_SLOTS} slots: "
          + device_busy(torch, lambda: model.decode_step(params, toks, cache)))
    return {"launches": launches, "attn_layers": attn_layers(cfg)}


def moe_checks(torch, dev, rng, cfg, model, params, phase) -> None:
    """Phase 3j for an MoE arch: the routes past capacity in a
    LM_PROMPT_LEN[1]-token prefill, per layer; for EP_ARCH its first MoE
    layer on the expert-parallel path on a world of one NCCL rank (the
    FSDP all-gather and both all-to-alls run), held against the local path
    on the same ``(1, S, D)`` input."""
    from repro_torch.launch.mesh import destroy_process_group, make_mesh
    from repro_torch.models.moe import moe_apply, shard_moe_params

    S = LM_PROMPT_LEN[1]
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, S))).to(dev)
    with RouteLog() as log:
        model.prefill(params, toks, LM_S_CACHE)
    over = []
    for layer, (C, eid, slot) in enumerate(log.calls):
        dropped = eid.flatten()[slot == C]
        per = torch.bincount(dropped, minlength=cfg.n_experts)
        over.append(f"layer {layer}: {int((slot == C).sum())} of {slot.numel()} "
                    f"pairs past C={C} ({int((per > 0).sum())} experts over, most "
                    f"{int(per.max())} from expert {int(per.argmax())})")
    print(f"phase {phase}: {cfg.name} prefill S={S}, routes past capacity: "
          + "; ".join(over))
    if cfg.name != EP_ARCH:
        return
    ffn = params["layers"][0]["ffn"]
    x = torch.from_numpy(rng.standard_normal((1, S, cfg.d_model), dtype=np.float32)
                         ).to(dev, torch.bfloat16)
    t0 = time.perf_counter()
    want, want_aux = moe_apply(ffn, cfg, x)
    mesh = make_mesh((1, 1), ("data", "model"))
    try:
        shard = shard_moe_params(ffn, mesh)
        got, aux = moe_apply(shard, cfg, x, mesh=mesh)
        torch.cuda.synchronize()
        ep_ms = time_ms(torch, lambda: moe_apply(shard, cfg, x, mesh=mesh))
        del shard
    finally:
        destroy_process_group()
    local_ms = time_ms(torch, lambda: moe_apply(ffn, cfg, x))
    err = rel_err(got.float(), want.float())
    check(bool(torch.isfinite(got).all()), f"{cfg.name}: non-finite EP output")
    check(err <= EP_TOL, f"{cfg.name}: expert parallel vs local rel err {err:.3e}")
    check(abs(float(aux) - float(want_aux)) <= 1e-6,
          f"{cfg.name}: EP aux {float(aux)} vs local {float(want_aux)}")
    print(f"phase {phase}: {cfg.name} MoE layer 0 expert parallel on one NCCL "
          f"rank, (1, {S}, {cfg.d_model}) bf16: rel err {err:.3e} against the "
          f"local path (tol {EP_TOL:g}), aux {float(aux):.6f} / "
          f"{float(want_aux):.6f}; {fmt_ms(ep_ms)} per call, local "
          f"{fmt_ms(local_ms)}; in {time.perf_counter() - t0:.1f} s")


def attention_library(torch, cap: float, *, causal: bool = True,
                      prefix_len: int = 0):
    """``(name, fn(q, k, v))``: one PyTorch call that computes the flash
    kernel's GQA attention on ``(B, S, H, hd)`` tensors, causal or full.
    Without a softcap or a prefix it is ``scaled_dot_product_attention``;
    with either (which that call lacks) ``flex_attention`` with a ``cap *
    tanh(s / cap)`` score_mod and a causal block mask, or with the
    prefix-LM mask_mod ``(kv <= q) | (kv < prefix_len)``, compiled by
    ``torch.compile`` (its first call compiles; the mask is built once per
    shape)."""
    import torch.nn.functional as F

    def bhsd(*xs):
        return (x.transpose(1, 2) for x in xs)

    if cap <= 0.0 and not prefix_len:
        return "scaled_dot_product_attention", lambda q, k, v: (
            F.scaled_dot_product_attention(*bhsd(q, k, v), is_causal=causal,
                                           enable_gqa=True).transpose(1, 2))
    from torch.nn.attention.flex_attention import create_block_mask, flex_attention

    flex = torch.compile(flex_attention, dynamic=False)
    masks = {}

    def capped(s, b, h, q_idx, kv_idx):
        return cap * torch.tanh(s / cap)

    def mask_mod(b, h, q_idx, kv_idx):
        return (q_idx >= kv_idx) | (kv_idx < prefix_len)

    def run(q, k, v):
        shape = (q.shape[1], k.shape[1])
        if shape not in masks:
            masks[shape] = create_block_mask(mask_mod, None, None, *shape, device=q.device)
        return flex(*bhsd(q, k, v), score_mod=capped if cap > 0.0 else None,
                    block_mask=masks[shape], enable_gqa=True).transpose(1, 2)

    return "flex_attention", run


def flash_times(torch, dev, rng, what, shape, flash_cuda, gqa_attention_ref, *,
                Sk: int | None = None, causal: bool = True, prefix_len: int = 0) -> dict:
    """Phase 4d: the flash kernel in bf16 at ``shape`` ``(B, S, Hq, Hkv, hd,
    window, softcap)`` (``Sk`` keys, ``S`` by default; causal or full; a
    prefix of ``prefix_len``) beside its bound, its plain version and,
    without a window, :func:`attention_library`'s call, which is held
    against the kernel at FLASH_TOL.  The bound is the larger of the live
    (query, key) pairs' two products of ``hd`` MACs at the bf16 tensor rate
    and q, k, v read and o written once at the HBM rate."""
    B, S, Hq, Hkv, hd, window, cap = shape
    Sk = S if Sk is None else Sk
    q, k, v = (torch.from_numpy(rng.standard_normal((B, L, H, hd), dtype=np.float32))
               .to(dev, torch.bfloat16) for L, H in ((S, Hq), (Sk, Hkv), (Sk, Hkv)))
    kw = dict(causal=causal, window=window, softcap=cap, prefix_len=prefix_len)
    ms = time_ms(torch, lambda: flash_cuda.flash_attn(q, k, v, **kw))
    plain = time_ms(torch, lambda: gqa_attention_ref(q, k, v, **kw))
    lib_ms, lib_note = None, "n/a (a window)"
    if not window:
        name, fn = attention_library(torch, cap, causal=causal, prefix_len=prefix_len)
        try:
            lib = time_ms(torch, lambda: fn(q, k, v))
            err = rel_err(fn(q, k, v).float(), flash_cuda.flash_attn(q, k, v, **kw).float())
        except (RuntimeError, NotImplementedError, TypeError, ValueError) as exc:
            lib_note = f"{name} unavailable: {type(exc).__name__}: {exc}"
        else:
            check(err <= FLASH_TOL["bfloat16"],
                  f"flash {what}: {name} vs the kernel rel err {err:.3e}")
            lib_ms, lib_note = lib[0], f"{name} {fmt_ms(lib)} (vs kernel rel {err:.2e})"
    live = (S * Sk if not causal else
            sum(min(i + 1, window) if window else max(i + 1, prefix_len)
                for i in range(S)))
    flops = 4 * hd * Hq * B * live
    nbytes = 2 * B * hd * (2 * S * Hq + 2 * Sk * Hkv)     # q, o, k, v in bf16
    t_ops, t_bytes = flops / BF16_TENSOR_FLOPS, nbytes / HBM_BYTES_PER_S
    bound = (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes")
    mask = (f"causal window={window} prefix_len={prefix_len}" if causal else "full")
    print(f"phase 4d: kernel flash_attn bf16 {what} B={B} S={S} Sk={Sk} Hq={Hq} Hkv={Hkv} "
          f"hd={hd} {mask} softcap={cap:g}: {fmt_ms(ms)} per "
          f"launch, {flops / ms[0] / 1e9:.1f} TFLOP/s; plain {fmt_ms(plain)}; "
          f"bound {bound[0]:.6f} ms ({bound[1]}: {flops / 1e9:.2f} GFLOP, "
          f"{nbytes / 1e6:.1f} MB); library {lib_note}")
    return {"ms": ms, "plain": plain, "bound": bound, "library_ms": lib_ms}


def host_rss_gb() -> float:
    """This process's resident host memory (``VmRSS``), GB."""
    for line in Path("/proc/self/status").read_text().splitlines():
        if line.startswith("VmRSS:"):
            return int(line.split()[1]) / 1e6
    return float("nan")


def host_pcg(A, b: np.ndarray, M, tol: float, maxiter: int) -> int:
    """Iterations of textbook PCG on the host (scipy ``A``, numpy ``b``,
    ``M(r)`` the preconditioner apply) to ``‖r‖ ≤ tol ‖b‖``."""
    x = np.zeros_like(b)
    r = b.copy()
    bn = np.linalg.norm(b)
    z = M(r)
    p = z.copy()
    rz = r @ z
    for it in range(maxiter):
        Ap = A @ p
        alpha = rz / (p @ Ap)
        x += alpha * p
        r -= alpha * Ap
        if np.linalg.norm(r) <= tol * bn:
            return it + 1
        z = M(r)
        rz_new = r @ z
        p = z + (rz_new / rz) * p
        rz = rz_new
    return maxiter


def solver_surface(torch, dev, rng, L, levelset, scipy_csr, counts) -> dict:
    """Phase 3e: ``serial`` on ``lung2_like(SCATTER_SERIAL_SCALE)`` and
    ``levelset_unroll`` on lung2, ``auto`` with
    the rewrite open and given, ``sweep`` (certified on the IC(0) factor,
    falling back on lung2), ``guard`` under injected faults and in mixed
    precision, and PCG on ``poisson2d(PCG_GRID, PCG_GRID)`` with IC(0)
    preconditioners against a host PCG.  Each part builds its solvers in a
    function of its own and frees them before the next: the lung2
    transpose's ELL width of 1,975 makes some of their host layouts
    several GB.  Returns the ``auto`` solves' times, keyed ``(what,
    transpose, m)`` as ``(pick, ms)``, for phase 4's comparison."""
    import gc

    import scipy.sparse as sp
    from scipy.sparse.linalg import spsolve_triangular

    from repro_torch.core import (GuardBreakdownError, GuardConfig,
                                  RewriteConfig, SpTRSV, SweepConfig,
                                  contraction_factor, planned_sweeps)
    from repro_torch.core.pcg import (make_ic_preconditioner,
                                      make_ic_preconditioner_batched, pcg,
                                      pcg_batched)
    from repro_torch.core.levels import build_level_sets
    from repro_torch.core.sweep import default_residual_tol
    from repro_torch.sparse import ic0_factor, inject_values, poisson2d

    A = scipy_csr(L)
    rhs = {1: rng.standard_normal(L.n), WIDTHS[-1]: rng.standard_normal((L.n, WIDTHS[-1]))}
    dev_rhs = {m: torch.from_numpy(b).to(dev) for m, b in rhs.items()}
    base = {(s.transpose, m): s.solve(b) for s in levelset for m, b in dev_rhs.items()}
    tol = KERNEL_TOL["float64"]

    def serial_and_unroll():
        """serial (one solve each way, on a smaller lung2 against scipy:
        exp1_codegen in phase 3f times it on the full one) and
        levelset_unroll against levelset"""
        from repro_torch.sparse import lung2_like

        t0 = time.perf_counter()
        Ls = lung2_like(scale=SCATTER_SERIAL_SCALE, seed=0)
        As = scipy_csr(Ls)
        serial = SpTRSV.build_pair(Ls, strategy="serial", device=dev)
        unroll = SpTRSV.build_pair(L, strategy="levelset_unroll", device=dev)
        print(f"phase 3e: built serial (lung2_like({SCATTER_SERIAL_SCALE})) and "
              f"levelset_unroll (lung2) pairs in {time.perf_counter() - t0:.1f} s")
        b_s = rng.standard_normal(Ls.n)
        for s in serial:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            x = s.solve(torch.from_numpy(b_s).to(dev))
            torch.cuda.synchronize()
            took = time.perf_counter() - t0
            want = spsolve_triangular(As[s.transpose], b_s, lower=not s.transpose)
            agree = float(np.abs(x.cpu().numpy() - want).max() / np.abs(want).max())
            check(agree <= tol, f"serial T={s.transpose}: vs scipy {agree:.3e}")
            print(f"phase 3e: serial f64 m=1 transpose={int(s.transpose)} "
                  f"lung2_like({SCATTER_SERIAL_SCALE}): one solve {took:.3f} s "
                  f"({took / Ls.n * 1e6:.2f} us per row), vs scipy {agree:.2e}")
        for s in unroll:
            for m, b in dev_rhs.items():
                agree = rel_err(s.solve(b), base[s.transpose, m])
                check(agree <= tol, f"levelset_unroll m={m} T={s.transpose}: vs "
                      f"levelset {agree:.3e}")
                ms = time_ms(torch, lambda: s.solve(b), warm=False)
                print(f"phase 3e: levelset_unroll f64 m={m:2d} transpose="
                      f"{int(s.transpose)}: {fmt_ms(ms)}, vs levelset {agree:.2e}")

    def auto() -> dict:
        """auto on the committed "cuda" row, the rewrite left open and given:
        the plan, its backward error and its times"""
        times = {}
        for what, kw in (("rewrite open", {}),
                         ("rewrite=RewriteConfig()", dict(rewrite=RewriteConfig()))):
            t0 = time.perf_counter()
            pair = SpTRSV.build_pair(L, strategy="auto", device=dev, **kw)
            print(f"phase 3e: auto ({what}) pair built in "
                  f"{time.perf_counter() - t0:.1f} s")
            for s in pair:
                p = s.plan
                pick = (p.strategy + (f"+rewrite:{p.rewrite}" if p.rewrite else "")
                        + ("+coarsen" if p.coarsen else ""))
                for m, b in dev_rhs.items():
                    res = residual(A[s.transpose], s.solve(b).cpu().numpy(), rhs[m])
                    check(res <= RESIDUAL_TOL["float64"],
                          f"auto ({what}) m={m} T={s.transpose}: residual {res:.3e}")
                    times[what, s.transpose, m] = (
                        pick, time_ms(torch, lambda: s.solve(b), warm=False))
                print(f"phase 3e: auto ({what}) transpose={int(s.transpose)}: "
                      f"strategy {p.strategy}, coarsen {p.coarsen}, rewrite "
                      f"{p.rewrite}, sweep_k {p.sweep_k}, residual {res:.2e} (m="
                      f"{WIDTHS[-1]}); modelled costs "
                      + json.dumps({k: round(v) for k, v in sorted(p.costs.items())}))
        return times

    def sweep(Lic):
        """sweep: certified on the IC(0) factor, falling back on lung2"""
        q = contraction_factor(Lic)
        depth = build_level_sets(Lic).num_levels
        k = planned_sweeps(q, depth, default_residual_tol(np.float64), depth)
        check(k is not None, f"no certified sweep count for q={q}")
        Aic = scipy_csr(Lic)
        ic_rhs = {m: rng.standard_normal((Lic.n,) if m == 1 else (Lic.n, m))
                  for m in WIDTHS}
        for s in SpTRSV.build_pair(Lic, strategy="sweep", sweep=SweepConfig(k=k),
                                   device=dev):
            for m, b_np in ic_rhs.items():
                b = torch.from_numpy(b_np).to(dev)
                res = residual(Aic[s.transpose], s.solve(b).cpu().numpy(), b_np)
                check(res <= RESIDUAL_TOL["float64"],
                      f"sweep IC(0) m={m} T={s.transpose}: residual {res:.3e}")
                ms = time_ms(torch, lambda: s.solve(b))
                print(f"phase 3e: sweep IC(0) k={k} (q={q:.4f}, {depth} levels) "
                      f"f64 m={m:2d} transpose={int(s.transpose)}: residual "
                      f"{res:.2e}, {fmt_ms(ms)}; stats "
                      f"{json.dumps(s.sweep_stats.report())}")
        bz = dev_rhs[WIDTHS[-1]].clone()
        bz[:, 1] = 0  # a column that verifies after one sweep: kept, not spliced
        for s in SpTRSV.build_pair(L, strategy="sweep", sweep=SweepConfig(k=1),
                                   device=dev):
            want = levelset[int(s.transpose)].solve(bz)
            agree = rel_err(s.solve(bz), want)
            st = s.sweep_stats
            check(agree <= tol and st.fallback_columns == WIDTHS[-1] - 1,
                  f"sweep k=1 lung2 T={s.transpose}: vs levelset {agree:.3e}, "
                  f"stats {st.report()}")
            print(f"phase 3e: sweep k=1 lung2 f64 m={WIDTHS[-1]} transpose="
                  f"{int(s.transpose)}: fallback spliced, vs levelset "
                  f"{agree:.2e}; stats {json.dumps(st.report())}")

    def guard_faults():
        """guard: injected faults under each policy"""
        faults = {kind: inject_values(L, kind, seed=0)
                  for kind in ("zero_pivot", "nan_slab")}
        b1 = dev_rhs[1]
        for policy in ("refine", "fallback", "raise"):
            s = SpTRSV.build(L, strategy="pallas_fused", device=dev,
                             guard=GuardConfig(on_breakdown=policy))
            res = residual(A[False], s.solve(b1).cpu().numpy(), rhs[1])
            check(s.guard.stats.verified == 1 and res <= RESIDUAL_TOL["float64"],
                  f"guard {policy}: clean solve {res:.3e}")
            for kind, bad in faults.items():
                before = dict(s.guard.stats.report())
                try:
                    s.refresh(bad, validate=False)
                    x = s.solve(b1)
                    outcome = "answer"
                except GuardBreakdownError as err:
                    outcome = f"raised: {err}"
                st = s.guard.stats
                if policy == "raise":
                    check(outcome != "answer", f"guard raise {kind}: did not raise")
                else:
                    check(outcome == "answer", f"guard {policy} {kind}: {outcome}")
                if policy == "refine":
                    check(st.breakdown_columns > before["breakdown_columns"],
                          f"guard refine {kind}: no breakdown recorded")
                if policy == "fallback":
                    check(st.fallback_solves > before["fallback_solves"]
                          and bool(torch.isfinite(x).all()),
                          f"guard fallback {kind}: no finite fallback answer")
                print(f"phase 3e: guard {policy} {kind}: {outcome}; stats "
                      f"{json.dumps(st.report())}")
                s.refresh(L.data)

    def guard_mixed(strategy, transpose):
        """a mixed-precision guarded solve refined to the f64 tolerance"""
        s = SpTRSV.build(L, strategy=strategy, transpose=transpose, device=dev,
                         guard=GuardConfig(precision="mixed", refine_steps=4))
        res = residual(A[transpose], s.solve(dev_rhs[1]).cpu().numpy(), rhs[1])
        st = s.guard.stats
        check(res <= RESIDUAL_TOL["float64"] and st.verified == 1,
              f"guard mixed {strategy} T={transpose}: residual {res:.3e}")
        print(f"phase 3e: guard mixed {strategy} f64 transpose={int(transpose)}: "
              f"values {[str(v.dtype) for v in s._values]}, "
              f"{st.last_refine_steps} refinement steps, residual {res:.2e}")

    def pcg_runs(P, Lic):
        """PCG against a host PCG with scipy's triangular solves (exact) and
        with the same Jacobi sweeps (inexact)"""
        Ps = scipy_csr(P)[False]
        Lc, LcT = scipy_csr(Lic)[False], scipy_csr(Lic)[True]
        diag = Lic.diagonal()
        N = (Lc - sp.diags(diag)).tocsr()
        NT = N.T.tocsr()

        def jacobi(Nm, r):
            x = r / diag
            for _ in range(PCG_SWEEPS - 1):
                x = (r - Nm @ x) / diag
            return x

        bp = rng.standard_normal(P.n)
        Bp = rng.standard_normal((P.n, PCG_M))
        Bp[:, 0] = bp
        t0 = time.perf_counter()
        host = {"exact": host_pcg(Ps, bp, lambda r: spsolve_triangular(
                    LcT, spsolve_triangular(Lc, r, lower=True), lower=False),
                    PCG_TOL, PCG_MAXITER),
                "sweeps": host_pcg(Ps, bp, lambda r: jacobi(NT, jacobi(N, r)),
                                   PCG_TOL, PCG_MAXITER)}
        print(f"phase 3e: host PCG (scipy) iterations {json.dumps(host)} in "
              f"{time.perf_counter() - t0:.1f} s")
        b = torch.from_numpy(bp).to(dev)
        B = torch.from_numpy(Bp).to(dev)
        for name, kw in (("auto", dict(strategy="auto")),
                         ("pallas_fused", dict(strategy="pallas_fused")),
                         ("pallas_level", dict(strategy="pallas_level")),
                         (f"sweeps={PCG_SWEEPS}", dict(sweeps=PCG_SWEEPS))):
            M = make_ic_preconditioner(Lic, rewrite=None, device=dev, **kw)
            Mb = make_ic_preconditioner_batched(Lic, rewrite=None, device=dev, **kw)
            want = host["sweeps" if "sweeps" in kw else "exact"]
            strategy = M.solvers[0].strategy
            for m, run, rhs_t, rhs_np, Mx in (
                    (1, lambda: pcg(P, b, M, tol=PCG_TOL, maxiter=PCG_MAXITER),
                     b, bp, M),
                    (PCG_M, lambda: pcg_batched(P, B, Mb, tol=PCG_TOL,
                                                maxiter=PCG_MAXITER), B, Bp, Mb)):
                c0 = counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = run()
                torch.cuda.synchronize()
                took = time.perf_counter() - t0
                c1 = counts()
                iters = np.atleast_1d(out.iters)
                x = out.x.cpu().numpy().reshape(rhs_np.shape)
                r = rhs_np - Ps @ x
                rel = np.linalg.norm(r, axis=0) / np.linalg.norm(rhs_np, axis=0)
                check(bool(np.all(out.converged)) and float(rel.max()) <= PCG_TOL,
                      f"pcg {name} m={m}: converged {out.converged}, true "
                      f"residual {rel.max():.3e}")
                check(abs(int(iters[0]) - want) <= PCG_ITER_SLACK,
                      f"pcg {name} m={m}: {iters[0]} iterations, host {want}")
                apply_ms = time_ms(torch, lambda: Mx(rhs_t))
                it = int(iters.max())
                per_it = {k: round((c1[k] - c0[k]) / it, 3) for k in c1
                          if c1[k] > c0[k]}
                print(f"phase 3e: pcg {name} ({strategy}) f64 m={m:2d}: {it} "
                      f"iterations (host {want}), true residual {rel.max():.2e}, "
                      f"{took:.3f} s, {took / it * 1e3:.4f} ms per iteration, "
                      f"preconditioner apply {fmt_ms(apply_ms)}; launches per "
                      f"iteration {json.dumps(per_it)}")

    serial_and_unroll()
    gc.collect()
    print(f"phase 3e: host memory {host_rss_gb():.1f} GB resident")
    auto_times = auto()
    gc.collect()
    print(f"phase 3e: host memory {host_rss_gb():.1f} GB resident")
    t0 = time.perf_counter()
    P = poisson2d(PCG_GRID, PCG_GRID)
    t_p = time.perf_counter() - t0
    t0 = time.perf_counter()
    Lic = ic0_factor(P)
    print(f"phase 3e: poisson2d({PCG_GRID}, {PCG_GRID}) n={P.n} nnz={P.nnz} in "
          f"{t_p:.1f} s, ic0_factor nnz={Lic.nnz} in {time.perf_counter() - t0:.1f} s")
    sweep(Lic)
    gc.collect()
    guard_faults()
    gc.collect()
    # a transpose pallas_fused solver holds its 577 M-slot layout on the
    # host: the mixed transpose runs on pallas_level
    for strategy, transpose in (("pallas_fused", False), ("pallas_level", False),
                                ("pallas_level", True)):
        guard_mixed(strategy, transpose)
        gc.collect()
    print(f"phase 3e: host memory {host_rss_gb():.1f} GB resident")
    pcg_runs(P, Lic)
    gc.collect()
    return auto_times


def serving_tier(torch, dev, L, scipy_csr, reset_counts, counts) -> dict:
    """Phase 3f: (a) ``SolveService(strategy="auto")`` on lung2 in f64 —
    cold answers through the serial pair while the planned build is held,
    promotion, width-1 and width-SERVE_BATCH steps each way, a refresh, and
    a NaN request in a guarded batch of 8; (b) the port's ``serve_bench``
    at its full size; (c) ``fig6_levels``, ``exp1_codegen`` and
    ``exp2_rewrite`` on the full lung2.  Counters are read only while no
    build runs.  Returns the launches of (a)-(b) and of (c)."""
    import gc
    import threading

    from scipy.sparse.linalg import spsolve_triangular

    from repro_torch.bench import exp1_codegen, exp2_rewrite, fig6_levels
    from repro_torch.bench import serve_bench
    from repro_torch.core import CSRMatrix, GuardBreakdownError, GuardConfig
    from repro_torch.serve import SolveService
    from repro_torch.sparse import refresh_values

    out_dir = ROOT / "bench_out"
    out_dir.mkdir(exist_ok=True)
    rng = np.random.default_rng(21)
    total = {}

    def counted(fn):
        """``fn()`` with the counters zeroed before and read after; the
        launches add to the phase's."""
        reset_counts()
        res = fn()
        torch.cuda.synchronize()
        c = counts()
        for k, v in c.items():
            total[k] = total.get(k, 0) + v
        return res, c

    def rel(x, want):
        return float(np.abs(x - want).max() / np.abs(want).max())

    def oracle(A, b, transpose):
        return spsolve_triangular(A[transpose], b, lower=not transpose)

    # -- (a) the serving tier on lung2 ---------------------------------------
    A = scipy_csr(L)
    gate = threading.Event()
    svc = SolveService(strategy="auto", build_gate=gate, device=dev)
    t0 = time.perf_counter()
    key = svc.register("lung2", L)
    t_admit = time.perf_counter() - t0
    entry = svc.registry.lookup(key)
    check(entry.state == "cold" and entry.engine.solver.strategy == "serial",
          f"serving: admission gave {entry.state} {entry.engine.solver.strategy}")
    print(f"phase 3f: registered lung2 f64: cold serial pair built in "
          f"{entry.cold_build_seconds:.3f} s (admission {t_admit:.3f} s), "
          f"{entry.packed_bytes} packed bytes; the planned build is held")

    def serve(B, transpose, want_A):
        """Submit the columns of ``B``, drain one step; check every answer
        against scipy; returns (answers (n, m), launches, seconds)."""
        def go():
            reqs = [svc.submit("lung2", B[:, j], transpose=transpose)
                    for j in range(B.shape[1])]
            t = time.perf_counter()
            done = svc.step()
            return reqs, done, time.perf_counter() - t
        (reqs, done, took), c = counted(go)
        check(done == B.shape[1] and all(r.done and r.error is None for r in reqs),
              f"serving: {done} of {B.shape[1]} answered, errors "
              f"{[repr(r.error) for r in reqs if r.error is not None]}")
        X = np.stack([r.x for r in reqs], axis=1)
        err = rel(X, oracle(want_A, B, transpose))
        check(err <= SERVE_TOL, f"serving m={B.shape[1]} T={transpose}: vs "
              f"scipy {err:.3e}")
        return X, c, took, err

    b1 = {tr: rng.standard_normal((L.n, 1)) for tr in (False, True)}
    cold = {}
    for tr in (False, True):
        cold[tr], c, took, err = serve(b1[tr], tr, A)
        check(entry.state == "cold", "serving: promoted while the gate was held")
        print(f"phase 3f: cold answer transpose={int(tr)} through the serial "
              f"pair: {took:.3f} s, vs scipy {err:.2e}; launches "
              f"{json.dumps({k: v for k, v in c.items() if v})}")
    gate.set()
    t0 = time.perf_counter()
    ready = entry.wait_ready(timeout=SERVE_WAIT_S)
    idle = svc.registry.wait_idle(timeout=SERVE_WAIT_S)
    check(ready and idle, f"serving: the planned build did not end within "
          f"{SERVE_WAIT_S} s")
    check(entry.state == "ready" and entry.build_error is None,
          f"serving: state {entry.state}, build error {entry.build_error!r}")
    eng = entry.engine
    picks = {}
    for s in (eng.solver, eng.solver_t):
        p = s.plan
        picks[int(s.transpose)] = (p.strategy + (f"+rewrite:{p.rewrite}" if p.rewrite
                                                 else "") + ("+coarsen" if p.coarsen else ""))
    print(f"phase 3f: planned auto pair promoted after "
          f"{entry.planned_build_seconds:.3f} s of build (waited "
          f"{time.perf_counter() - t0:.1f} s): forward {picks[0]}, transpose "
          f"{picks[1]}; packed bytes forward "
          f"{eng.solver.stats()['packed_bytes']}, transpose "
          f"{eng.solver_t.stats()['packed_bytes']}, entry {entry.packed_bytes} "
          f"(registry resident {svc.registry.resident_bytes()}); host memory "
          f"{host_rss_gb():.1f} GB resident")

    def check_kinds(solver, m, c):
        """a width-1 step is one single-RHS walk, a wider one one batch"""
        want = (1, 0) if m == 1 else (0, 1)
        check((c["sptrsv_fused"], c["sptrsv_fused_batched"]) == want,
              f"serving: a width-{m} step of {solver.strategy} launched "
              f"{json.dumps({k: v for k, v in c.items() if v})}")

    for tr in (False, True):
        solver = eng.solver_t if tr else eng.solver
        x, c, took, err = serve(b1[tr], tr, A)
        agree = rel(x, cold[tr])
        check(agree <= SERVE_COLD_TOL, f"serving T={tr}: promoted vs cold {agree:.3e}")
        check_kinds(solver, 1, c)
        print(f"phase 3f: promoted answer transpose={int(tr)}: {took * 1e3:.4f} "
              f"ms, vs cold {agree:.2e}, vs scipy {err:.2e}; launches "
              f"{json.dumps({k: v for k, v in c.items() if v})}")
        for m, reps in ((SERVE_BATCH, 3 if not tr else 2), (1, 5)):
            ts = []
            for _ in range(reps):
                _, c, took, err = serve(rng.standard_normal((L.n, m)), tr, A)
                check_kinds(solver, m, c)
                ts.append(took * 1e3)
            print(f"phase 3f: step of width {m:2d} transpose={int(tr)} "
                  f"({solver.strategy}): {sorted(ts)[len(ts) // 2]:.4f} ms "
                  f"[{min(ts):.4f}-{max(ts):.4f}] over {reps} steps, vs scipy "
                  f"<= {err:.2e}; launches per step "
                  f"{json.dumps({k: v for k, v in c.items() if v})}")

    def step_only(B, transpose):
        for j in range(B.shape[1]):
            svc.submit("lung2", B[:, j], transpose=transpose)
        svc.step()

    for m in (1, SERVE_BATCH):
        B = rng.standard_normal((L.n, m))
        print(f"phase 3f: profile a forward step of width {m}: "
              f"{device_busy(torch, lambda: step_only(B, False))}")
    new = refresh_values(L, seed=11)
    t0 = time.perf_counter()
    svc.refresh("lung2", new)
    torch.cuda.synchronize()
    t_refresh = time.perf_counter() - t0
    A2 = scipy_csr(L, new)
    print(f"phase 3f: refresh of the promoted pair {t_refresh:.3f} s, beside "
          f"the cold admission {t_admit:.3f} s and the planned build "
          f"{entry.planned_build_seconds:.3f} s")
    for tr in (False, True):
        for m in (1, SERVE_BATCH):
            _, c, took, err = serve(rng.standard_normal((L.n, m)), tr, A2)
            check_kinds(eng.solver_t if tr else eng.solver, m, c)
            print(f"phase 3f: refreshed m={m:2d} transpose={int(tr)}: "
                  f"{took * 1e3:.4f} ms, vs scipy {err:.2e}")
    st = svc.stats()
    print(f"phase 3f: service stats: completed {st['completed']}, failed "
          f"{st['failed']}, batches {st['batches_completed']}, solve latency "
          f"{json.dumps(st['solve_latency'])}; registry "
          f"{json.dumps({k: st['registry'][k] for k in ('hits', 'misses', 'promotions', 'evictions', 'build_failures')})}; "
          f"host memory {host_rss_gb():.1f} GB resident")
    check(st["failed"] == 0 and st["queue_depth"] == 0, f"serving: {st['per_tenant']}")
    del svc, entry, eng
    gc.collect()
    torch.cuda.empty_cache()

    # a NaN request in a guarded batch of 8 fails alone
    L2 = CSRMatrix(L.indptr, L.indices, new, L.shape)
    gsvc = SolveService(strategy="auto", transpose_too=False, background=False,
                        device=dev, guard=GuardConfig(on_breakdown="raise"))
    gsvc.register("guarded", L2)
    B = rng.standard_normal((L.n, 8))
    B[L.n // 2, 3] = np.nan
    reqs = [gsvc.submit("guarded", B[:, j]) for j in range(8)]
    (done, c) = counted(gsvc.step)
    want = oracle(A2, B[:, [0, 1, 2, 4, 5, 6, 7]], False)
    good = [r for j, r in enumerate(reqs) if j != 3]
    err = rel(np.stack([r.x for r in good], axis=1), want) if all(
        r.x is not None for r in good) else float("inf")
    gst = gsvc.stats()
    check(done == 8 and isinstance(reqs[3].error, GuardBreakdownError)
          and reqs[3].x is None and err <= SERVE_TOL
          and (gst["completed"], gst["failed"]) == (7, 1),
          f"serving guard: done {done}, NaN request {reqs[3].error!r}, good "
          f"vs scipy {err:.3e}, stats {gst['per_tenant']}")
    print(f"phase 3f: guarded batch of 8 ({gsvc.registry.lookup(gsvc.registry.keys()[0]).engine.solver.strategy}) "
          f"with one NaN request: it failed alone ({type(reqs[3].error).__name__}), "
          f"7 answered, vs scipy {err:.2e}; launches "
          f"{json.dumps({k: v for k, v in c.items() if v})}")
    del gsvc, reqs, good
    gc.collect()
    torch.cuda.empty_cache()

    # -- (b) serve_bench at its full size -----------------------------------
    t0 = time.perf_counter()
    res, c = counted(lambda: serve_bench.run(
        device=dev, json_path=str(out_dir / "BENCH_serve_cuda.json")))
    mixed = res["mixed"]
    reqs = mixed["requests"]
    check(mixed["completed"] == mixed["solves"] == len(reqs) > 0
          and mixed["queue_depth"] == 0 and mixed["idle"]
          and all(r.done for r, _ in reqs),
          f"serve_bench: {mixed['completed']} of {mixed['solves']} completed")
    check(mixed["failed"] == 0, f"serve_bench: {mixed['failed']} failed")
    check(mixed["evictions"] >= 1, "serve_bench: no eviction")
    check(mixed["peak_resident_bytes"] <= mixed["budget_bytes"],
          f"serve_bench: peak {mixed['peak_resident_bytes']} > budget "
          f"{mixed['budget_bytes']}")
    cold_ok = res["cold"]
    check(cold_ok["served_while_cold"] and cold_ok["promoted"]
          and cold_ok["answers_match"], f"serve_bench cold path: {cold_ok}")
    worst = 0.0
    for r, F in reqs[::max(1, len(reqs) // SERVE_SAMPLE)][:SERVE_SAMPLE]:
        worst = max(worst, rel(r.x, oracle(scipy_csr(F), r.b, r.transpose)))
    check(worst <= SERVE_MIXED_TOL, f"serve_bench: answers vs scipy {worst:.3e}")
    print(f"phase 3f: serve_bench (lung2_like(0.3) n={res['rows']}, 4 patterns, "
          f"8 tenants, 600 events, n=512) in {time.perf_counter() - t0:.1f} s: "
          f"warm {json.dumps(res['warm'])}; cold {json.dumps(cold_ok)}; mixed "
          f"{json.dumps({k: v for k, v in mixed.items() if k != 'requests'})}; "
          f"{SERVE_SAMPLE} answers vs scipy <= {worst:.2e}; launches "
          f"{json.dumps({k: v for k, v in c.items() if v})}")
    del res, mixed, reqs
    gc.collect()
    serving_launches = dict(total)

    # -- (c) the paper's experiments on the full lung2 -----------------------
    total.clear()
    t0 = time.perf_counter()
    fig6 = fig6_levels.run(full_scale=True, json_path=str(out_dir / "BENCH_fig6_cuda.json"))
    print(f"phase 3f: fig6_levels in {time.perf_counter() - t0:.1f} s: "
          f"{fig6['lung2_like'].summary()}")
    t0 = time.perf_counter()
    exp1, c = counted(lambda: exp1_codegen.run(
        full_scale=True, device=dev, json_path=str(out_dir / "BENCH_exp1_cuda.json")))
    print(f"phase 3f: exp1_codegen in {time.perf_counter() - t0:.1f} s: ms "
          f"{json.dumps({k: round(v * 1e3, 4) for k, v in exp1.items()})}; "
          f"launches {json.dumps({k: v for k, v in c.items() if v})}")
    t0 = time.perf_counter()
    exp2, c = counted(lambda: exp2_rewrite.run(
        full_scale=True, device=dev, json_path=str(out_dir / "BENCH_exp2_cuda.json")))
    print(f"phase 3f: exp2_rewrite in {time.perf_counter() - t0:.1f} s: ms "
          f"{json.dumps({k: round(v * 1e3, 4) for k, v in exp2.items() if k != 'stats'})}; "
          f"{exp2['stats'].summary()}; launches "
          f"{json.dumps({k: v for k, v in c.items() if v})}")
    gc.collect()
    return {"serving": serving_launches, "experiments": dict(total)}


def scatter_phase(torch, dev, rng, L, band, solvers, rw_solvers, scipy_csr,
                  reset_counts, counts, calibration) -> dict:
    """Phase 3g: (a) ``layout="scatter"`` for every strategy on lung2 (f64),
    plain, coarsened and rewritten, forward and transpose, m in WIDTHS:
    residual, agreement with the permuted ``levelset`` (and with the
    permuted twin where phase 3 holds one), one scatter level launch per
    wavefront; ``serial`` on ``lung2_like(SCATTER_SERIAL_SCALE)`` and
    ``blocked`` on the band against scipy (one panel SpMV and one block
    apply launch per super-level); a scatter ``refresh`` (a cold rebuild)
    against a fresh build; scatter beside permuted ms per solve.  (b) the
    eight CI benches at ``--smoke`` (``--dry-run``) with their gates, and
    the calibration row of phase 3e as ``BENCH_calibrate_cuda.json``.
    Returns the launches of (a) and (b), the times, the gates and the
    scatter solvers phase 4 counts launches of."""
    import gc

    from scipy.sparse.linalg import spsolve_triangular

    from repro_torch.bench import (batch_solve, blocked, coarsen, guard,
                                   preconditioner, refresh, rewrite_planner,
                                   sweep)
    from repro_torch.bench.calibrate import write_bench
    from repro_torch.bench.common import print_gates
    from repro_torch.core import CSRMatrix, RewriteConfig, SpTRSV
    from repro_torch.kernels.sptrsv_level import cuda as level_cuda
    from repro_torch.sparse import lung2_like, refresh_values

    out_dir = ROOT / "bench_out"
    out_dir.mkdir(exist_ok=True)
    dt, tdt = "float64", torch.float64
    A = scipy_csr(L)
    rhs = {m: rng.standard_normal((L.n,) if m == 1 else (L.n, m)) for m in WIDTHS}
    dev_rhs = {m: torch.from_numpy(b).to(dev) for m, b in rhs.items()}
    base = {(s.transpose, m): s.solve(b) for s in solvers["levelset", dt]
            for m, b in dev_rhs.items()}
    reset_counts()
    t0 = time.perf_counter()
    times, keep = {}, {}
    for tag, kw, twin in SCATTER_CASES:
        kw = dict(kw)
        rewritten = kw.pop("rewrite", False)
        if rewritten:
            kw["rewrite"] = RewriteConfig()
        t1 = time.perf_counter()
        pair = SpTRSV.build_pair(L, device=dev, layout="scatter", **kw)
        built = time.perf_counter() - t1
        twins = None
        if twin is not None:
            twins = (rw_solvers if rewritten else solvers)[twin, dt]
        for s in pair:
            check(s.layout == "scatter" and s._values is None,
                  f"scatter {tag}: not a scatter solver")
            loose = rewritten or "sweep" in (kw["strategy"], s.strategy)
            for m, b in dev_rhs.items():
                before = dict(level_cuda.launches)
                x = s.solve(b)
                torch.cuda.synchronize()
                xn = x.cpu().numpy()
                check(x.shape == b.shape and np.isfinite(xn).all(),
                      f"scatter {tag} m={m} T={s.transpose}: bad output")
                res = residual(A[s.transpose], xn, rhs[m])
                agree = rel_err(x, base[s.transpose, m])
                tol = REWRITE_AGREE_TOL[dt] if loose else KERNEL_TOL[dt]
                check(res <= RESIDUAL_TOL[dt],
                      f"scatter {tag} m={m} T={s.transpose}: residual {res:.3e}")
                check(agree <= tol, f"scatter {tag} m={m} T={s.transpose}: "
                      f"vs levelset {agree:.3e}")
                what = f"residual {res:.2e}, vs levelset {agree:.2e}"
                if twins is not None:
                    t_agree = rel_err(x, twins[int(s.transpose)].solve(b))
                    check(t_agree <= KERNEL_TOL[dt], f"scatter {tag} m={m} "
                          f"T={s.transpose}: vs permuted {t_agree:.3e}")
                    what += f", vs permuted {t_agree:.2e}"
                if s.strategy == "pallas_level":
                    name = "sptrsv_level_scatter" + ("" if m == 1 else "_batched")
                    got = level_cuda.launches[name] - before[name]
                    check(got == s.schedule.total_depth == s._solve_fn.table.num_steps,
                          f"scatter {tag} T={s.transpose} m={m}: {got} launches "
                          f"for {s.schedule.total_depth} wavefronts")
                    what += f", {got} {name} launches"
                print(f"phase 3g: scatter {tag:24s} -> {s.strategy:15s} f64 m={m:2d} "
                      f"transpose={int(s.transpose)}: {what}")
                # not the transpose fused batch (B4): ~0.8 s a solve either way
                if tag in SCATTER_TIMED and not (
                        tag == "pallas_fused" and s.transpose and m > 1):
                    ms = time_ms(torch, lambda: s.solve(b), warm=False,
                                 budget_ms=SCATTER_BUDGET_MS)
                    tw = twins[int(s.transpose)]
                    pms = time_ms(torch, lambda: tw.solve(b),
                                  budget_ms=SCATTER_BUDGET_MS)
                    times[tag, m, s.transpose] = (ms[0], pms[0])
                    print(f"phase 3g: time {tag} f64 m={m:2d} transpose="
                          f"{int(s.transpose)}: scatter {fmt_ms(ms)}, permuted "
                          f"{fmt_ms(pms)}")
        print(f"phase 3g: scatter {tag} pair built in {built:.2f} s")
        if tag == "pallas_level":
            keep["scatter:pallas_level"] = pair[0]
        if tag == "pallas_level+coarsen":
            # refresh: a cold rebuild, equal to a fresh build on the new values
            s = pair[0]
            new = refresh_values(L, seed=1)
            s.refresh(new)
            fresh = SpTRSV.build(CSRMatrix(L.indptr, L.indices, new, L.shape),
                                 device=dev, layout="scatter", **kw)
            b = dev_rhs[WIDTHS[-1]]
            check(torch.equal(s.solve(b), fresh.solve(b))
                  and not s.stats()["refreshable_in_place"],
                  "scatter refresh: answers differ from a fresh build")
            print("phase 3g: scatter refresh (a cold rebuild) equals a fresh "
                  "build on the new values")
            del fresh
        del pair, twins
        gc.collect()
        torch.cuda.empty_cache()

    # serial on a smaller lung2, blocked on the band: against scipy
    Ls = lung2_like(scale=SCATTER_SERIAL_SCALE, seed=0)
    for what, M, kw in (("serial lung2_like(%g)" % SCATTER_SERIAL_SCALE, Ls,
                         dict(strategy="serial")),
                        ("blocked band", band, dict(strategy="blocked"))):
        AM = scipy_csr(M)
        t1 = time.perf_counter()
        pair = SpTRSV.build_pair(M, device=dev, layout="scatter", **kw)
        built = time.perf_counter() - t1
        for s in pair:
            for m in WIDTHS:
                if kw["strategy"] == "serial" and m > 1 and s.transpose:
                    continue  # a host loop per row: ~3 s a solve
                b_np = rng.standard_normal((M.n,) if m == 1 else (M.n, m))
                before = counts()
                t1 = time.perf_counter()
                x = s.solve(torch.from_numpy(b_np).to(dev))
                torch.cuda.synchronize()
                took = time.perf_counter() - t1
                c = {k: v - before[k] for k, v in counts().items() if v - before[k]}
                xn = x.cpu().numpy()
                want = spsolve_triangular(AM[s.transpose], b_np, lower=not s.transpose)
                agree = float(np.abs(xn - want).max() / np.abs(want).max())
                res = residual(AM[s.transpose], xn, b_np)
                check(np.isfinite(xn).all() and agree <= BLOCKED_AGREE_TOL[dt]
                      and res <= RESIDUAL_TOL[dt],
                      f"scatter {what} m={m} T={s.transpose}: vs scipy {agree:.3e}, "
                      f"residual {res:.3e}")
                if kw["strategy"] == "blocked":
                    segs = s.stats()["segments"]
                    sfx = "" if m == 1 else "_batched"
                    check(c == {f"trsm_block_apply{sfx}": segs, f"spmv_ell{sfx}": segs},
                          f"scatter blocked band m={m}: launches {c}, {segs} segments")
                print(f"phase 3g: scatter {what} f64 m={m:2d} transpose="
                      f"{int(s.transpose)}: {took:.3f} s, vs scipy {agree:.2e}, "
                      f"residual {res:.2e}, launches {json.dumps(c)}")
        print(f"phase 3g: scatter {what} pair built in {built:.2f} s")
        if kw["strategy"] == "blocked":
            keep["scatter:block-apply (band)"] = pair[0]
        del pair
        gc.collect()
    torch.cuda.synchronize()
    scatter_launches = counts()
    print(f"phase 3g: scatter path in {time.perf_counter() - t0:.1f} s; "
          f"launches {json.dumps(scatter_launches)}")

    # (b) the eight CI benches at their smoke sizes
    reset_counts()
    t0 = time.perf_counter()
    gates = {}
    for name, mod, kw in (("refresh", refresh, dict(smoke=True)),
                          ("batch_solve", batch_solve, dict(dry_run=True)),
                          ("coarsen", coarsen, dict(smoke=True)),
                          ("blocked", blocked, dict(smoke=True)),
                          ("sweep", sweep, dict(smoke=True)),
                          ("guard", guard, dict(smoke=True)),
                          ("preconditioner", preconditioner, dict(dry_run=True)),
                          ("rewrite_planner", rewrite_planner, dict(smoke=True))):
        t1 = time.perf_counter()
        results = mod.measure(device=dev, **kw)
        gs = mod.gates(results)
        print_gates(name, gs)
        for g in gs:
            check(g.met or g.kind not in ("answer", "structural"),
                  f"bench {name}: {g.name} ({g.kind}) {g.value!r} needs "
                  f"{g.threshold}: {g.message}")
        mod.write_json(str(out_dir / f"BENCH_{name}_cuda.json"), results, dev)
        gates[name] = [dict(name=g.name, kind=g.kind, value=g.value,
                            threshold=g.threshold, met=g.met) for g in gs]
        print(f"phase 3g: bench {name} in {time.perf_counter() - t1:.1f} s")
        del results
        gc.collect()
    row, raw = calibration
    write_bench(str(out_dir / "BENCH_calibrate_cuda.json"), row, raw, dev)
    torch.cuda.synchronize()
    bench_launches = counts()
    print(f"phase 3g: benches in {time.perf_counter() - t0:.1f} s; launches "
          f"{json.dumps(bench_launches)}")
    print(f"phase 3g: gates {json.dumps(gates, default=str)}")
    return {"scatter": scatter_launches, "benches": bench_launches,
            "times": times, "gates": gates, "keep": keep}


def distributed_phase(torch, dev, rng, L, scipy_csr, reset_counts,
                      counts) -> dict:
    """Phase 3h: (a) ``strategy="distributed"`` on a world of one NCCL rank
    (``make_mesh((1,), ("data",))``: a ``FileStore`` in a temporary
    directory, bound to ``cuda:0``) over lung2 (f64): both layouts x
    ``all_gather``/``psum`` x plain/rewrite/coarsen, forward and
    transpose, m in WIDTHS; each answer's backward error against the
    factor (scipy CSR), agreement with the ``levelset`` solve of the same
    transform and layout, ``psum`` equal to ``all_gather``, the collectives
    per solve equal to ``num_collectives`` (493 plain forward, 58
    rewritten); ms per solve beside the ``levelset`` solve's and the
    difference per collective; one permuted refresh; then
    ``bench/dist_solve.py`` on the same mesh, writing
    ``bench_out/BENCH_dist_solve_cuda.json``.  (b) the linear recurrence:
    ``scan`` and ``doubling`` at ``RECURRENCE_SHAPE`` along ``axis=1`` in
    f32 and f64 against an f64 host loop, ms each; ``sptrsv`` at
    ``RECURRENCE_SPTRSV``; the chain's levels before and after the
    rewrite.  Returns the launches of (a), counted over the distributed
    solves alone (not the ``levelset`` baselines, the timing loops or the
    bench), and of (b), and the times."""
    import gc

    import torch.distributed as pg

    from repro_torch.bench import dist_solve
    from repro_torch.core import CSRMatrix, RewriteConfig, SpTRSV
    from repro_torch.core import dist as tdist
    from repro_torch.core.levels import build_level_sets
    from repro_torch.core.recurrence import (linear_recurrence,
                                             recurrence_as_sptrsv)
    from repro_torch.core.rewrite import rewrite_matrix
    from repro_torch.launch.mesh import destroy_process_group, make_mesh
    from repro_torch.sparse import refresh_values

    t0 = time.perf_counter()
    dt = "float64"
    A = scipy_csr(L)
    rhs = {m: rng.standard_normal((L.n,) if m == 1 else (L.n, m)) for m in WIDTHS}
    dev_rhs = {m: torch.from_numpy(b).to(dev) for m, b in rhs.items()}
    times, dist_launches = {}, {}

    def solve_counted(s, b):
        # one distributed solve, its launches added to dist_launches
        reset_counts()
        x = s.solve(b)
        torch.cuda.synchronize()
        for k, v in counts().items():
            dist_launches[k] = dist_launches.get(k, 0) + v
        return x

    mesh = make_mesh((1,), ("data",), device=dev)
    try:
        print(f"phase 3h: {mesh}, backend {pg.get_backend(mesh.get_group('data'))}")
        for tag, kw in DIST_CASES:
            kw = dict(kw)
            if kw.pop("rewrite", False):
                kw["rewrite"] = RewriteConfig()
            for layout in ("permuted", "scatter"):
                t1 = time.perf_counter()
                base = SpTRSV.build_pair(L, device=dev, layout=layout,
                                         strategy="levelset", **kw)
                pairs = {ds: SpTRSV.build_pair(
                    L, device=dev, layout=layout, strategy="distributed",
                    mesh=mesh, dist_strategy=ds, **kw)
                    for ds in tdist.DIST_STRATEGIES}
                built = time.perf_counter() - t1
                for tr in (False, True):
                    want = sum(sl.depth == 1 for sl in
                               pairs["all_gather"][tr].schedule.slabs)
                    if not tr and tag in DIST_FORWARD_COLLECTIVES:
                        check(want == DIST_FORWARD_COLLECTIVES[tag],
                              f"distributed {tag}: {want} sharded segments, "
                              f"expected {DIST_FORWARD_COLLECTIVES[tag]}")
                    for m, b in dev_rhs.items():
                        ref = base[tr].solve(b)
                        base_ms = time_ms(torch, lambda: base[tr].solve(b),
                                          warm=False, budget_ms=DIST_BUDGET_MS)
                        got = {}
                        for ds, pair in pairs.items():
                            s = pair[tr]
                            tdist.reset_collectives()
                            x = solve_counted(s, b)
                            coll = dict(tdist.collectives)
                            xn = x.cpu().numpy()
                            res = residual(A[tr], xn, rhs[m])
                            agree = rel_err(x, ref)
                            check(x.device == b.device and x.shape == b.shape
                                  and np.isfinite(xn).all(),
                                  f"distributed {tag} {layout} {ds}: bad output")
                            check(res <= RESIDUAL_TOL[dt],
                                  f"distributed {tag} {layout} {ds} m={m} "
                                  f"T={int(tr)}: residual {res:.3e}")
                            check(agree <= KERNEL_TOL[dt],
                                  f"distributed {tag} {layout} {ds} m={m} "
                                  f"T={int(tr)}: vs levelset {agree:.3e}")
                            check(coll == {**{k: 0 for k in coll}, ds: want},
                                  f"distributed {tag} {layout} {ds} m={m} "
                                  f"T={int(tr)}: collectives {coll}, "
                                  f"num_collectives {want}")
                            got[ds] = x
                            ms = time_ms(torch, lambda: s.solve(b), warm=False,
                                         budget_ms=DIST_BUDGET_MS)
                            per = ((ms[0] - base_ms[0]) / want * 1e3
                                   if want else float("nan"))
                            times[tag, layout, ds, m, tr] = (ms[0], base_ms[0],
                                                            want, per)
                            print(f"phase 3h: distributed {tag:7s} {layout:8s} "
                                  f"{ds:10s} f64 m={m:2d} transpose={int(tr)}: "
                                  f"{coll[ds]} collectives (num_collectives "
                                  f"{want}), residual {res:.2e}, vs levelset "
                                  f"{agree:.2e}; {fmt_ms(ms)} per solve, "
                                  f"levelset {fmt_ms(base_ms)}, "
                                  f"{per:.3f} us per collective")
                        check(torch.equal(got["psum"], got["all_gather"]),
                              f"distributed {tag} {layout} m={m} T={int(tr)}: "
                              "psum and all_gather answers differ")
                print(f"phase 3h: distributed {tag} {layout} pairs built in "
                      f"{built:.2f} s")
                if tag == "plain" and layout == "permuted":
                    # refresh: new values copied into the same buffers
                    s = pairs["all_gather"][0]
                    ptrs = [v.data_ptr() for v in s._values]
                    new = refresh_values(L, seed=1)
                    t1 = time.perf_counter()
                    s.refresh(new)
                    took = time.perf_counter() - t1
                    b = dev_rhs[WIDTHS[-1]]
                    x = solve_counted(s, b).cpu().numpy()
                    An = scipy_csr(L, new)[False]
                    res = residual(An, x, rhs[WIDTHS[-1]])
                    check(res <= RESIDUAL_TOL[dt]
                          and [v.data_ptr() for v in s._values] == ptrs,
                          f"distributed refresh: residual {res:.3e}")
                    print(f"phase 3h: distributed permuted refresh in "
                          f"{took:.3f} s, value buffers in place, residual "
                          f"against the new factor {res:.2e}")
                del base, pairs
                gc.collect()
                torch.cuda.empty_cache()
        print(f"phase 3h: distributed path in {time.perf_counter() - t0:.1f} s; "
              f"launches in its solves {json.dumps(dist_launches)}")
        # one bare collective of each exchange, off the solve: a value
        # all_gather of the widest forward wavefront's width and the psum's
        # all_reduce of the full vector (what a barrier costs here)
        group = mesh.get_group("data")
        gather = tdist.all_gather_tensor
        wide = torch.zeros(DIST_PROBE_ROWS, dtype=torch.float64, device=dev)
        wide_out = torch.empty_like(wide)
        full = torch.zeros(L.n + 1, dtype=torch.float64, device=dev)
        for what, fn in ((f"all_gather of {DIST_PROBE_ROWS} f64",
                          lambda: gather(wide_out, wide, group=group)),
                         (f"all_reduce of {L.n + 1} f64",
                          lambda: pg.all_reduce(full, group=group))):
            ms = time_ms(torch, fn)
            print(f"phase 3h: a bare {what}: {fmt_ms(ms)} per call; "
                  + device_busy(torch, fn, reps=20))
        t1 = time.perf_counter()
        out_dir = ROOT / "bench_out"
        out_dir.mkdir(exist_ok=True)
        bench = dist_solve.measure(mesh, device=dev)
        dist_solve.write_json(str(out_dir / "BENCH_dist_solve_cuda.json"),
                              bench, dev)
        print(f"phase 3h: bench dist_solve (lung2_like(0.25) n={bench['_n']}) "
              f"in {time.perf_counter() - t1:.1f} s: "
              + json.dumps({f"{label}.{strat}": v for label in ("base", "rewrite")
                            for strat, v in bench[label].items()}))
    finally:
        destroy_process_group()

    # (b) the linear recurrence
    reset_counts()
    t_rec = t1 = time.perf_counter()
    a64 = rng.uniform(0.2, 0.99, RECURRENCE_SHAPE)
    u64 = rng.standard_normal(RECURRENCE_SHAPE)
    want = np.zeros_like(u64)
    acc = np.zeros((RECURRENCE_SHAPE[0], RECURRENCE_SHAPE[2]))
    for t in range(RECURRENCE_SHAPE[1]):
        acc = a64[:, t] * acc + u64[:, t]
        want[:, t] = acc
    host_s = time.perf_counter() - t1
    want_t = torch.from_numpy(want).to(dev)
    for name in ("float32", "float64"):
        tdt = getattr(torch, name)
        a = torch.from_numpy(a64).to(dev, tdt)
        u = torch.from_numpy(u64).to(dev, tdt)
        for method in ("scan", "doubling"):
            h = linear_recurrence(a, u, method=method, axis=1)
            torch.cuda.synchronize()
            err = rel_err(h.double(), want_t)
            check(h.device == u.device and h.dtype == tdt and h.shape == u.shape
                  and err <= RECURRENCE_TOL[name],
                  f"recurrence {method} {name}: {err:.3e}")
            ms = time_ms(torch, lambda: linear_recurrence(a, u, method=method,
                                                          axis=1))
            times["recurrence", method, name] = ms[0]
            print(f"phase 3h: recurrence {method:8s} {name} "
                  f"{RECURRENCE_SHAPE} axis=1: {fmt_ms(ms)}, vs the f64 "
                  f"host loop ({host_s:.2f} s) {err:.2e}")
    T, D = RECURRENCE_SPTRSV
    a_s = torch.from_numpy(a64[0, :T, :D].copy()).to(dev)
    u_s = torch.from_numpy(u64[0, :T, :D].copy()).to(dev)
    t1 = time.perf_counter()
    h = linear_recurrence(a_s, u_s, method="sptrsv")
    torch.cuda.synchronize()
    took = time.perf_counter() - t1
    err = rel_err(h, want_t[0, :T, :D])
    check(h.device == u_s.device and err <= RECURRENCE_TOL["float64"],
          f"recurrence sptrsv T={T} D={D}: {err:.3e}")
    print(f"phase 3h: recurrence sptrsv T={T} D={D} f64 (build, rewrite and "
          f"solve per lane): {took:.2f} s, vs the f64 host loop {err:.2e}")
    C = recurrence_as_sptrsv(a64[0, :T, 0])
    lv = build_level_sets(C)
    res = rewrite_matrix(C, lv, RewriteConfig(thin_threshold=1, max_row_nnz=T + 1,
                                              max_fill_ratio=float(T)))
    check((lv.num_levels, res.levels.num_levels) == (T, 2),
          f"chain T={T}: {lv.num_levels} -> {res.levels.num_levels} levels")
    print(f"phase 3h: chain matrix T={T}: {lv.num_levels} levels -> "
          f"{res.levels.num_levels} after the rewrite; {res.stats.summary()}")
    torch.cuda.synchronize()
    rec_launches = counts()
    print(f"phase 3h: recurrence in {time.perf_counter() - t_rec:.1f} s; "
          f"launches {json.dumps(rec_launches)}")
    print(f"phase 3h: in {time.perf_counter() - t0:.1f} s")
    return {"distributed": dist_launches, "recurrence": rec_launches,
            "times": times}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible (torch.cuda.is_available() "
              "is False)", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: {ROOT / 'src' / 'repro_torch'} is missing; run "
              "from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import scipy.sparse as sp
    from scipy.sparse.linalg import spsolve_triangular

    from repro_torch.core import RewriteConfig, SpTRSV, SupernodeConfig
    from repro_torch.core.coarsen import build_block_schedule, coarsen_schedule
    from repro_torch.core.codegen import build_ell, build_schedule
    from repro_torch.core.levels import build_level_sets, detect_supernodes
    from repro_torch.core.levels import build_reverse_level_sets
    from repro_torch.core.packed import (build_packed_blocked_layout,
                                         level_table, pack_blocked_values,
                                         permute_rhs, walk_geometry)
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attn import cuda as flash_cuda
    from repro_torch.kernels.flash_attn.ref import gqa_attention_ref
    from repro_torch.kernels.spmv_ell import cuda as spmv_cuda
    from repro_torch.kernels.spmv_ell.ops import device_cols, device_row_len
    from repro_torch.kernels.spmv_ell.ref import spmv_ref
    from repro_torch.kernels.sptrsv_fused import cuda as fused_cuda
    from repro_torch.kernels.sptrsv_fused.ops import build_layout
    from repro_torch.kernels.sptrsv_fused.ref import fused_solve_ref
    from repro_torch.kernels.sptrsv_fused.table import fused_table
    from repro_torch.kernels.sptrsv_level import cuda as level_cuda
    from repro_torch.kernels.sptrsv_level import ops as level_ops
    from repro_torch.kernels.sptrsv_level.ops import make_packed_solver
    from repro_torch.kernels.sptrsv_level.ref import (level_scatter_ref,
                                                      level_walk_ref)
    from repro_torch.kernels.sptrsv_level.table import make_scatter_table
    from repro_torch.kernels.trsm_block import cuda as trsm_cuda
    from repro_torch.kernels.trsm_block.ops import make_walk_table
    from repro_torch.kernels.trsm_block.ref import block_apply_ref, blocked_walk_ref
    from repro_torch.sparse import (banded_lower, chain_matrix, lung2_like,
                                    random_lower, refresh_values)

    counters = (level_cuda, fused_cuda, spmv_cuda, trsm_cuda, flash_cuda)

    def reset_counts() -> None:
        for mod in counters:
            mod.reset_launches()

    def counts() -> dict:
        return {k: v for mod in counters for k, v in mod.launches.items()}

    def scipy_csr(M, data=None):
        A = sp.csr_matrix((M.data if data is None else data, M.indices,
                           M.indptr), shape=M.shape)
        return {False: A, True: A.T.tocsr()}

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}")
    t_start = time.perf_counter()

    # -- phase 1: build -------------------------------------------------
    # nvcc runs in the background while the host generates the matrices and
    # builds the solvers and layouts below (a build step that needs a
    # library waits for it on the build lock); phase 2 starts once it is done
    nvcc_pool = ThreadPoolExecutor(max_workers=1)
    built = nvcc_pool.submit(lambda: (build.build_all(), time.perf_counter()))

    t0 = time.perf_counter()
    L64 = lung2_like(scale=LUNG2_SCALE, seed=0)
    mats = {"float64": L64, "float32": L64.astype(np.float32)}
    band64 = banded_lower(BAND_N, bandwidth=BAND_WIDTH, fill=1.0, seed=0)
    bands = {"float64": band64, "float32": band64.astype(np.float32)}
    wide64 = banded_lower(WIDE_BAND_N, bandwidth=WIDE_BAND_WIDTH, fill=1.0, seed=0)
    wide_bands = {"float64": wide64, "float32": wide64.astype(np.float32)}
    print(f"lung2_like(scale={LUNG2_SCALE}): n={L64.n} nnz={L64.nnz}; "
          f"banded_lower({BAND_N}, bandwidth={BAND_WIDTH}, fill=1.0): "
          f"nnz={band64.nnz}; banded_lower({WIDE_BAND_N}, bandwidth="
          f"{WIDE_BAND_WIDTH}, fill=1.0): nnz={wide64.nnz} (generated in "
          f"{time.perf_counter() - t0:.1f} s)")

    # Solvers of the paths, built once per dtype.
    t0 = time.perf_counter()
    solvers, rw_solvers, blk_solvers, wide_solvers = {}, {}, {}, {}
    for dt, L in mats.items():
        for tag, kw in VARIANTS.items():
            solvers[tag, dt] = SpTRSV.build_pair(L, device="cuda", **kw)
    t_lvl = time.perf_counter() - t0
    t0 = time.perf_counter()
    for dt, L in mats.items():
        for tag, kw in VARIANTS.items():
            rw_solvers[tag, dt] = SpTRSV.build_pair(
                L, device="cuda", rewrite=RewriteConfig(), **kw)
    t_rw = time.perf_counter() - t0
    t0 = time.perf_counter()
    for dt, B in bands.items():
        blk_solvers[dt] = SpTRSV.build_pair(B, device="cuda", strategy="blocked")
        wide_solvers[dt] = SpTRSV.build_pair(wide_bands[dt], device="cuda",
                                             strategy="blocked")
    t_blk = time.perf_counter() - t0
    fwd = solvers["pallas_level", "float64"][0]
    for s in solvers["pallas_level", "float64"]:
        ks = [sl.K for sl in s.schedule.slabs]
        print(f"transpose={int(s.transpose)}: ELL width K max {max(ks)}, "
              f"levels with K > 64: {sum(k > 64 for k in ks)}, padded FLOPs "
              f"{s.schedule.padded_flops()}; fused n_pad "
              f"{solvers['pallas_fused', 'float64'][int(s.transpose)].stats()['n_pad']}")
    print(f"built {len(solvers)} solver pairs in {t_lvl:.1f} s; "
          f"levels={fwd.analysis.num_levels} segments: "
          + ", ".join(f"{t}={solvers[t, 'float64'][0].stats()['segments']}"
                      for t in VARIANTS))
    print(f"built {len(rw_solvers)} rewritten solver pairs in {t_rw:.1f} s")
    for s in rw_solvers["pallas_level", "float64"]:
        rs = s.rewrite_result
        print(f"rewrite transpose={int(s.transpose)}: {rs.stats.summary()}; "
              f"E nnz {rs.E.nnz} (off-diagonal {rs.stats.e_nnz_offdiag}), "
              f"E ELL K {build_ell(rs.E).K}; segments: "
              + ", ".join(f"{t}={rw_solvers[t, 'float64'][int(s.transpose)].stats()['segments']}"
                          for t in VARIANTS)
              + f"; fused ELL K {max(sl.K for sl in rw_solvers['pallas_fused', 'float64'][int(s.transpose)].schedule.slabs)}")
    for s in (*blk_solvers["float64"], *wide_solvers["float64"]):
        st = s.stats()
        print(f"blocked n={s.n} transpose={int(s.transpose)}: {st['segments']} segments, "
              f"{st['supernode_count']} supernodes, mean block "
              f"{st['mean_block_size']:.1f}, panel K max "
              f"{max(sl.K for sl in s.block_schedule.slabs)} "
              f"(built both dtypes in {t_blk:.1f} s)")

    # The blocked walk's layouts: the band's (from its solver), lung2's
    # single-row supernodes and a random factor of mixed block sizes.
    t0 = time.perf_counter()

    def blocked_layout(M, config=None):
        sn = detect_supernodes(M, config=config or SupernodeConfig())
        return build_packed_blocked_layout(build_block_schedule(M, sn))

    mixed = random_lower(MIXED_N, seed=5)
    walk_layouts = {
        "band": (blocked_layout(band64), band64),
        "wide band": (blocked_layout(wide64), wide64),
        "lung2": (blocked_layout(L64), L64),
        "mixed": (blocked_layout(mixed, SupernodeConfig(**MIXED_SUPERNODES)), mixed)}
    walk_tables = {what: make_walk_table(walk_geometry(lay),
                                         [g.lane_idx for g in lay.segments], dev)
                   for what, (lay, _) in walk_layouts.items()}
    for what, (lay, _) in walk_layouts.items():
        geo = walk_tables[what].host
        print(f"walk layout {what}: n={lay.n} segments={geo.shape[0]} B max "
              f"{geo[:, 2].max()} T {sorted(set(geo[:, 3].tolist()))[:12]} K max "
              f"{geo[:, 4].max()} pad lanes {int((geo[:, 2] * geo[:, 3] - geo[:, 1]).sum())}")
    print(f"built the walk layouts in {time.perf_counter() - t0:.1f} s")

    paths, t_built = built.result()
    nvcc_pool.shutdown()
    print(f"phase 1: built {len(paths)} kernel libraries in "
          f"{t_built - t_start:.1f} s, beside the set-up")
    for name, path in paths.items():
        log = path.with_suffix(".log")
        for line in (log.read_text().splitlines() if log.exists() else []):
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")
    hmma = sass_hmma(paths["flash_attn"])
    print(f"phase 1: HMMA instructions in the flash library's SASS: "
          f"{sum(hmma.values())} ({json.dumps(hmma)})")
    check(sum(hmma.values()) > 0, "the flash kernel has no tensor-core instruction")
    print(f"set-up (matrices, solvers, layouts) and phase 1: "
          f"{time.perf_counter() - t_start:.1f} s after the card check")
    # -- phase 2: each kernel against its plain version -------------------
    t_phase = time.perf_counter()
    # phases 2 and 3 read the fused walk's error word after every launch,
    # so a wait that runs out raises; phase 4 times the solver as it runs
    # by default, without the read
    fused_cuda.check_waits = True
    rng = np.random.default_rng(0)
    kernel_err = {}

    def record(name, dt, got, want, what, tol=None):
        tol = KERNEL_TOL[dt] if tol is None else tol
        torch.cuda.synchronize()
        err = rel_err(got, want)
        check(torch.isfinite(got).all().item(), f"{name} {dt} {what}: non-finite")
        check(err <= tol, f"{name} {dt} {what}: rel err {err:.3e}")
        kernel_err[name, dt] = max(kernel_err.get((name, dt), 0.0),
                                   float((got - want).abs().max()))
        print(f"phase 2: {name:24s} {dt} {what}: max rel err {err:.3e} "
              f"(tol {tol:g})")

    def randn(shape, tdt):
        return torch.from_numpy(rng.standard_normal(shape)).to(dev, tdt)

    # the level walk's whole coarsened tables: lung2 both directions, and a
    # small lung2 transpose whose chains are wide
    small_t = lung2_like(scale=WIDE_CHAIN_SCALE, seed=0)
    small_t_sched = coarsen_schedule(build_schedule(
        small_t.transpose(), build_reverse_level_sets(small_t), upper=True))
    for dt, L in mats.items():
        tdt = getattr(torch, dt)
        sched = solvers["pallas_level", dt][0].schedule
        level_cases = {
            f"lung2 {d} coarsened": coarsen_schedule(
                solvers["pallas_level", dt][t].schedule)
            for t, d in enumerate(("forward", "transpose"))}
        level_cases[f"lung2(scale={WIDE_CHAIN_SCALE}) transpose coarsened"] = \
            small_t_sched
        for what, co_sched in level_cases.items():
            _, vals0, _, lay = make_packed_solver(co_sched, device="cuda")
            table = level_table(lay, dev)
            kinds = table.kinds()
            cols = torch.from_numpy(lay.cols_flat).to(dev)
            vf, df = vals0[0].to(tdt), vals0[1].to(tdt)
            n_x = -(-lay.n_pad // 128) * 128
            for m in WIDTHS:
                shape = (n_x,) if m == 1 else (n_x, m)
                x0, bhat = randn(shape, tdt), randn(shape, tdt)
                xk, xr = x0.clone(), x0.clone()
                name = "sptrsv_level" if m == 1 else "sptrsv_level_batched"
                before = (level_cuda.launches[name], dict(level_cuda.launch_kinds))
                level_cuda.level_walk(xk, bhat, cols, vf, df, table)
                level_walk_ref(xr, bhat, cols.long(), vf, df, table)
                got = {k: level_cuda.launch_kinds[k] - before[1][k] for k in kinds}
                check(level_cuda.launches[name] - before[0] == table.num_segments
                      and got == kinds, f"{name} {dt} {what}: launches {got}, "
                      f"expected one per segment {kinds}")
                record(name, dt, xk, xr, f"m={m:2d} {what}: {table.num_segments} "
                       f"launches for {len(table.steps)} wavefronts {json.dumps(kinds)}, "
                       f"K max {int(table.host[:, 1].max())}")

        # the scatter layout's level step over lung2's whole forward and
        # transpose schedules: one launch per wavefront
        for t, d in enumerate(("forward", "transpose")):
            sfn = level_ops.make_solver(solvers["pallas_level", dt][t].schedule,
                                        device="cuda")
            srows, scols, svals, sdiag = sfn.buffers
            vf, df = svals.to(tdt), sdiag.to(tdt)
            for m in WIDTHS:
                tail = () if m == 1 else (m,)
                b_ext = randn((L.n + 1,) + tail, tdt)
                b_ext[L.n] = 0
                xk = torch.zeros((sfn.n_pad,) + tail, dtype=tdt, device=dev)
                xr = xk.clone()
                name = "sptrsv_level_scatter" + ("" if m == 1 else "_batched")
                before = level_cuda.launches[name]
                level_cuda.level_scatter(xk, b_ext, srows, scols, vf, df, sfn.table)
                level_scatter_ref(xr, b_ext, srows.long(), scols.long(), vf, df,
                                  sfn.table)
                check(level_cuda.launches[name] - before == sfn.table.num_steps,
                      f"{name} {dt} {d}: launches")
                record(name, dt, xk, xr, f"m={m:2d} lung2 {d}: "
                       f"{sfn.table.num_steps} launches, K max "
                       f"{int(sfn.table.host[:, 0].max())}")
            del sfn, srows, scols, svals, sdiag, vf, df

        # the fused solves on lung2's whole layouts: the single-RHS walk in
        # both directions, the batched grid forward
        for d, fsched in (("forward", sched),
                          ("transpose", solvers["pallas_level", dt][1].schedule)):
            flay = build_layout(fsched)
            ftable = fused_table(flay, dev)
            fcols = torch.from_numpy(flay.cols).to(dev)
            fvals = torch.from_numpy(flay.vals).to(dev)
            fdiag = torch.from_numpy(flay.diag).to(dev)
            spans = torch.tensor(flay.spans, dtype=torch.int32, device=dev)
            for m in (WIDTHS if d == "forward" else (1,)):
                bl = randn((flay.n_pad,) if m == 1 else (flay.n_pad, m), tdt)
                xk = fused_cuda.fused_solve(bl, fcols, fvals, fdiag, spans, ftable)
                xr = fused_solve_ref(bl, fcols, fvals, fdiag, chunk=flay.chunk)
                record("sptrsv_fused" if m == 1 else "sptrsv_fused_batched", dt,
                       xk, xr, f"m={m:2d} {d} whole layout n_pad={flay.n_pad} "
                       f"K={flay.K} spans={len(flay.spans)}"
                       + (f", {ftable.num_groups} groups ({ftable.num_real} of "
                          f"real rows), grid {fused_cuda.walk_grid(tdt)} blocks"
                          if m == 1 else
                          f", grid {fused_cuda.batched_grid(tdt)} blocks"))
            del flay, ftable, fcols, fvals, fdiag, spans, bl, xk, xr
        # both fused solves on a chain (one row per span): the walk's 999
        # dependent hops, the batched grid's barrier per span
        chain = chain_matrix(CHAIN_N, dtype=np.dtype(dt))
        clay = build_layout(build_schedule(chain, build_level_sets(chain)))
        ctable = fused_table(clay, dev)
        ccols, cvals, cdiag = (torch.from_numpy(a).to(dev)
                               for a in (clay.cols, clay.vals, clay.diag))
        cspans = torch.tensor(clay.spans, dtype=torch.int32, device=dev)
        for m in WIDTHS:
            bl = randn((clay.n_pad,) if m == 1 else (clay.n_pad, m), tdt)
            name = "sptrsv_fused" if m == 1 else "sptrsv_fused_batched"
            record(name, dt,
                   fused_cuda.fused_solve(bl, ccols, cvals, cdiag, cspans, ctable),
                   fused_solve_ref(bl, ccols, cvals, cdiag, chunk=clay.chunk),
                   f"m={m:2d} chain n={chain.n} n_pad={clay.n_pad} "
                   f"spans={len(clay.spans)}")
            fused_cuda.check_waits = False
            t = time_ms(torch, lambda: fused_cuda.fused_solve(
                bl, ccols, cvals, cdiag, cspans, ctable))
            fused_cuda.check_waits = True
            print(f"phase 2: {name} {dt} chain: {fmt_ms(t)} per solve, " + (
                f"{t[0] / (chain.n - 1) * 1e3:.3f} us per dependent hop (a poll "
                "of x from L2, the row, its store)" if m == 1 else
                f"{t[0] / len(clay.spans) * 1e3:.3f} us per span (a grid "
                "barrier and one dependent row)"))

        # the SpMV on the forward rewrite's E and on one panel of the band
        E = rw_solvers["levelset", dt][0].rewrite_result.E
        ell = build_ell(E)
        slabs = {"lung2 E": (device_cols(ell.cols, E.n, dev),
                             torch.from_numpy(ell.vals).to(dev), E.n)}
        blay = build_packed_blocked_layout(blk_solvers[dt][0].block_schedule)
        bseg = max(blay.segments[:4], key=lambda s: s.K)
        span = slice(bseg.val_off, bseg.val_off + bseg.K * bseg.B * bseg.T)
        slabs["band panel"] = (
            device_cols(blay.cols_flat[span].reshape(bseg.K, -1), blay.n, dev),
            torch.from_numpy(blay.vals_flat[span].reshape(bseg.K, -1)).to(dev),
            blay.n)
        for what, (ecols, evals, n_v) in slabs.items():
            for m in WIDTHS:
                v = randn((n_v,) if m == 1 else (n_v, m), tdt)
                record("spmv_ell" if m == 1 else "spmv_ell_batched", dt,
                       spmv_cuda.spmv(v, ecols, evals),
                       spmv_ref(v, ecols.long(), evals),
                       f"m={m:2d} {what} K={ecols.shape[0]} n={ecols.shape[1]}")

        # the block apply on one band segment and on a synthetic batch
        _, dinv_flat = pack_blocked_values(blay, bands[dt].data)
        seg_dinv = torch.from_numpy(
            dinv_flat[bseg.dinv_off: bseg.dinv_off + bseg.B * bseg.T ** 2]
            .reshape(bseg.B, bseg.T, bseg.T)).to(dev, tdt)
        for what, dinv in (("band segment", seg_dinv),
                           ("synthetic", randn((512, 64, 64), tdt))):
            B_, T_ = dinv.shape[:2]
            for m in WIDTHS:
                rhs = randn((B_, T_) if m == 1 else (B_, T_, m), tdt)
                record("trsm_block_apply" if m == 1 else "trsm_block_apply_batched",
                       dt, trsm_cuda.block_apply(dinv, rhs),
                       block_apply_ref(dinv, rhs),
                       f"m={m:2d} {what} B={B_} T={T_}")

        # the SpMV with E's row lengths, as the rewrite path runs it: the
        # same values as all K slots, NaN rows included when v[0] = inf
        ecols, evals, _ = slabs["lung2 E"]
        elen = device_row_len(E.row_nnz(), ell.cols, dev)
        for m in WIDTHS:
            v = randn((E.n,) if m == 1 else (E.n, m), tdt)
            name = "spmv_ell" if m == 1 else "spmv_ell_batched"
            record(name, dt, spmv_cuda.spmv(v, ecols, evals, elen),
                   spmv_ref(v, ecols.long(), evals),
                   f"m={m:2d} lung2 E with row lengths")
            v[0] = float("inf")
            got = spmv_cuda.spmv(v, ecols, evals, elen)
            full = spmv_cuda.spmv(v, ecols, evals)
            want = spmv_ref(v, ecols.long(), evals)
            torch.cuda.synchronize()
            fin = torch.isfinite(want)
            for y in (got, full):
                check(torch.equal(torch.isnan(y), torch.isnan(want))
                      and torch.equal(torch.isinf(y), torch.isinf(want)),
                      f"{name} {dt} v[0]=inf: NaN/inf rows differ")
            check(torch.equal(got[fin], full[fin]),
                  f"{name} {dt} v[0]=inf: row lengths change a value")
            err = rel_err(got[fin], want[fin])
            check(err <= KERNEL_TOL[dt], f"{name} {dt} v[0]=inf: rel err {err:.3e}")
            print(f"phase 2: {name:24s} {dt} m={m:2d} lung2 E with row lengths, "
                  f"v[0]=inf: {int(torch.isnan(want).sum())} NaN entries as in "
                  f"the plain version, finite ones max rel err {err:.3e}")

        # the blocked walk on each layout
        for what, (lay, M) in walk_layouts.items():
            table = walk_tables[what]
            wcols = device_cols(lay.cols_flat, lay.n, dev)
            wvals, wdinv = (torch.from_numpy(a).to(dev, tdt)
                            for a in pack_blocked_values(lay, M.data))
            for m in WIDTHS:
                bhat = randn((lay.n,) if m == 1 else (lay.n, m), tdt)
                xk, xr = torch.zeros_like(bhat), torch.zeros_like(bhat)
                trsm_cuda.blocked_walk(xk, bhat, wcols, wvals, wdinv, table)
                blocked_walk_ref(xr, bhat, wcols.long(), wvals, wdinv, table)
                cfg = trsm_cuda.walk_config(table, m, tdt)
                # only the wide band's f64 panels are too wide to stage
                check((cfg["global_panels"] > 0) == (what == "wide band" and dt == "float64"),
                      f"walk {what} {dt} m={m}: {cfg['global_panels']} panels "
                      "in device memory")
                record("trsm_block_walk" if m == 1 else "trsm_block_walk_batched",
                       dt, xk, xr, f"m={m:2d} {what} ({table.num_segments} "
                       f"segments; {json.dumps(cfg)})")

    flash_checks(torch, dev, rng, record, flash_cuda, gqa_attention_ref)
    print(f"phase 2: kernels against their plain versions in "
          f"{time.perf_counter() - t_phase:.1f} s")

    # -- phase 3: the paths -----------------------------------------------
    t_phase = time.perf_counter()
    small = lung2_like(scale=0.02, fat_levels=4, seed=3)
    small_band = banded_lower(SMALL_BAND_N, bandwidth=BAND_WIDTH, fill=1.0, seed=3)
    for M, kws in ((small, [VARIANTS[t] for t in LEVEL_TAGS]
                    + [dict(rewrite=RewriteConfig(), **VARIANTS[t]) for t in VARIANTS]),
                   (small_band, [dict(strategy="blocked")])):
        dense = M.to_dense()
        bs = rng.standard_normal((M.n, 3))
        for kw in kws:
            for s, A in zip(SpTRSV.build_pair(M, device="cuda", **kw),
                            (dense, dense.T)):
                x = s.solve(torch.from_numpy(bs).to(dev)).cpu().numpy()
                err = float(np.abs(x - np.linalg.solve(A, bs)).max())
                check(err <= 1e-11, f"small {kw} transpose={s.transpose}: {err:.3e}")
    print(f"phase 3: small lung2_like(n={small.n}) matches a dense solve for all "
          f"kernel strategies, with and without rewriting, and the small band "
          f"(n={small_band.n}) for blocked, both directions")

    path_launches = {}

    # A transpose pallas_fused batch (the lung2 transpose's ELL width of
    # 1,975, which the transpose rewrite keeps) joins the paths and timings
    # only if its first solve takes under TRANSPOSE_FUSED_MAX_S.
    fast_transpose = set()
    for group in (solvers, rw_solvers):
        for dt in mats:
            s = group["pallas_fused", dt][1]
            b = torch.from_numpy(rng.standard_normal((s.n, WIDTHS[-1]))).to(
                dev, getattr(torch, dt))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s.solve(b)
            torch.cuda.synchronize()
            took = time.perf_counter() - t0
            if took < TRANSPOSE_FUSED_MAX_S:
                fast_transpose.add(id(s))
            print(f"phase 3: first transpose {'rewrite:' if group is rw_solvers else ''}"
                  f"pallas_fused {dt} m={WIDTHS[-1]} solve: {took:.4f} s ("
                  + ("runs on the paths" if took < TRANSPOSE_FUSED_MAX_S else
                     f"left out: over {TRANSPOSE_FUSED_MAX_S} s") + ")")

    def runs(tag, s, m):
        return (not (tag == "pallas_fused" and s.transpose and m > 1)
                or id(s) in fast_transpose)

    # 3a: the level-scheduled and fused solves
    reset_counts()
    t0 = time.perf_counter()
    for dt, L in mats.items():
        A = scipy_csr(L)
        new = refresh_values(L, seed=1)
        A2 = scipy_csr(L, new)
        for m in WIDTHS:
            b_np = rng.standard_normal((L.n,) if m == 1 else (L.n, m)).astype(dt)
            b = torch.from_numpy(b_np).to(dev)
            base = {s.transpose: s.solve(b) for s in solvers["levelset", dt]}
            for tag in LEVEL_TAGS:
                for s in solvers[tag, dt]:
                    if not runs(tag, s, m):
                        continue
                    x = s.solve(b)
                    torch.cuda.synchronize()
                    xn = x.double().cpu().numpy()
                    check(x.shape == b.shape and np.isfinite(xn).all(),
                          f"{tag} {dt} m={m}: bad output")
                    res = residual(A[s.transpose], xn, b_np.astype(np.float64))
                    agree = rel_err(x, base[s.transpose])
                    check(res <= RESIDUAL_TOL[dt],
                          f"{tag} {dt} m={m} T={s.transpose}: residual {res:.3e}")
                    check(agree <= KERNEL_TOL[dt],
                          f"{tag} {dt} m={m} T={s.transpose}: vs levelset {agree:.3e}")
                    print(f"phase 3a: {tag:21s} {dt} m={m:2d} transpose="
                          f"{int(s.transpose)} residual {res:.2e} "
                          f"vs levelset {agree:.2e}")
        # refresh in place, then solve again against the new values
        for tag in LEVEL_TAGS:
            for s in solvers[tag, dt]:
                m = WIDTHS[-1] if runs(tag, s, WIDTHS[-1]) else 1
                b_np = rng.standard_normal((L.n,) if m == 1 else (L.n, m)).astype(dt)
                ptrs = [v.data_ptr() for v in s._values]
                s.refresh(new)
                check(ptrs == [v.data_ptr() for v in s._values],
                      f"{tag}: refresh moved a value buffer")
                xn = s.solve(torch.from_numpy(b_np).to(dev)).double().cpu().numpy()
                res = residual(A2[s.transpose], xn, b_np.astype(np.float64))
                check(res <= RESIDUAL_TOL[dt],
                      f"refresh {tag} {dt} T={s.transpose}: residual {res:.3e}")
                print(f"phase 3a: refresh {tag:21s} {dt} m={m:2d} transpose="
                      f"{int(s.transpose)} residual {res:.2e}")
                s.refresh(L.data)
    torch.cuda.synchronize()
    path_launches["level"] = counts()
    print(f"phase 3a: level/fused path in {time.perf_counter() - t0:.1f} s; "
          f"launches {json.dumps(path_launches['level'])}")
    for name in ("sptrsv_level", "sptrsv_level_batched", "sptrsv_fused",
                 "sptrsv_fused_batched"):
        check(path_launches["level"][name] > 0,
              f"{name} never launched on the level/fused path")

    # 3b: the rewritten solves
    reset_counts()
    t0 = time.perf_counter()
    for dt, L in mats.items():
        A = scipy_csr(L)
        new = refresh_values(L, seed=1)
        A2 = scipy_csr(L, new)
        for m in WIDTHS:
            b_np = rng.standard_normal((L.n,) if m == 1 else (L.n, m)).astype(dt)
            b = torch.from_numpy(b_np).to(dev)
            base = {s.transpose: s.solve(b) for s in solvers["levelset", dt]}
            for tag in VARIANTS:
                for s in rw_solvers[tag, dt]:
                    if not runs(tag, s, m):
                        continue
                    x = s.solve(b)
                    torch.cuda.synchronize()
                    xn = x.double().cpu().numpy()
                    check(x.shape == b.shape and np.isfinite(xn).all(),
                          f"rewrite {tag} {dt} m={m}: bad output")
                    res = residual(A[s.transpose], xn, b_np.astype(np.float64))
                    agree = rel_err(x, base[s.transpose])
                    check(res <= RESIDUAL_TOL[dt],
                          f"rewrite {tag} {dt} m={m} T={s.transpose}: residual {res:.3e}")
                    check(agree <= REWRITE_AGREE_TOL[dt],
                          f"rewrite {tag} {dt} m={m} T={s.transpose}: vs "
                          f"unrewritten levelset {agree:.3e}")
                    print(f"phase 3b: rewrite {tag:21s} {dt} m={m:2d} transpose="
                          f"{int(s.transpose)} residual {res:.2e} vs unrewritten "
                          f"levelset {agree:.2e}")
        for tag in VARIANTS:
            for s in rw_solvers[tag, dt]:
                m = WIDTHS[-1] if runs(tag, s, WIDTHS[-1]) else 1
                b_np = rng.standard_normal((L.n,) if m == 1 else (L.n, m)).astype(dt)
                bufs = (*s._values, s._e_values)
                ptrs = [v.data_ptr() for v in bufs]
                s.refresh(new)
                check(all(a is b_ for a, b_ in zip(bufs, (*s._values, s._e_values)))
                      and ptrs == [v.data_ptr() for v in (*s._values, s._e_values)],
                      f"rewrite {tag}: refresh moved a value buffer")
                xn = s.solve(torch.from_numpy(b_np).to(dev)).double().cpu().numpy()
                res = residual(A2[s.transpose], xn, b_np.astype(np.float64))
                check(res <= RESIDUAL_TOL[dt],
                      f"refresh rewrite {tag} {dt} T={s.transpose}: residual {res:.3e}")
                print(f"phase 3b: refresh rewrite {tag:21s} {dt} m={m:2d} "
                      f"transpose={int(s.transpose)} residual {res:.2e}")
                s.refresh(L.data)
    torch.cuda.synchronize()
    path_launches["rewrite"] = counts()
    print(f"phase 3b: rewrite path in {time.perf_counter() - t0:.1f} s; "
          f"launches {json.dumps(path_launches['rewrite'])}")
    for name in ("sptrsv_level", "sptrsv_level_batched", "sptrsv_fused",
                 "sptrsv_fused_batched", "spmv_ell", "spmv_ell_batched"):
        check(path_launches["rewrite"][name] > 0,
              f"{name} never launched on the rewrite path")

    # 3c: the blocked solves on the band and the wide band
    reset_counts()
    t0 = time.perf_counter()
    blk_solves = {"trsm_block_walk": 0, "trsm_block_walk_batched": 0}
    for what, dt in [(w, dt) for w in ("band", "wide band") for dt in bands]:
        B = (bands if what == "band" else wide_bands)[dt]
        pair = (blk_solvers if what == "band" else wide_solvers)[dt]
        A = scipy_csr(B)
        A64 = scipy_csr(band64 if what == "band" else wide64)
        # refresh_values' diagonal (|N(0, 0.3)| + 1) does not dominate 24
        # off-diagonals, and a forward solve over 110,592 rows of such
        # values overflows; the band's own values perturbed by 10% keep it
        # as well conditioned as the factor
        new = (B.data * (1.0 + 0.1 * np.random.default_rng(1).standard_normal(
            B.nnz))).astype(B.dtype)
        A2 = scipy_csr(B, new)
        for m in WIDTHS:
            b_np = rng.standard_normal((B.n,) if m == 1 else (B.n, m)).astype(dt)
            b = torch.from_numpy(b_np).to(dev)
            for s in pair:
                x = s.solve(b)
                blk_solves["trsm_block_walk" if m == 1 else "trsm_block_walk_batched"] += 1
                torch.cuda.synchronize()
                xn = x.double().cpu().numpy()
                check(x.shape == b.shape and np.isfinite(xn).all(),
                      f"blocked {dt} m={m}: bad output")
                res = residual(A[s.transpose], xn, b_np.astype(np.float64))
                want = spsolve_triangular(A64[s.transpose],
                                          b_np.astype(np.float64),
                                          lower=not s.transpose)
                agree = float(np.abs(xn - want).max() / np.abs(want).max())
                check(res <= RESIDUAL_TOL[dt],
                      f"blocked {what} {dt} m={m} T={s.transpose}: residual {res:.3e}")
                check(agree <= BLOCKED_AGREE_TOL[dt],
                      f"blocked {what} {dt} m={m} T={s.transpose}: vs scipy {agree:.3e}")
                print(f"phase 3c: blocked {what} {dt} m={m:2d} transpose="
                      f"{int(s.transpose)} residual {res:.2e} vs scipy f64 "
                      f"{agree:.2e}")
        b_np = rng.standard_normal((B.n, WIDTHS[-1])).astype(dt)
        for s in pair:
            ptrs = [v.data_ptr() for v in s._values]
            s.refresh(new)
            check(ptrs == [v.data_ptr() for v in s._values],
                  "blocked: refresh moved a value buffer")
            xn = s.solve(torch.from_numpy(b_np).to(dev)).double().cpu().numpy()
            blk_solves["trsm_block_walk_batched"] += 1
            res = residual(A2[s.transpose], xn, b_np.astype(np.float64))
            check(res <= RESIDUAL_TOL[dt],
                  f"refresh blocked {what} {dt} T={s.transpose}: residual {res:.3e}")
            print(f"phase 3c: refresh blocked {what} {dt} transpose="
                  f"{int(s.transpose)} residual {res:.2e}")
            s.refresh(B.data)
    torch.cuda.synchronize()
    path_launches["blocked"] = counts()
    print(f"phase 3c: blocked path in {time.perf_counter() - t0:.1f} s; "
          f"launches {json.dumps(path_launches['blocked'])}")
    # one walk launch per solve, and nothing else
    want = {name: blk_solves.get(name, 0) for name in path_launches["blocked"]}
    check(path_launches["blocked"] == want,
          f"blocked path launches {json.dumps(path_launches['blocked'])}, "
          f"expected one walk per solve: {json.dumps(want)}")

    # 3d: the LM serving path at granite-3-8b's full width and depth
    t0 = time.perf_counter()
    families = {LM_ARCH: lm_family(torch, dev, rng, LM_ARCH, reset_counts, counts,
                                   flash_cuda, "3d")}
    path_launches["lm"] = families[LM_ARCH]["launches"]
    torch.cuda.empty_cache()
    print(f"phase 3d: LM path in {time.perf_counter() - t0:.1f} s")

    # 3e: the rest of the solver's surface: serial, levelset_unroll, auto,
    # sweep, guard and PCG
    reset_counts()
    t0 = time.perf_counter()
    print(f"phase 3e: host memory {host_rss_gb():.1f} GB resident")
    auto_times = solver_surface(torch, dev, rng, L64,
                                solvers["levelset", "float64"], scipy_csr, counts)
    torch.cuda.synchronize()
    path_launches["surface"] = counts()
    print(f"phase 3e: solver surface in {time.perf_counter() - t0:.1f} s; "
          f"launches {json.dumps(path_launches['surface'])}")
    for name in ("spmv_ell", "spmv_ell_batched", "sptrsv_fused",
                 "sptrsv_fused_batched", "sptrsv_level", "sptrsv_level_batched"):
        check(path_launches["surface"][name] > 0,
              f"{name} never launched on the solver-surface path")
    from repro_torch.bench.calibrate import measure
    from repro_torch.core.calibrate import DEFAULT_CALIBRATIONS
    t0 = time.perf_counter()
    row, raw = measure("cuda")
    print(f"phase 3e: calibration re-measured in {time.perf_counter() - t0:.1f} s: "
          f"{json.dumps({k: round(v, 6) for k, v in raw.items()})}")
    print(f"phase 3e: calibration measured  {row!r}")
    print(f"phase 3e: calibration committed {DEFAULT_CALIBRATIONS['cuda']!r}")

    # 3f: the serving tier and the paper's experiments
    t0 = time.perf_counter()
    tier = serving_tier(torch, dev, L64, scipy_csr, reset_counts, counts)
    path_launches["serving"] = tier["serving"]
    path_launches["experiments"] = tier["experiments"]
    print(f"phase 3f: serving tier and experiments in "
          f"{time.perf_counter() - t0:.1f} s; launches serving "
          f"{json.dumps(tier['serving'])}, experiments "
          f"{json.dumps(tier['experiments'])}")
    for name in ("sptrsv_fused", "sptrsv_fused_batched"):
        check(tier["serving"].get(name, 0) > 0,
              f"{name} never launched on the serving path")
    for name in ("sptrsv_level", "sptrsv_fused", "spmv_ell"):
        check(tier["experiments"].get(name, 0) > 0,
              f"{name} never launched by the experiments")

    # 3g: the scatter layout and the eight CI benches
    t0 = time.perf_counter()
    sc = scatter_phase(torch, dev, rng, L64, band64, solvers, rw_solvers,
                       scipy_csr, reset_counts, counts, (row, raw))
    path_launches["scatter"] = sc["scatter"]
    path_launches["benches"] = sc["benches"]
    print(f"phase 3g: scatter layout and benches in "
          f"{time.perf_counter() - t0:.1f} s")
    for name in ("sptrsv_level_scatter", "sptrsv_level_scatter_batched",
                 "trsm_block_apply", "trsm_block_apply_batched", "spmv_ell",
                 "spmv_ell_batched", "sptrsv_fused", "sptrsv_fused_batched"):
        check(sc["scatter"][name] > 0,
              f"{name} never launched on the scatter path")
    # 3h: the distributed solve on one NCCL rank, and the recurrence
    dp = distributed_phase(torch, dev, rng, L64, scipy_csr, reset_counts, counts)
    path_launches["distributed"] = dp["distributed"]
    path_launches["recurrence"] = dp["recurrence"]
    check(dp["distributed"]["spmv_ell"] > 0 and dp["distributed"]["spmv_ell_batched"] > 0,
          "the rewritten distributed solves never launched b' = E b")
    # 3i: gemma3, RecurrentGemma and qwen1.5 at full width, then the
    # launcher's default
    t0 = time.perf_counter()
    slice2 = [a for a in LM_MODELS if a not in (LM_ARCH, *LM_SLICE3, *LM_SLICE4)]
    for arch in slice2:
        t1 = time.perf_counter()
        families[arch] = lm_family(torch, dev, rng, arch, reset_counts, counts,
                                   flash_cuda, "3i")
        torch.cuda.empty_cache()
        print(f"phase 3i: {arch} in {time.perf_counter() - t1:.1f} s; host "
              f"memory {host_rss_gb():.1f} GB resident")
    path_launches["families"] = {name: sum(families[a]["launches"][name] for a in slice2)
                                 for name in KERNELS}
    lm_launcher(torch, get_config("gemma3-1b"), reset_counts, counts, [], "3i")
    print(f"phase 3i: LM families in {time.perf_counter() - t0:.1f} s; launches "
          f"{json.dumps(path_launches['families'])}")
    # 3j: llama4-scout and arctic (mixture of experts) and xlstm-350m, then
    # the launcher: xlstm-350m at full size, the MoE archs at their smoke
    # size (their full configs do not fit the card)
    t0 = time.perf_counter()
    for arch in LM_SLICE3:
        t1 = time.perf_counter()
        families[arch] = lm_family(torch, dev, rng, arch, reset_counts, counts,
                                   flash_cuda, "3j")
        torch.cuda.empty_cache()
        print(f"phase 3j: {arch} in {time.perf_counter() - t1:.1f} s; host "
              f"memory {host_rss_gb():.1f} GB resident")
    path_launches["slice3"] = {name: sum(families[a]["launches"][name] for a in LM_SLICE3)
                               for name in KERNELS}
    for arch in LM_SLICE3:
        moe = get_config(arch).n_experts > 0
        lm_launcher(torch, smoke_config(arch) if moe else get_config(arch),
                    reset_counts, counts, ["--arch", arch] + (["--smoke"] if moe else []),
                    "3j")
    print(f"phase 3j: MoE and xLSTM in {time.perf_counter() - t0:.1f} s; launches "
          f"{json.dumps(path_launches['slice3'])}")
    # 3k: whisper-medium (encoder-decoder, cross-attention) and paligemma-3b
    # (prefix-LM) at full width and depth, each request with its stub; then
    # the launcher on each
    t0 = time.perf_counter()
    for arch in LM_SLICE4:
        t1 = time.perf_counter()
        families[arch] = lm_family(torch, dev, rng, arch, reset_counts, counts,
                                   flash_cuda, "3k")
        torch.cuda.empty_cache()
        print(f"phase 3k: {arch} in {time.perf_counter() - t1:.1f} s; host "
              f"memory {host_rss_gb():.1f} GB resident")
    path_launches["slice4"] = {name: sum(families[a]["launches"][name] for a in LM_SLICE4)
                               for name in KERNELS}
    for arch, serve in LM_SLICE4.items():
        lm_launcher(torch, get_config(arch), reset_counts, counts,
                    ["--arch", arch, *serve["launcher"]], "3k")
    print(f"phase 3k: whisper and paligemma in {time.perf_counter() - t0:.1f} s; "
          f"launches {json.dumps(path_launches['slice4'])}")
    main_launches = {name: sum(p[name] for p in path_launches.values())
                     for name in KERNELS}
    print(f"phase 3: the paths in {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    for name in KERNELS:
        check((main_launches[name] > 0) != (name in OFF_PATH),
              f"{name} launched {main_launches[name]} times on the paths")

    # launches of each kernel in one forward f64 solve, per strategy
    per_solve = {name: {} for name in KERNELS}
    per_solve["flash_attn"] = {f"{arch} prefill": f["attn_layers"]
                               for arch, f in families.items()}
    cases = [(tag, solvers[tag, "float64"][0]) for tag in LEVEL_TAGS]
    cases += [(f"rewrite:{tag}", rw_solvers[tag, "float64"][0]) for tag in VARIANTS]
    cases += [("blocked", blk_solvers["float64"][0])]
    cases += list(sc["keep"].items())
    for m in WIDTHS:
        for tag, s in cases:
            reset_counts()
            s.solve(torch.from_numpy(rng.standard_normal(
                (s.n,) if m == 1 else (s.n, m))).to(dev))
            for name, n in counts().items():
                if n:
                    per_solve[name][tag] = n
    print(f"launches per solve: {json.dumps(per_solve)}")
    # level launches per pallas_level solve: one per segment
    for tag, group in (("pallas_level", solvers), ("pallas_level+coarsen", solvers),
                       ("rewrite:pallas_level", rw_solvers),
                       ("rewrite:pallas_level+coarsen", rw_solvers)):
        for s in group[tag.replace("rewrite:", ""), "float64"]:
            got = {}
            for m in WIDTHS:
                reset_counts()
                s.solve(torch.from_numpy(rng.standard_normal(
                    (s.n,) if m == 1 else (s.n, m))).to(dev))
                c = counts()
                got[m] = c["sptrsv_level" if m == 1 else "sptrsv_level_batched"]
                check(got[m] == s.stats()["segments"],
                      f"{tag} transpose={int(s.transpose)} m={m}: {got[m]} level "
                      f"launches for {s.stats()['segments']} segments")
            print(f"launches per {tag} f64 solve, transpose={int(s.transpose)}: "
                  f"{got[1]} (m=1), {got[WIDTHS[-1]]} (m={WIDTHS[-1]}) for "
                  f"{s.analysis.num_levels} levels, "
                  f"{s.stats()['segments']} segments")
    blk_per_solve = {name: n for name, n in per_solve.items() if "blocked" in n}
    check(blk_per_solve == {"trsm_block_walk": {"blocked": 1},
                            "trsm_block_walk_batched": {"blocked": 1}},
          f"launches per blocked solve: {json.dumps(blk_per_solve)}")
    print("launches per rewritten pallas_level forward f64 solve: "
          f"{per_solve['sptrsv_level'].get('rewrite:pallas_level')} level + "
          f"{per_solve['spmv_ell'].get('rewrite:pallas_level')} SpMV "
          f"(L' segments: {rw_solvers['pallas_level', 'float64'][0].stats()['segments']})")

    # -- phase 4: times -----------------------------------------------------
    fused_cuda.check_waits = False
    solve_ms = {}
    for dt in mats:
        for m in WIDTHS:
            b = torch.from_numpy(rng.standard_normal(
                (L64.n,) if m == 1 else (L64.n, m))).to(dev, getattr(torch, dt))
            for tag in VARIANTS:
                for s in solvers[tag, dt]:
                    if runs(tag, s, m):
                        # phase 3 ran every one of these solves already
                        ms = time_ms(torch, lambda: s.solve(b), warm=False)
                        solve_ms[tag, dt, m, s.transpose] = ms[0]
                        print(f"phase 4: solve {tag:29s} {dt} m={m:2d} transpose="
                              f"{int(s.transpose)}: {fmt_ms(ms)}")
                for s in rw_solvers[tag, dt]:
                    if runs(tag, s, m):
                        ms = time_ms(torch, lambda: s.solve(b), warm=False)
                        solve_ms[f"rewrite:{tag}", dt, m, s.transpose] = ms[0]
                        print(f"phase 4: solve rewrite:{tag:21s} {dt} m={m:2d} "
                              f"transpose={int(s.transpose)}: {fmt_ms(ms)}")
            bb = torch.from_numpy(rng.standard_normal(
                (BAND_N,) if m == 1 else (BAND_N, m))).to(dev, getattr(torch, dt))
            for s in blk_solvers[dt]:
                ms = time_ms(torch, lambda: s.solve(bb), warm=False)
                print(f"phase 4: solve {'blocked (band)':29s} {dt} m={m:2d} "
                      f"transpose={int(s.transpose)}: {fmt_ms(ms)}")
            bw = torch.from_numpy(rng.standard_normal(
                (WIDE_BAND_N,) if m == 1 else (WIDE_BAND_N, m))).to(dev, getattr(torch, dt))
            for s in wide_solvers[dt]:
                ms = time_ms(torch, lambda: s.solve(bw), warm=False)
                print(f"phase 4: solve {'blocked (wide band)':29s} {dt} m={m:2d} "
                      f"transpose={int(s.transpose)}: {fmt_ms(ms)}")

    # auto's pick (timed in phase 3e) beside the fastest strategy measured
    # above: a finding, not a gate
    for (what, transpose, m), (pick, ms) in auto_times.items():
        timed = {k[0]: v for k, v in solve_ms.items()
                 if k[1:] == ("float64", m, transpose)}
        best = min(timed, key=timed.get)
        print(f"phase 4: solve auto ({what}) -> {pick} f64 m={m:2d} transpose="
              f"{int(transpose)}: {fmt_ms(ms)}; fastest measured {best} "
              f"{timed[best]:.4f} ms")

    b1 = torch.from_numpy(rng.standard_normal(L64.n)).to(dev)
    for tag, s in (("pallas_level", solvers["pallas_level", "float64"][0]),
                   ("pallas_level+coarsen", solvers["pallas_level+coarsen", "float64"][0]),
                   ("pallas_level+coarsen", solvers["pallas_level+coarsen", "float64"][1]),
                   ("pallas_fused", solvers["pallas_fused", "float64"][0]),
                   ("pallas_fused", solvers["pallas_fused", "float64"][1]),
                   ("levelset", solvers["levelset", "float64"][0]),
                   ("rewrite:pallas_level", rw_solvers["pallas_level", "float64"][0]),
                   ("rewrite:pallas_fused", rw_solvers["pallas_fused", "float64"][0])):
        print(f"phase 4: profile {tag} f64 m=1 "
              f"{'transpose' if s.transpose else 'forward'}: "
              + device_busy(torch, lambda: s.solve(b1)))
    for m in WIDTHS:
        bb1 = torch.from_numpy(rng.standard_normal((BAND_N,) if m == 1 else (BAND_N, m))).to(dev)
        print(f"phase 4: profile blocked (band) f64 m={m} forward: "
              + device_busy(torch, lambda: blk_solvers["float64"][0].solve(bb1)))

    dt, L, tdt = "float64", L64, torch.float64
    _, vals0, _, lay = make_packed_solver(fwd.schedule, device="cuda")
    ltable = level_table(lay, dev)
    cols = torch.from_numpy(lay.cols_flat).to(dev)
    perm = torch.from_numpy(lay.perm).to(dev)
    n_x = -(-lay.n_pad // 128) * 128
    flay = build_layout(fwd.schedule)
    fcols = torch.from_numpy(flay.cols).to(dev)
    fvals = torch.from_numpy(flay.vals).to(dev)
    fdiag = torch.from_numpy(flay.diag).to(dev)
    spans = torch.tensor(flay.spans, dtype=torch.int32, device=dev)
    ftable = fused_table(flay, dev)
    perm_rows = torch.from_numpy(flay.perm_rows.astype(np.int64)).to(dev)
    A_csr = torch.sparse_csr_tensor(
        torch.from_numpy(L.indptr), torch.from_numpy(L.indices),
        torch.from_numpy(L.data), size=L.shape, device=dev)
    # the SpMV at the rewrite's shape: E of the forward rewrite
    E = rw_solvers["levelset", dt][0].rewrite_result.E
    ell = build_ell(E)
    ecols = device_cols(ell.cols, E.n, dev)
    ecols64 = ecols.long()
    evals = torch.from_numpy(ell.vals).to(dev)
    elen = device_row_len(E.row_nnz(), ell.cols, dev)
    E_csr = torch.sparse_csr_tensor(
        torch.from_numpy(E.indptr), torch.from_numpy(E.indices),
        torch.from_numpy(E.data), size=E.shape, device=dev)
    print(f"phase 4: E of the forward rewrite: {E.nnz} nonzeros over {E.n} "
          f"rows; its ELL layout holds {ell.K} x {E.n} = {ell.K * E.n} slots "
          f"({ell.K * E.n / E.nnz:.1f}x)")
    # the block applies of one blocked forward solve, as the path issues them
    blay = build_packed_blocked_layout(blk_solvers[dt][0].block_schedule)
    dinv_all = torch.from_numpy(pack_blocked_values(blay, band64.data)[1]).to(dev)
    seg_dinv = [dinv_all[s.dinv_off: s.dinv_off + s.B * s.T * s.T].view(s.B, s.T, s.T)
                for s in blay.segments]
    shapes = [(s.B, s.T) for s in blay.segments]
    print(f"phase 4: the band's blocked forward solve applies {len(seg_dinv)} "
          f"segments of (B, T) = {sorted(set(shapes))}")
    # the blocked walk of one band solve, as the path launches it
    wtable = make_walk_table(walk_geometry(blay), [g.lane_idx for g in blay.segments], dev)
    wcols = device_cols(blay.cols_flat, blay.n, dev)
    wcols64 = wcols.long()
    wvals = torch.from_numpy(pack_blocked_values(blay, band64.data)[0]).to(dev)
    band_csr = torch.sparse_csr_tensor(
        torch.from_numpy(band64.indptr), torch.from_numpy(band64.indices),
        torch.from_numpy(band64.data), size=band64.shape, device=dev)
    report = []

    # the single-RHS walk on the transpose layout (ELL width 1,975), and
    # what its wrapper adds around each launch: x̂'s fill and the scratch's
    # zeroing before, the error word's read after
    tlay = build_layout(solvers["pallas_level", dt][1].schedule)
    ttable = fused_table(tlay, dev)
    tcols, tvals, tdiag = (torch.from_numpy(a).to(dev)
                           for a in (tlay.cols, tlay.vals, tlay.diag))
    bT = torch.from_numpy(rng.standard_normal((L.n, 1))).to(dev)
    tbl = torch.cat([bT[:, 0], bT.new_zeros(1)]).index_select(
        0, torch.from_numpy(tlay.perm_rows.astype(np.int64)).to(dev))
    LT = L.transpose()
    LT_csr = torch.sparse_csr_tensor(
        torch.from_numpy(LT.indptr), torch.from_numpy(LT.indices),
        torch.from_numpy(LT.data), size=LT.shape, device=dev)
    t_ms = time_ms(torch, lambda: fused_cuda.fused_solve(tbl, tcols, tvals, tdiag,
                                                         table=ttable))
    t_plain = time_ms(torch, lambda: fused_solve_ref(tbl, tcols, tvals, tdiag,
                                                     chunk=tlay.chunk))
    t_bound = solve_bound_ms(L, 1, dt)
    bits, pending = fused_cuda.PENDING[tdt]
    fill_ms = time_ms(torch, lambda: (
        torch.full((flay.n_pad,), pending, dtype=bits, device=dev),
        torch.zeros(2, dtype=torch.int32, device=dev)))
    word = torch.zeros(2, dtype=torch.int32, device=dev)
    read_ms = time_ms(torch, lambda: int(word[1]))
    print(f"phase 4: sptrsv_fused walk f64 m=1: grid {fused_cuda.walk_grid(tdt)} "
          f"blocks x 256 threads; forward {ftable.num_groups} groups "
          f"({ftable.num_real} of real rows), transpose {ttable.num_groups} "
          f"({ttable.num_real}); around each launch: x̂ fill and scratch "
          f"zeroing {fmt_ms(fill_ms)}, the error word's read {fmt_ms(read_ms)}")
    del tlay, ttable

    def row(name, ms, plain_ms, bound, lib_ms, extra=None):
        print(f"phase 4: kernel {name:24s} f64: {fmt_ms(ms)} per solve "
              f"({json.dumps(per_solve[name])} launches), plain "
              f"{fmt_ms(plain_ms)}, bound {bound[0]:.6f} ms ({bound[1]}), "
              f"library {'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'}")
        source, replaces = KERNELS[name]
        report.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": main_launches[name],
            "launches_per_solve": per_solve[name],
            "max_abs_err": kernel_err[name, dt], "ms": ms[0],
            "ms_min_max": [ms[1], ms[2]], "plain_ms": plain_ms[0],
            "bound_ms": bound[0], "bound_by": bound[1], "library_ms": lib_ms,
            **(extra or {})})

    def library(what, fn):
        try:
            return time_ms(torch, fn)[0]
        except (RuntimeError, NotImplementedError, TypeError) as err:
            print(f"library: {what} unavailable: {err}")
            return None

    # the scatter level step on lung2's widest forward wavefront (K x R_pad)
    sfn = level_ops.make_solver(fwd.schedule, device="cuda")
    shost = sfn.table.host
    si = int(np.argmax(shost[:, 0] * shost[:, 1]))
    one = make_scatter_table(shost[si: si + 1], L.n)
    sK, sRp, svo, sdo = (int(v) for v in shost[si])
    srows, scols, svals, sdiag = sfn.buffers
    srows64, scols64 = srows.long(), scols.long()
    s_real = int((svals[svo: svo + sK * sRp] != 0).sum())
    s_rows = int((srows[sdo: sdo + sRp] < L.n).sum())
    print(f"phase 4: scatter level step: lung2's widest forward wavefront, "
          f"K={sK} R_pad={sRp}, {s_rows} rows, {s_real} entries")
    for m in WIDTHS:
        b = torch.from_numpy(rng.standard_normal((L.n, m))).to(dev)
        bv = b[:, 0].contiguous() if m == 1 else b
        sx = torch.zeros((sfn.n_pad,) + tuple(bv.shape[1:]), dtype=tdt, device=dev)
        sb = torch.cat([bv, bv.new_zeros((1,) + tuple(bv.shape[1:]))])
        row("sptrsv_level_scatter" if m == 1 else "sptrsv_level_scatter_batched",
            time_ms(torch, lambda: level_cuda.level_scatter(
                sx, sb, srows, scols, svals, sdiag, one)),
            time_ms(torch, lambda: level_scatter_ref(
                sx, sb, srows64, scols64, svals, sdiag, one)),
            scatter_step_bound_ms(s_real, s_rows, m, dt), None)
        bhat = permute_rhs(bv, perm, lay.n_pad)
        x = torch.zeros((n_x,) + tuple(bv.shape[1:]), dtype=tdt, device=dev)
        bl = torch.cat([bv, bv.new_zeros((1,) + tuple(bv.shape[1:]))]
                       ).index_select(0, perm_rows)
        lib_ms = library("torch.triangular_solve on sparse CSR",
                         lambda: torch.triangular_solve(b, A_csr, upper=False))
        bound = solve_bound_ms(L, m, dt)
        row("sptrsv_level" if m == 1 else "sptrsv_level_batched",
            time_ms(torch, lambda: level_cuda.level_walk(
                x, bhat, cols, vals0[0], vals0[1], ltable)),
            time_ms(torch, lambda: level_walk_ref(
                x, bhat, cols, vals0[0], vals0[1], ltable)), bound, lib_ms)
        if m > 1:
            print(f"phase 4: sptrsv_fused_batched: one cooperative launch of "
                  f"{fused_cuda.batched_grid(tdt)} blocks x 1024 threads on "
                  f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs, "
                  f"{len(flay.spans) - 1} grid barriers per solve")
        extra = None
        if m > 1:
            # the transpose batch (phase 4's pallas_fused solve, when it ran)
            # beside its bound and the library's solve of the same m RHS
            bT_m = torch.from_numpy(rng.standard_normal((L.n, m))).to(dev)
            tb_lib = library(f"torch.triangular_solve on the transpose's CSR, m={m}",
                             lambda: torch.triangular_solve(bT_m, LT_csr, upper=True))
            tb_ms = solve_ms.get(("pallas_fused", dt, m, True))
            print(f"phase 4: kernel sptrsv_fused_batched transpose f64 m={m}: "
                  f"{'not run' if tb_ms is None else f'{tb_ms:.4f} ms'} per solve, "
                  f"bound {bound[0]:.6f} ms ({bound[1]}), library "
                  f"{'n/a' if tb_lib is None else f'{tb_lib:.4f} ms'}")
            extra = {"transpose": {"ms": tb_ms, "bound_ms": bound[0],
                                   "bound_by": bound[1], "library_ms": tb_lib}}
        if m == 1:
            t_lib = library("torch.triangular_solve on the transpose's CSR",
                            lambda: torch.triangular_solve(bT, LT_csr, upper=True))
            print(f"phase 4: kernel sptrsv_fused transpose f64: {fmt_ms(t_ms)} per "
                  f"solve, plain {fmt_ms(t_plain)}, bound {t_bound[0]:.6f} ms "
                  f"({t_bound[1]}), library "
                  f"{'n/a' if t_lib is None else f'{t_lib:.4f} ms'}")
            fused_cuda.check_waits = True
            checked = time_ms(torch, lambda: fused_cuda.fused_solve(
                bl, fcols, fvals, fdiag, spans, ftable))
            fused_cuda.check_waits = False
            print(f"phase 4: sptrsv_fused f64 with the error word read after "
                  f"each launch: {fmt_ms(checked)} per solve")
            extra = {"transpose": {
                "ms": t_ms[0], "ms_min_max": [t_ms[1], t_ms[2]],
                "plain_ms": t_plain[0], "bound_ms": t_bound[0],
                "bound_by": t_bound[1], "library_ms": t_lib},
                "fill_ms": fill_ms[0], "error_read_ms": read_ms[0],
                "checked_ms": checked[0]}
        row("sptrsv_fused" if m == 1 else "sptrsv_fused_batched",
            time_ms(torch, lambda: fused_cuda.fused_solve(bl, fcols, fvals, fdiag,
                                                          spans, ftable)),
            time_ms(torch, lambda: fused_solve_ref(bl, fcols, fvals, fdiag,
                                                   chunk=flay.chunk)), bound, lib_ms,
            extra)
        print(f"phase 4: spmv over all K slots (no row lengths) m={m:2d}: "
              f"{fmt_ms(time_ms(torch, lambda: spmv_cuda.spmv(bv, ecols, evals)))}")
        row("spmv_ell" if m == 1 else "spmv_ell_batched",
            time_ms(torch, lambda: spmv_cuda.spmv(bv, ecols, evals, elen)),
            time_ms(torch, lambda: spmv_ref(bv, ecols64, evals)),
            spmv_bound_ms(E, m, dt),
            library("torch.sparse.mm on a CSR E", lambda: torch.sparse.mm(E_csr, b)))
        rhs = [torch.from_numpy(rng.standard_normal(
            (B_, T_) if m == 1 else (B_, T_, m))).to(dev) for B_, T_ in shapes]

        def loop(fn, _rhs=rhs):
            for d, r in zip(seg_dinv, _rhs):
                fn(d, r)

        rhs3 = [r if m > 1 else r[..., None] for r in rhs]
        bmm_ms = library("torch.bmm per segment", lambda: loop(torch.bmm, rhs3))
        row("trsm_block_apply" if m == 1 else "trsm_block_apply_batched",
            time_ms(torch, lambda: loop(trsm_cuda.block_apply)),
            time_ms(torch, lambda: loop(block_apply_ref)),
            block_apply_bound_ms(shapes, m, dt), bmm_ms)
        bw = torch.from_numpy(rng.standard_normal((BAND_N,) if m == 1 else (BAND_N, m))).to(dev)
        xw, xw_ref = torch.zeros_like(bw), torch.zeros_like(bw)
        wname = "trsm_block_walk" if m == 1 else "trsm_block_walk_batched"
        wms = time_ms(torch, lambda: trsm_cuda.blocked_walk(xw, bw, wcols, wvals,
                                                            dinv_all, wtable))
        print(f"phase 4: {wname} m={m:2d}: {json.dumps(trsm_cuda.walk_config(wtable, m, tdt))}, "
              f"{wms[0] / len(blay.segments) * 1e3:.3f} us per segment; "
              f"torch.bmm per segment {'n/a' if bmm_ms is None else f'{bmm_ms:.4f} ms'}")
        bw2 = bw if m > 1 else bw[:, None]
        row(wname, wms,
            time_ms(torch, lambda: blocked_walk_ref(xw_ref, bw, wcols64, wvals,
                                                    dinv_all, wtable)),
            walk_bound_ms(blay, m, dt),
            library("torch.triangular_solve on the band's CSR",
                    lambda: torch.triangular_solve(bw2, band_csr, upper=False)))
        # one launch over a synthetic batch, off the path: the kernel's rate
        # when a launch holds enough work to fill the card
        dsyn = torch.from_numpy(rng.standard_normal((512, 64, 64))).to(dev)
        rsyn = torch.from_numpy(rng.standard_normal(
            (512, 64) if m == 1 else (512, 64, m))).to(dev)
        rsyn3 = rsyn if m > 1 else rsyn[..., None]
        bnd = block_apply_bound_ms([(512, 64)], m, dt)
        print(f"phase 4: block apply (512, 64, 64) f64 m={m:2d}: kernel "
              f"{fmt_ms(time_ms(torch, lambda: trsm_cuda.block_apply(dsyn, rsyn)))}, "
              f"plain {fmt_ms(time_ms(torch, lambda: block_apply_ref(dsyn, rsyn)))}, "
              f"torch.bmm {fmt_ms(time_ms(torch, lambda: torch.bmm(dsyn, rsyn3)))}, "
              f"bound {bnd[0]:.6f} ms ({bnd[1]})")
    # the level walk on lung2's other tables of the paths, f64
    level_tables = {}
    for what, sched in (
            ("forward coarsened", coarsen_schedule(fwd.schedule)),
            ("transpose", solvers["pallas_level", dt][1].schedule),
            ("transpose coarsened",
             coarsen_schedule(solvers["pallas_level", dt][1].schedule))):
        _, v0, _, tl = make_packed_solver(sched, device="cuda")
        level_tables[what] = (tl, level_table(tl, dev),
                              torch.from_numpy(tl.cols_flat).to(dev), v0)
    for m in WIDTHS:
        for what, (tl, tt, tc, v0) in level_tables.items():
            shape = (-(-tl.n_pad // 128) * 128,) + (() if m == 1 else (m,))
            xt = torch.zeros(shape, dtype=tdt, device=dev)
            bt = torch.from_numpy(rng.standard_normal(shape)).to(dev)
            kt = time_ms(torch, lambda: level_cuda.level_walk(
                xt, bt, tc, v0[0], v0[1], tt))
            pt = time_ms(torch, lambda: level_walk_ref(xt, bt, tc, v0[0], v0[1], tt))
            print(f"phase 4: level walk lung2 {what} f64 m={m:2d}: {fmt_ms(kt)} "
                  f"for {tt.num_segments} launches {json.dumps(tt.kinds())} "
                  f"({kt[0] / tt.num_segments * 1e3:.3f} us per launch); plain "
                  f"{fmt_ms(pt)}")
    del level_tables

    print(f"phase 4: launches per solve and the SpTRSV times in "
          f"{time.perf_counter() - t_phase:.1f} s")
    # the flash kernel at granite's prefill shape, then at gemma3-12b's with
    # its softcap and without, arctic's, and the masks of phase 3k
    t0 = time.perf_counter()
    fl = flash_times(torch, dev, rng, "granite prefill", FLASH_CASES["granite prefill"],
                     flash_cuda, gqa_attention_ref)
    shape = FLASH_CASES["gemma3-12b prefill"]
    capped, uncapped = (flash_times(torch, dev, rng, f"gemma3-12b prefill{tag}", sh,
                                    flash_cuda, gqa_attention_ref)
                        for tag, sh in (("", shape), (" uncapped", shape[:-1] + (0.0,))))
    g7 = flash_times(torch, dev, rng, "arctic prefill", FLASH_CASES["arctic prefill"],
                     flash_cuda, gqa_attention_ref)
    masks = {}
    for what, (B, Sq, Sk, Hq, Hkv, hd, causal, prefix) in FLASH_MASK_CASES.items():
        masks[what] = flash_times(torch, dev, rng, what, (B, Sq, Hq, Hkv, hd, 0, 0.0),
                                  flash_cuda, gqa_attention_ref, Sk=Sk, causal=causal,
                                  prefix_len=prefix)
    report.append({
        "name": "flash_attn", "route": "cuda", "source": KERNELS["flash_attn"][0],
        "replaces": KERNELS["flash_attn"][1],
        "launches": main_launches["flash_attn"],
        "launches_per_solve": per_solve["flash_attn"],
        "max_abs_err": kernel_err["flash_attn", "bfloat16"], "ms": fl["ms"][0],
        "ms_min_max": list(fl["ms"][1:]), "plain_ms": fl["plain"][0],
        "bound_ms": fl["bound"][0], "bound_by": fl["bound"][1],
        "library_ms": fl["library_ms"],
        "softcap_case": {
            "shape": list(shape[:5]), "softcap": shape[-1], "ms": capped["ms"][0],
            "plain_ms": capped["plain"][0], "bound_ms": capped["bound"][0],
            "bound_by": capped["bound"][1], "library_ms": capped["library_ms"],
            "ms_uncapped": uncapped["ms"][0],
            "library_ms_uncapped": uncapped["library_ms"]},
        "group7_case": {
            "shape": list(FLASH_CASES["arctic prefill"][:5]), "ms": g7["ms"][0],
            "plain_ms": g7["plain"][0], "bound_ms": g7["bound"][0],
            "bound_by": g7["bound"][1], "library_ms": g7["library_ms"]},
        "mask_cases": {
            what: {"shape": list(FLASH_MASK_CASES[what][:6]),
                   "causal": FLASH_MASK_CASES[what][6],
                   "prefix_len": FLASH_MASK_CASES[what][7], "ms": t["ms"][0],
                   "plain_ms": t["plain"][0], "bound_ms": t["bound"][0],
                   "bound_by": t["bound"][1], "library_ms": t["library_ms"]}
            for what, t in masks.items()}})
    lm_launcher(torch, get_config(LM_ARCH), reset_counts, counts,
                ["--arch", LM_ARCH], "4d")
    print(f"phase 4d: LM times and launcher in {time.perf_counter() - t0:.1f} s")
    report.sort(key=lambda r: list(KERNELS).index(r["name"]))

    print(f"run: {time.perf_counter() - t_start:.1f} s after the card check")
    print(f"card: {card}")
    print(json.dumps({"kernels": report}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
