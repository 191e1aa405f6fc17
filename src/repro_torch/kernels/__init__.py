"""Hand-written CUDA kernels for Hopper (sm_90a) and their plain torch
versions.

* ``sptrsv_level``  — one wavefront as gather/FMA/divide over an ELL slab,
                      or a coarsened chain of them, per launch
* ``sptrsv_fused``  — the whole solve in one launch (one thread block walking
                      the wavefront spans with a barrier between them)
* ``spmv_ell``      — ELL SpMV ``y = M v``: the rewrite's ``b' = E b`` and
                      the blocked solve's panel update
* ``trsm_block``    — the blocked solve's batched dense ``Dinv @ rhs``
* ``flash_attn``    — causal / sliding-window attention with the online
                      softmax: the LM's prefill attention

Each package: ``ops.py`` (the wrapper a solve calls: the kernel for CUDA
tensors, the plain version for CPU tensors), ``cuda.py`` (ctypes binding,
argument checks, launch counts) and ``ref.py`` (plain torch).  Sources live
in ``csrc/`` and are compiled by :mod:`.build` on first use.
"""
