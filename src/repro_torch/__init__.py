"""PyTorch/CUDA port of the SpTRSV system (graph transformation and
specialized code generation for sparse triangular solve).

The JAX package ``repro`` is the reference; this package runs the same
symbolic analysis on host numpy and executes the solve with torch on an
explicit device: hand-written CUDA kernels for Hopper on ``"cuda"`` (the
default), their plain torch versions on ``"cpu"``.  See
:mod:`repro_torch.core.solver` for the public API.
"""
