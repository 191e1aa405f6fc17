"""Gradient compression and pipeline parallelism on ``torch.distributed``:
the JAX package's ``distributed`` package, with the collectives that carry
gradients (:mod:`.collectives`) that both, and the expert-parallel MoE,
run on."""
from .compress import CompressionState, compressed_allreduce, make_compressed_grad_fn
from .pipeline import gpipe_stage_fn, make_gpipe

__all__ = ["CompressionState", "compressed_allreduce", "make_compressed_grad_fn",
           "gpipe_stage_fn", "make_gpipe"]
