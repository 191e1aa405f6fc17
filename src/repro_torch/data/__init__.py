from .pipeline import SyntheticLM, Batch, make_loader

__all__ = ["SyntheticLM", "Batch", "make_loader"]
