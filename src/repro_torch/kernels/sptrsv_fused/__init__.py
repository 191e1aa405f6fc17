"""Fused kernel: the whole SpTRSV in one launch."""
