"""Flash-attention forward: causal / sliding-window attention with the
online softmax, on the ``(B, S, H, hd)`` GQA layout."""
