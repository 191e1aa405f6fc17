"""Flash-attention forward: full, causal, prefix-LM or sliding-window
attention with the online softmax, on the ``(B, S, H, hd)`` GQA layout."""
