"""ELL SpMV kernel: ``y = M v`` over a transposed ``(K, n)`` ELL slab."""
