"""Level kernel: one SpTRSV segment (a wavefront, or a coarsened chain of
them) per launch."""
