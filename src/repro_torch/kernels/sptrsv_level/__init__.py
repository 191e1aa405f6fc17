"""Level kernel: one SpTRSV wavefront per launch."""
