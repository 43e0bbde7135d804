"""Scripts that measure the port's kernels on a CUDA card."""
