"""Flash attention for prefill: CUDA kernel, wrapper and plain version."""
