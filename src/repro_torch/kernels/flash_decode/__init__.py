"""Flash decode against a KV cache: CUDA kernel, wrapper and plain
version."""
