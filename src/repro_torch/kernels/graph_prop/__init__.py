"""Fused Enel graph propagation (eqs. 6-7): CUDA kernel, wrapper and plain
version."""
