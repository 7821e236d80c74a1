"""Chunkwise mLSTM (xLSTM matrix memory): CUDA kernel, wrapper and plain
version."""
