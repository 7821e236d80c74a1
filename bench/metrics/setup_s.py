"""setup_s: process start to the start of the window (imports, CUDA
context, kernels from the build cache, weights from the seed, warm-up)."""


def read(rec):
    return rec["setup_s"]
