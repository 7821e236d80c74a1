"""The vectorized simulator's stage recipe over a fleet of jobs: CUDA
kernel, wrapper and plain version."""
