"""PyTorch/CUDA port of the Enel reproduction (``src/repro`` is the JAX
reference).  Mirrors ``repro``'s layout; imports torch and numpy only."""
