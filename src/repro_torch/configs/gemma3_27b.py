"""Gemma-3 27B — 5:1 local:global attention, 128k context, qk-norm
[hf:google/gemma-3-1b-pt family scaling]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-27b",
    family="dense",
    n_layers=62,             # 10 full (5L+1G) periods + 2 tail local layers
    d_model=5376,
    n_heads=32,
    n_kv_heads=16,
    d_head=128,
    d_ff=21504,
    vocab_size=262144,
    raw_vocab_size=262144,
    sliding_window=1024,
    local_global_period=6,   # 5 local then 1 global
    qk_norm=True,
    tie_embeddings=True,
    embed_scale=True,
    rope_theta=1_000_000.0,  # global layers; local layers use 10k (attention.py)
    grad_accum=4,
)
