"""Pixtral-12B — Mistral-Nemo backbone + Pixtral-ViT frontend (STUB)
[hf:mistralai/Pixtral-12B-2409].

The vision frontend is a stub: callers provide
precomputed patch embeddings (batch, n_patches, d_model) that are concatenated
in front of the text token embeddings.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b",
    family="vlm",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=14336,
    vocab_size=131072,
    raw_vocab_size=131072,
    n_patches=1024,          # one 1024-patch image per sequence
    grad_accum=8,
    rope_theta=1_000_000.0,
)
