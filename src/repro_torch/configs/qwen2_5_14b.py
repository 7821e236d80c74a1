"""Qwen2.5-14B — GQA with QKV bias [hf:Qwen/Qwen2.5 family].  Copy of the
reference's config."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-14b",
    family="dense",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_head=128,
    d_ff=13824,
    vocab_size=152064,
    raw_vocab_size=152064,
    qkv_bias=True,
    grad_accum=8,
    rope_theta=1_000_000.0,
)
