"""Jamba-v0.1 (52B) — Mamba+attention 1:7 interleave, 16-expert top-2 MoE
every other layer [arXiv:2403.19887; hf].

Layer pattern (period 8, scanned 4x): attention at in-period index 4, Mamba
elsewhere; MoE FFN at odd in-period indices, dense FFN at even ones.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=14336,
    moe_d_ff=14336,
    n_experts=16,
    top_k=2,
    moe_period=2,
    moe_offset=1,
    attn_period=8,
    attn_index=4,
    mamba_d_state=16,
    mamba_d_conv=4,
    mamba_expand=2,
    grad_accum=4,
    vocab_size=65536,
    raw_vocab_size=65536,
    rope_theta=0.0,          # jamba attention layers carry no positional encoding
)
