"""Snowflake Arctic (480B) — 128-expert top-2 MoE + dense residual
[hf:Snowflake/snowflake-arctic-base].  Copy of the reference's config;
Adam moments are kept in bf16."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_head=128,
    d_ff=4864,               # dense residual FFN width
    moe_d_ff=4864,
    n_experts=128,
    top_k=2,
    dense_residual=True,     # dense FFN in parallel with the MoE
    vocab_size=32000,
    raw_vocab_size=32000,
    rope_theta=10_000.0,
    opt_dtype="bfloat16",
    grad_accum=16,
    grad_accum_dtype="bfloat16",
)
