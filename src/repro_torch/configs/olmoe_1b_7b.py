"""OLMoE-1B-7B — 64-expert top-8 MoE LM [arXiv:2409.02060; hf]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_head=128,
    d_ff=0,                  # no dense FFN: every layer is MoE
    moe_d_ff=1024,
    n_experts=64,
    top_k=8,
    vocab_size=50304,
    raw_vocab_size=50304,
    qk_norm=True,            # OLMoE uses QK-Norm
    grad_accum=2,
    rope_theta=10_000.0,
)
