"""Gemma-2 2B — local/global alternating attention, logit softcaps
[arXiv:2408.00118; hf].  Copy of the reference's config."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b",
    family="dense",
    n_layers=26,
    d_model=2304,
    n_heads=8,
    n_kv_heads=4,
    d_head=256,
    d_ff=9216,
    vocab_size=256000,
    raw_vocab_size=256000,
    sliding_window=4096,
    local_global_period=2,   # alternate local, global
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    tie_embeddings=True,
    embed_scale=True,
    grad_accum=2,
    rope_theta=10_000.0,
)
