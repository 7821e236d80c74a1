"""Whisper-medium — encoder-decoder audio LM [arXiv:2212.04356].

The conv frontend is a stub: callers provide precomputed frame embeddings
(batch, enc_frames, d_model).  Vocab 51865 is padded to 51968.  Copy of
the reference's config."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="audio",
    n_layers=24,             # decoder layers
    enc_layers=24,
    enc_frames=1500,         # 30 s of audio at 50 Hz after the conv stub
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_head=64,
    d_ff=4096,
    vocab_size=51968,
    raw_vocab_size=51865,
    rope_theta=0.0,          # whisper uses learned/sinusoidal positions, not RoPE
    abs_positions=True,
)
