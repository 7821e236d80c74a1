"""xLSTM-350M — sLSTM + mLSTM block stack [arXiv:2405.04517].

xLSTM[7:1]: one sLSTM block per period of 8, the rest mLSTM (matrix-memory,
chunkwise-parallel).  d_ff=0: blocks carry their own
projection expansion, there is no separate FFN sublayer.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    d_head=256,
    d_ff=0,
    vocab_size=50304,
    raw_vocab_size=50304,
    slstm_period=8,
    slstm_index=2,
    rope_theta=0.0,
    # f32 input projections (the reference's setting)
    ssm_io_f32=True,
)
