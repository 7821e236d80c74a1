"""Config dataclasses for architectures and input shapes.

Counterpart of ``repro.configs.base``: the same dataclasses with the same
fields and defaults, so a configuration of either package compares equal
field for field.  Every architecture has one ``<arch>.py`` in this package
exporting ``CONFIG`` (the published configuration).  :func:`smoke_config`
derives the reduced variant the CPU tests run.  Several fields are knobs of
the reference's compiled path (``remat``, ``scan_layers``, ``use_pallas``,
``seq_parallel_residual``, ...); they are kept as data and the port reads
none of them.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, replace
from typing import Tuple


@dataclass(frozen=True)
class ModelConfig:
    """Architecture description. All LM-family archs share this schema."""

    name: str
    family: str                      # dense | moe | audio | vlm | hybrid | ssm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab_size: int                  # padded for sharding (multiple of 128)
    raw_vocab_size: int              # published value; ids >= raw are masked

    # --- attention flavour ------------------------------------------------
    rope_theta: float = 10_000.0
    sliding_window: int = 0          # >0: width of local attention layers
    local_global_period: int = 0     # p: (p-1) local layers then 1 global
    attn_logit_softcap: float = 0.0  # gemma2-style tanh cap on attn logits
    final_logit_softcap: float = 0.0
    qk_norm: bool = False            # qwen3 / gemma3 RMSNorm on q,k
    qkv_bias: bool = False           # qwen2.5
    tie_embeddings: bool = False
    embed_scale: bool = False        # gemma: scale embeddings by sqrt(d_model)
    abs_positions: bool = False      # whisper: sinusoidal absolute positions

    # --- MoE ----------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    dense_residual: bool = False     # arctic: dense FFN in parallel with MoE
    moe_period: int = 1              # MoE applied at layers i % period == offset
    moe_offset: int = 0
    capacity_factor: float = 1.25

    # --- hybrid (jamba) -------------------------------------------------------
    moe_group: int = 1024            # routing-group tokens

    # --- hybrid (jamba) -------------------------------------------------------
    attn_period: int = 0             # 0: all-attention; else 1 attn per period
    attn_index: int = 0              # position of attn layer within the period
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2

    # --- ssm (xlstm) ----------------------------------------------------------
    slstm_period: int = 0            # 0: none; else 1 sLSTM per period
    slstm_index: int = 0

    # --- encoder-decoder (whisper) ---------------------------------------------
    enc_layers: int = 0
    enc_frames: int = 1500           # stub frontend emits this many frame embeddings

    # --- vlm (pixtral) ----------------------------------------------------------
    n_patches: int = 0               # stub frontend emits this many patch embeddings

    # --- numerics / perf knobs ---------------------------------------------------
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    opt_dtype: str = "float32"       # Adam moment dtype (arctic: bfloat16)
    norm_eps: float = 1e-6
    remat: str = "full"              # none | full
    scan_layers: bool = True
    grad_accum: int = 1              # gradient accumulation steps
    grad_accum_dtype: str = "float32"
    seq_parallel_residual: bool = False  # Megatron-SP residual sharding
    rope_upcast: bool = False        # f32 rope application (baseline variant)
    moe_combine_f32: bool = False    # f32 combine tensor (baseline variant)
    ssm_io_f32: bool = False         # f32 sLSTM/mLSTM input projections
                                     # (baseline variant; cell math stays f32)
    head_pad_to: int = 0             # pad n_heads up (inert padded heads)
    use_pallas: bool = False         # the reference's kernel switch
    max_position: int = 1 << 20

    # ------------------------------------------------------------------ helpers
    @property
    def layer_period(self) -> int:
        """Static period of the layer pattern (the reference scans groups of it)."""
        p = 1
        for cand in (self.local_global_period, self.attn_period,
                     self.slstm_period, self.moe_period):
            if cand and cand > p:
                p = cand
        return p

    @property
    def n_groups(self) -> int:
        return self.n_layers // self.layer_period

    @property
    def tail_layers(self) -> int:
        return self.n_layers - self.n_groups * self.layer_period

    @property
    def q_hidden(self) -> int:
        return self.n_heads * self.d_head

    @property
    def kv_hidden(self) -> int:
        return self.n_kv_heads * self.d_head

    def layer_kind(self, i: int) -> str:
        """Mixer kind at absolute layer index i: attn|attn_local|mamba|mlstm|slstm."""
        if self.family == "ssm":
            return "slstm" if (self.slstm_period and
                               i % self.slstm_period == self.slstm_index) else "mlstm"
        if self.attn_period:
            return ("attn" if i % self.attn_period == self.attn_index else "mamba")
        if self.local_global_period:
            return ("attn" if i % self.local_global_period ==
                    self.local_global_period - 1 else "attn_local")
        if self.sliding_window and not self.local_global_period:
            return "attn_local"
        return "attn"

    def ffn_kind(self, i: int) -> str:
        """FFN kind at layer i: dense | moe | moe+dense | none."""
        if self.family == "ssm":
            return "none"                      # xlstm blocks carry their own expansion
        if self.n_experts and i % self.moe_period == self.moe_offset:
            return "moe+dense" if self.dense_residual else "moe"
        return "dense"

    def has_attention(self) -> bool:
        return self.family != "ssm"

    def attn_layer_indices(self) -> Tuple[int, ...]:
        return tuple(i for i in range(self.n_layers)
                     if self.layer_kind(i) in ("attn", "attn_local"))


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned input shape. ``kind`` picks which step function is lowered."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")
SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """(applicable, reason). long_500k only for sub-quadratic families."""
    if shape.name == "long_500k" and cfg.family not in ("hybrid", "ssm"):
        return False, "full-attention arch: 512k dense-KV decode skipped"
    return True, ""


def pad_to(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


def smoke_config(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests: pattern-preserving."""
    period = cfg.layer_period
    n_layers = max(2 * period, 2)            # >=2 periods of the pattern
    updates = dict(
        name=cfg.name + "-smoke",
        n_layers=n_layers,
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) or 2,
        d_head=16,
        d_ff=96 if cfg.d_ff else 0,
        vocab_size=256,
        raw_vocab_size=251,
        enc_layers=2 if cfg.enc_layers else 0,
        enc_frames=12 if cfg.enc_layers else cfg.enc_frames,
        n_patches=8 if cfg.n_patches else 0,
        mamba_d_state=4,
        remat="none",
        dtype="float32",
        param_dtype="float32",
    )
    if cfg.n_experts:
        updates.update(n_experts=4, top_k=min(cfg.top_k, 2), moe_d_ff=32)
    return replace(cfg, **updates)


def describe(cfg: ModelConfig) -> str:
    fields = dataclasses.asdict(cfg)
    return "\n".join(f"{k}: {v}" for k, v in fields.items())
