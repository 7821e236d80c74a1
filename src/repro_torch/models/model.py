"""Public model API: init / apply / prefill / parameter counts for the
ported architectures.

Counterpart of ``repro.models.model``.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch import tree
from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tfm

init_model = tfm.init_model
frontend_input = tfm.frontend_input
decode_step = tfm.decode_step
init_cache = tfm.init_cache
pad_cache_to = tfm.pad_cache_to


def apply_model(params: Dict, cfg: ModelConfig, batch: Dict
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Train-mode forward: (logits, aux_loss)."""
    logits, aux, _ = tfm.forward(params, cfg, batch, mode="train")
    return logits, aux


def prefill(params: Dict, cfg: ModelConfig, batch: Dict,
            cache_len: Optional[int] = None) -> Tuple[torch.Tensor, Dict]:
    """Prefill forward: (logits, cache), the cache padded to ``cache_len``."""
    logits, _, cache = tfm.forward(params, cfg, batch, mode="prefill")
    if cache_len is not None:
        cache = tfm.pad_cache_to(cache, cfg, cache_len)
    return logits, cache


def param_count(cfg: ModelConfig) -> int:
    """Total parameter count, from an init on the ``meta`` device (nothing
    is allocated)."""
    params = init_model(cfg, device="meta")
    return sum(math.prod(t.shape) for t in tree.leaves(params))


def active_param_count(cfg: ModelConfig) -> int:
    """Params touched per token (MoE: only top_k experts active)."""
    total = param_count(cfg)
    if not cfg.n_experts:
        return total
    n_moe_layers = sum(1 for i in range(cfg.n_layers)
                       if "moe" in cfg.ffn_kind(i))
    expert_params = 3 * cfg.d_model * cfg.moe_d_ff
    inactive = n_moe_layers * expert_params * (cfg.n_experts - cfg.top_k)
    return total - inactive
