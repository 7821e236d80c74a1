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
from repro_torch.models.sharding import seq_split

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
    """Prefill forward: (logits, cache), the cache padded to ``cache_len``.

    On ``DTensor`` parameters under the active logical rules, ``batch`` is
    the global batch (every rank holding it, or ``DTensor`` leaves placed
    on the batch's dims): each rank runs its rows on its shards, and the
    logits come back as a ``DTensor`` over the batch's dims and
    ``"model"`` (the vocabulary, where it splits), the cache as ``DTensor``
    entries placed by ``launch.shardings.cache_shardings``: the reference's
    jitted ``prefill_step`` (``repro/launch/dryrun.py:122-130``), whose
    logits are the last position's of these.  Where ``cache_seq`` splits
    the cache along its sequence, each rank keeps its rows of the cache
    grown to ``cache_len`` (the prompt's length when None), which must
    divide evenly over the split (else ``ValueError``, as the reference's
    ``pjit`` refuses it)."""
    sh = tfm.serving_sharded(params, cfg)
    if sh is not None:
        batch = {k: tfm.local_input(v, sh) for k, v in batch.items()}
    logits, _, cache = tfm.forward(params, cfg, batch, mode="prefill")
    split = seq_split("cache_seq") if sh is not None else None
    if split is not None and tfm.cache_seq_len(cfg, cache):
        cache = tfm.pad_cache_to(
            cache, cfg, cache_len or tfm.cache_seq_len(cfg, cache), split)
    elif cache_len is not None:
        cache = tfm.pad_cache_to(cache, cfg, cache_len)
    if sh is None:
        return logits, cache
    return tfm.place_logits(logits, cfg, sh), tfm.place_cache(cache, cfg, sh)


def next_token(logits) -> torch.Tensor:
    """The greedy next token of each row, (B, 1): the argmax of the last
    position's logits, the lowest index on ties (``jnp.argmax``, as the
    reference's ``serve_step``).  Logits placed as sharded
    :func:`prefill` / ``decode_step`` give them: this rank's columns' max
    and index, then the ranks' compared (the largest value, the lowest
    index among equals); the tokens come back as a ``DTensor`` placed over
    the batch's dims."""
    from torch.distributed.tensor import DTensor
    if not isinstance(logits, DTensor):
        return logits[:, -1].argmax(dim=-1)[:, None]
    from repro_torch.launch.collectives import argmax_over, tp_of
    from repro_torch.launch.shardings import PartitionSpec, as_dtensor
    mesh = logits.device_mesh
    names = tuple(mesh.mesh_dim_names)
    local = logits.to_local()[:, -1]
    tp = tp_of(mesh) if tfm.model_dim(logits) == 2 else None
    idx = local.argmax(dim=-1) if tp is None else argmax_over(local, tp)
    rows = tuple(names[i] for i, p in enumerate(logits.placements)
                 if p.is_shard() and p.dim == 0)
    return as_dtensor(idx[:, None], mesh, PartitionSpec(rows or None, None))


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
