"""Stand-ins for every model input, with no allocation: tensors on the
``meta`` device.

Counterpart of ``repro.launch.specs``, whose stand-ins are
``jax.ShapeDtypeStruct`` objects.  ``input_specs(cfg, shape)`` gives the
batch for the step that ``shape.kind`` selects; a decode shape also needs the
cache (``cache_specs``) and a train shape the state (``state_specs``).
Shapes are the reference's, the cache and parameters unstacked into the
port's flat list of layers.  Dtypes map as the port's data does: token ids
and the decode position are int64 where the reference's are int32 (as
``train.batch_to_device`` gives them), the optimizer's step count is int64
where the reference's is int32; every other leaf keeps the reference's
dtype (frames and patches bfloat16, the cache bfloat16 with float32
recurrent states).
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from repro_torch import tree
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import init_cache, init_model
from repro_torch.train.optimizer import AdamWConfig, init_opt_state

I64 = torch.int64
BF16 = torch.bfloat16
META = torch.device("meta")


def sds(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def text_len(cfg: ModelConfig, shape: ShapeConfig) -> int:
    if cfg.family == "vlm" and shape.kind in ("train", "prefill"):
        return shape.seq_len - cfg.n_patches
    return shape.seq_len


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict:
    """The batch of the step function ``shape.kind`` selects."""
    b = shape.global_batch
    if shape.kind in ("train", "prefill"):
        s = text_len(cfg, shape)
        batch = {"tokens": sds((b, s), I64)}
        if shape.kind == "train":
            batch["targets"] = sds((b, s), I64)
        if cfg.family == "audio":
            batch["frames"] = sds((b, cfg.enc_frames, cfg.d_model), BF16)
        if cfg.family == "vlm":
            batch["patches"] = sds((b, cfg.n_patches, cfg.d_model), BF16)
        return batch
    # decode: one new token against a seq_len cache
    return {"token": sds((b, 1), I64), "pos": sds((), I64)}


def cache_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict:
    return init_cache(cfg, shape.global_batch, shape.seq_len, BF16,
                      device=META)


def state_specs(cfg: ModelConfig, opt: AdamWConfig) -> Dict:
    params = init_model(cfg, device=META)
    return {"params": params, "opt": init_opt_state(params, cfg.opt_dtype)}


def param_specs(cfg: ModelConfig) -> Dict:
    return init_model(cfg, device=META)


def bytes_of(t) -> int:
    return sum(math.prod(l.shape) * l.element_size()
               for l in tree.leaves(t))
