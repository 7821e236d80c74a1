"""Explicit data-parallel train step with an int8 + error-feedback gradient
all-reduce (``compression.py``).

Counterpart of ``repro.train.dp_step``.  The sharded step
(``train.make_train_step`` on a ``DTensor`` state) reduces gradients as the
parameters' placements ask; this variant takes manual control of the DP
dim so that the gradient all-reduce's payload can be quantized, the trick
that matters when the DP dim spans hosts.  Parameters and moments are
plain tensors, replicated: the same on every rank.  Each rank computes the
loss of its rows of the global batch; the loss and its parts are the mean
over ranks of the local means (the reference's ``pmean``), and so are the
gradients (``all_reduce`` then a division by the group's size, or
:func:`compression.psum_compressed`).  Then the in-place
``optimizer.adamw_update``.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.train.compression import (init_error_state,
                                           psum_compressed_tree)
from repro_torch.train.optimizer import AdamWConfig, adamw_update
from repro_torch.train.train import _value_and_grad, local_rows


def make_dp_train_step(cfg: ModelConfig, opt: AdamWConfig, mesh,
                       axis: str = "data", compress: bool = True):
    """Returns (step_fn, init_extra_state).

    ``step_fn(state, err_state, batch) -> (state, err_state, metrics)``:
    ``batch`` is the global batch, whose leading dim splits over the mesh
    dim ``axis`` (each rank takes its rows); the state is updated in
    place.  A collective: every rank of ``axis`` calls it."""
    group = mesh.get_group(axis)
    n = mesh.size(mesh.mesh_dim_names.index(axis))

    def pmean(t: torch.Tensor) -> torch.Tensor:
        t = t.clone()
        dist.all_reduce(t, group=group)
        return t / torch.tensor(n, dtype=t.dtype, device=t.device)

    def step_fn(state: Dict, err_state, batch: Dict):
        params = state["params"]
        loss, parts, grads = _value_and_grad(
            params, cfg, local_rows(batch, mesh, (axis,)))
        if compress:
            grads, err_state = psum_compressed_tree(grads, err_state, group)
        else:
            grads = [pmean(g) for g in grads]
        names = ["loss", *parts]
        means = pmean(torch.stack([loss, *parts.values()]).float())
        _, _, om = adamw_update(params, grads, state["opt"], opt)
        return state, err_state, {**dict(zip(names, means)), **om}

    def init_extra(params) -> Dict:
        return init_error_state(params)

    return step_fn, init_extra
