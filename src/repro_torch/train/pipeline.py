"""Optional pipeline parallelism: the GPipe schedule over a 1-D ``"stage"``
mesh.

Counterpart of ``repro.train.pipeline``.  Each rank on the mesh's stage dim
runs one stage; microbatches stream through the pipeline with a neighbour
send and receive each tick (``dist.batch_isend_irecv``, the reference's
``ppermute``), and the last stage's outputs are summed over the stage group
(the others contribute zeros), as the reference's ``psum`` does.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.distributed as dist

from repro_torch.device import DeviceLike, resolve_device


def make_stage_params(seed: int, n_stages: int, d: int, *,
                      device: DeviceLike = "cuda") -> Dict[str, torch.Tensor]:
    """Normal weights scaled by 1 / sqrt(d), from a ``torch.Generator``
    seeded with ``seed``; each leaf leads with ``n_stages``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    s = 1.0 / math.sqrt(d)
    return {k: torch.randn((n_stages, d, d), generator=gen, device=dev) * s
            for k in ("w1", "w2")}


def stage_fn(params: Dict[str, torch.Tensor], x: torch.Tensor
             ) -> torch.Tensor:
    return x + torch.tanh(x @ params["w1"]) @ params["w2"]


@torch.no_grad()
def pipelined_forward(params: Dict[str, torch.Tensor], x: torch.Tensor,
                      mesh, axis: str = "stage") -> torch.Tensor:
    """x: (n_micro, b, d) microbatches on every rank; ``params`` leaves lead
    with n_stages (this rank runs stage ``mesh.get_local_rank(axis)``).
    Returns the whole pipeline's output on every rank of the stage group,
    the stages applied in turn."""
    group = mesh.get_group(axis)
    n_stages = mesh.size(mesh.mesh_dim_names.index(axis))
    idx = mesh.get_local_rank(axis)
    peers = [dist.get_global_rank(group, i) for i in range(n_stages)]
    n_micro = x.shape[0]
    ticks = n_micro + n_stages - 1
    local = {k: v[idx] for k, v in params.items()}
    recv = torch.zeros_like(x[0])
    outputs = torch.zeros_like(x)
    for t in range(ticks):
        inp = x[min(max(t, 0), n_micro - 1)] if idx == 0 else recv
        out = stage_fn(local, inp)
        mb_out = t - (n_stages - 1)
        if idx == n_stages - 1 and 0 <= mb_out < n_micro:
            outputs[mb_out] = out
        # ppermute (i -> i + 1): stage 0 receives zeros
        ops = []
        nxt = torch.zeros_like(out)
        if idx < n_stages - 1:
            ops.append(dist.P2POp(dist.isend, out.contiguous(),
                                  peers[idx + 1], group))
        if idx > 0:
            ops.append(dist.P2POp(dist.irecv, nxt, peers[idx - 1], group))
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        recv = nxt
    dist.all_reduce(outputs, group=group)   # non-last stages contribute 0
    return outputs
