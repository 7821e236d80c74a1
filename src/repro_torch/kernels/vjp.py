"""The backward of the LM kernels' autograd Functions: the VJP of each op's
plain PyTorch version, recomputed on the saved inputs.

The reference trains through plain ops (its models never call the Pallas
kernels, ``repro/models/attention.py:12``, and none of its LM Pallas
kernels has a VJP), so the forward launches the hand-written kernel and
the backward differentiates the same math in plain ops.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch


def plain_vjp(fn: Callable, inputs: Sequence[torch.Tensor],
              grads: Sequence[Optional[torch.Tensor]],
              needed: Sequence[bool]) -> Tuple[Optional[torch.Tensor], ...]:
    """The VJP of ``fn`` (plain ops) at ``inputs``, recomputed under grad,
    against the output ``grads`` (a ``None`` grad, or an output that does
    not depend on a needed input, takes no part).  Returns
    one gradient per input, ``None`` where ``needed`` is False."""
    with torch.enable_grad():
        live = [t.detach().requires_grad_(need)
                for t, need in zip(inputs, needed)]
        outs = fn(*live)
        outs = outs if isinstance(outs, tuple) else (outs,)
        pairs = [(o, g) for o, g in zip(outs, grads)
                 if g is not None and o.requires_grad]
        wanted = [t for t in live if t.requires_grad]
        got = iter(torch.autograd.grad([o for o, _ in pairs],
                                       wanted, [g for _, g in pairs],
                                       allow_unused=True)
                   if pairs and wanted else ())
    return tuple(next(got) if need else None for need in needed)
