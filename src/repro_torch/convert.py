"""Parameters of the JAX reference -> the port's parameters.

Both take the reference's pytrees with numpy leaves (the caller applies
``np.asarray`` to every leaf) and return the same structure as float32
tensors on ``device``: the layout is already the port's, ``(in, out)``
weights and 1-D biases, so nothing is transposed.
"""
from __future__ import annotations

from typing import Dict, List, Mapping

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


def _tensor(v, dev: torch.device) -> torch.Tensor:
    return torch.tensor(np.array(v, np.float32), device=dev)


def enel_params_from_numpy(tree: Mapping, device: DeviceLike = "cuda"
                           ) -> Dict:
    """{"f1".."f4": [{"w", "b"}, ...], "attn_a"} -> the same of tensors."""
    dev = resolve_device(device)
    out: Dict = {}
    for name, val in tree.items():
        if isinstance(val, (list, tuple)):
            layers: List[Dict[str, torch.Tensor]] = [
                {"w": _tensor(l["w"], dev), "b": _tensor(l["b"], dev)}
                for l in val]
            out[name] = layers
        else:
            out[name] = _tensor(val, dev)
    return out


def autoencoder_params_from_numpy(tree: Mapping, device: DeviceLike = "cuda"
                                  ) -> Dict[str, torch.Tensor]:
    """{"enc_w1", "enc_b1", ...} -> the same of tensors."""
    dev = resolve_device(device)
    return {k: _tensor(v, dev) for k, v in tree.items()}
