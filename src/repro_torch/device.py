"""Device selection shared by the port's entry points."""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike) -> torch.device:
    """``torch.device`` for ``device``; raises if it names CUDA and no card
    is present (entry points never move to the CPU on their own)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} asked for a CUDA card but torch finds "
            "none; pass device='cpu' to run on the CPU")
    return dev
