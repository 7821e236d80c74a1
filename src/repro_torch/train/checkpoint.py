"""Atomic checkpoints of train states, restored onto any device.

Counterpart of ``repro.train.checkpoint``, with its layout semantics:

  <dir>/step_<N:08d>/
    manifest.json   {"step", "metadata", "leaves": {path -> {file, shape,
                    dtype}}}
    leaf_<i>.bin    one per tree leaf, its raw bytes in row-major order

A checkpoint is written into ``.tmp_step_<N:08d>`` and published with
``os.rename``, so a crash in the middle of a save never leaves a partial
``step_*`` behind.  The reference writes a msgpack manifest and ``.npy``
leaves; the port's machines have neither ``msgpack`` nor ``ml_dtypes``
(numpy's bfloat16), so the manifest is JSON and a leaf is its raw bytes
with its torch dtype in the manifest: a bfloat16 leaf round-trips bit for
bit.  Restore places every leaf on the target ``device``, the port's form of
the reference's ``shardings=`` (a re-mesh at world size 1 restores onto the
same card).
"""
from __future__ import annotations

import json
import os
import shutil
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree
from repro_torch.device import DeviceLike, resolve_device

MANIFEST = "manifest.json"


def _dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r} in a checkpoint manifest")
    return dt


def save_checkpoint(directory: str, step: int, state,
                    metadata: Optional[Dict] = None) -> str:
    """Write every leaf of ``state`` (tensors on any device, or numpy
    arrays) under ``<directory>/step_<step:08d>``; returns that path."""
    base = Path(directory)
    base.mkdir(parents=True, exist_ok=True)
    final = base / f"step_{step:08d}"
    tmp = base / f".tmp_step_{step:08d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    manifest = {"step": step, "metadata": metadata or {}, "leaves": {}}
    for i, (key, leaf) in enumerate(sorted(tree.leaves_with_paths(state))):
        t = torch.as_tensor(leaf).detach().to("cpu").contiguous()
        fname = f"leaf_{i:05d}.bin"
        t.reshape(-1).view(torch.uint8).numpy().tofile(tmp / fname)
        manifest["leaves"][key] = {"file": fname, "shape": list(t.shape),
                                   "dtype": str(t.dtype).split(".")[-1]}
    (tmp / MANIFEST).write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)                         # atomic publish
    return str(final)


def latest_step(directory: str) -> Optional[int]:
    base = Path(directory)
    if not base.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in base.glob("step_*")
             if (p / MANIFEST).exists()]
    return max(steps) if steps else None


def _load_leaf(src: Path, info: Dict, device: torch.device) -> torch.Tensor:
    raw = torch.from_numpy(np.fromfile(src / info["file"], np.uint8))
    t = raw.view(_dtype(info["dtype"])).reshape(info["shape"])
    return t.to(device)


def restore_checkpoint(directory: str, tree_like,
                       step: Optional[int] = None,
                       device: Optional[DeviceLike] = None
                       ) -> Tuple[Any, int, Dict]:
    """Restore into the structure of ``tree_like`` (the latest step unless
    ``step`` is given): (state, step, metadata).  Each leaf keeps its saved
    dtype and lands on ``device``, or, without one, on the device of the
    matching leaf of ``tree_like`` (the CPU for a numpy leaf).

    Raises ``FileNotFoundError`` when there is no checkpoint, ``KeyError``
    when one lacks a leaf of ``tree_like`` and ``ValueError`` when a leaf's
    shape differs."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    src = Path(directory) / f"step_{step:08d}"
    manifest = json.loads((src / MANIFEST).read_text())
    dev = None if device is None else resolve_device(device)
    out = {}
    for key, leaf in tree.leaves_with_paths(tree_like):
        info = manifest["leaves"].get(key)
        if info is None:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        if tuple(info["shape"]) != tuple(np.shape(leaf)):
            raise ValueError(f"shape mismatch for {key}: "
                             f"{tuple(info['shape'])} vs {np.shape(leaf)}")
        target = dev or (leaf.device if isinstance(leaf, torch.Tensor)
                         else torch.device("cpu"))
        out[key] = _load_leaf(src, info, target)
    restored = tree.map_with_paths(lambda key, _: out[key], tree_like)
    return restored, manifest["step"], manifest["metadata"]


def prune_checkpoints(directory: str, keep: int = 3) -> None:
    """Remove all but the newest ``keep`` checkpoints."""
    base = Path(directory)
    steps = sorted(p for p in base.glob("step_*"))
    for p in steps[:-keep]:
        shutil.rmtree(p)
