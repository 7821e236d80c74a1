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
bit.  Restore places every leaf on the target ``device``.

On a process group a save streams the tree one leaf at a time: it gathers
the leaf's full tensor (``launch.shardings.full_tensor``, a collective over
its mesh: every rank of the mesh calls the save), rank 0 copies it to the
host and writes it, and the gathered copy is freed before the next leaf,
so no rank ever holds more than one whole leaf beside its shards.  Every
rank of the world then waits at a barrier, so that a restore on any rank
finds the files.  ``restore_checkpoint(..., shardings=, mesh=)`` reads
each leaf on the host, cuts this rank's slice of it there and moves only
that slice to the device (``launch.shardings.from_host``), the reference's
resharding restore; the new mesh may differ from the one that saved.
Without ``shardings`` a restore is as on one device.
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
    """Write every leaf of ``state`` (tensors on any device, ``DTensor``
    objects or numpy arrays) under ``<directory>/step_<step:08d>``;
    returns that path.  On a process group only rank 0 writes, and every rank of the
    world must call it (see the module's docstring)."""
    import torch.distributed as dist
    from repro_torch.launch.shardings import full_tensor
    group = dist.is_available() and dist.is_initialized()
    writer = not group or dist.get_rank() == 0
    base = Path(directory)
    final = base / f"step_{step:08d}"
    tmp = base / f".tmp_step_{step:08d}"
    if writer:
        base.mkdir(parents=True, exist_ok=True)
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
    manifest = {"step": step, "metadata": metadata or {}, "leaves": {}}
    for i, (key, leaf) in enumerate(sorted(tree.leaves_with_paths(state),
                                           key=lambda kv: kv[0])):
        with torch.no_grad():
            full = full_tensor(leaf)              # one leaf at a time
        if writer:
            t = torch.as_tensor(full).detach().to("cpu").contiguous()
            fname = f"leaf_{i:05d}.bin"
            t.reshape(-1).view(torch.uint8).numpy().tofile(tmp / fname)
            manifest["leaves"][key] = {"file": fname,
                                       "shape": list(t.shape),
                                       "dtype": str(t.dtype).split(".")[-1]}
            del t
        del full
    if writer:
        (tmp / MANIFEST).write_text(json.dumps(manifest))
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)                     # atomic publish
    if group:
        dist.barrier()
    return str(final)


def latest_step(directory: str) -> Optional[int]:
    base = Path(directory)
    if not base.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in base.glob("step_*")
             if (p / MANIFEST).exists()]
    return max(steps) if steps else None


def _read_leaf(src: Path, info: Dict) -> torch.Tensor:
    """A leaf's tensor on the host."""
    raw = torch.from_numpy(np.fromfile(src / info["file"], np.uint8))
    return raw.view(_dtype(info["dtype"])).reshape(info["shape"])


def restore_checkpoint(directory: str, tree_like,
                       step: Optional[int] = None,
                       device: Optional[DeviceLike] = None,
                       shardings=None, mesh=None
                       ) -> Tuple[Any, int, Dict]:
    """Restore into the structure of ``tree_like`` (the latest step unless
    ``step`` is given): (state, step, metadata).  Each leaf keeps its saved
    dtype and lands on ``device``, or, without one, on the device of the
    matching leaf of ``tree_like`` (the CPU for a numpy leaf).  With
    ``shardings`` (a tree of ``launch.shardings.PartitionSpec`` like
    ``tree_like``) and ``mesh``, each leaf becomes a ``DTensor`` on
    ``mesh`` placed by its spec, its local slice on ``device`` (without
    one, the mesh's device type); only that slice leaves the host.

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
    specs = None
    if shardings is not None:
        from repro_torch.launch.shardings import from_host
        specs = dict(tree.leaves_with_paths(shardings))
        dev = dev or resolve_device(mesh.device_type)
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
        host = _read_leaf(src, info)
        out[key] = host.to(target) if specs is None else \
            from_host(host, mesh, specs[key], target)
    restored = tree.map_with_paths(lambda key, _: out[key], tree_like)
    return restored, manifest["step"], manifest["metadata"]


def prune_checkpoints(directory: str, keep: int = 3) -> None:
    """Remove all but the newest ``keep`` checkpoints."""
    base = Path(directory)
    steps = sorted(p for p in base.glob("step_*"))
    for p in steps[:-keep]:
        shutil.rmtree(p)
