"""A world of spawned processes on one host: each rank initialises the
process group over a ``FileStore`` (no TCP port), runs a function, and
sends back its result.

    results = run_world(fn, 4, store_dir, backend="gloo", timeout=120,
                        args=(...,))

``fn(rank, world, *args)`` runs in every rank after
``init_process_group(backend, store=FileStore(...))``; ``results[r]`` is
rank ``r``'s return value.  The world has a timeout of its own: a rank
that hangs in a collective is killed and :func:`run_world` raises, as it
does when a rank raises (with that rank's traceback).  The group is
destroyed in every rank that gets that far.  Children start with
``spawn``; ``fn`` must be importable by its module's name.

:func:`fake_world` is a world of many ranks inside this one process: a
``"fake"`` process group (torch's ``FakeStore``), whose collectives
return at once without moving data, as one rank of a world of 256 or 512
sees it (the dry run, ``launch.dryrun``, traces a step on meta tensors
in it).
"""
from __future__ import annotations

import os
import time
import traceback
from contextlib import contextmanager
from typing import Any, Callable, List, Sequence


def _child(rank: int, world: int, store: str, backend: str, threads: int,
           fn: Callable, args: Sequence, queue) -> None:
    import torch
    import torch.distributed as dist
    if threads:
        torch.set_num_threads(threads)
    try:
        dist.init_process_group(backend, store=dist.FileStore(store, world),
                                 rank=rank, world_size=world)
        try:
            queue.put((rank, True, fn(rank, world, *args)))
        finally:
            dist.destroy_process_group()
    except Exception:                           # reported to the parent
        queue.put((rank, False, traceback.format_exc()))


def run_world(fn: Callable, world: int, store_dir: str, *,
              backend: str = "gloo", timeout: float = 120.0,
              args: Sequence = (), threads: int = 1) -> List[Any]:
    """Run ``fn`` on ``world`` spawned ranks; their results by rank.  Each
    rank uses ``threads`` intra-op threads (0: torch's default)."""
    import queue as queue_mod

    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    os.makedirs(store_dir, exist_ok=True)
    store = os.path.join(store_dir, f"store_{os.getpid()}_{time.time_ns()}")
    procs = [ctx.Process(target=_child, args=(r, world, store, backend,
                                              threads, fn, tuple(args), q))
             for r in range(world)]
    for p in procs:
        p.start()
    results, errors = {}, {}
    deadline = time.monotonic() + timeout
    try:
        while len(results) + len(errors) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                late = sorted(set(range(world)) - set(results) - set(errors))
                raise TimeoutError(
                    f"a world of {world} ranks ran past {timeout:.0f} s; "
                    f"ranks {late} did not finish")
            try:
                rank, ok, value = q.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                if errors or any(not p.is_alive() and p.exitcode
                                 for p in procs):
                    break
                continue
            (results if ok else errors)[rank] = value
        if errors or len(results) < world:
            msg = "\n".join(f"rank {r}:\n{tb}" for r, tb in sorted(
                errors.items()))
            dead = {r: p.exitcode for r, p in enumerate(procs)
                    if r not in results and r not in errors}
            raise RuntimeError(f"world of {world} failed; ranks without a "
                               f"result (rank: exit code): {dead}\n{msg}")
        for p in procs:
            p.join(timeout=30)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    return [results[r] for r in range(world)]


def fake_store():
    """torch's ``FakeStore`` (importing its module registers the ``"fake"``
    backend); raises naming this torch where it is not there."""
    import torch
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise ImportError(
            f"torch {torch.__version__} has no torch.testing._internal."
            f"distributed.fake_pg.FakeStore, which a fake world needs") from e
    return FakeStore()


@contextmanager
def fake_world(world_size: int, rank: int = 0):
    """A ``"fake"`` process group of ``world_size`` ranks in this process,
    as rank ``rank``; destroyed on the way out, whatever happens."""
    import torch.distributed as dist
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised")
    dist.init_process_group("fake", store=fake_store(), rank=rank,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()
