"""Training launcher: the train step on the deterministic token stream, with
checkpoints, or the same job under the Enel elastic controller.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
        --smoke --steps 20 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
        --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
        --smoke --steps 8 --seq 32 --batch 8 --elastic-target 60 --device cpu
    PYTHONPATH=src python -m torch.distributed.run --standalone \\
        --nproc-per-node 2 -m repro_torch.launch.train --arch qwen3-0.6b \\
        --smoke --steps 3 --dp 2 --device cpu

Counterpart of ``repro.launch.train``; also the port's form of
``examples/train_lm.py`` (the plain loop) and ``examples/
elastic_training.py`` (``--elastic-target``).  Without ``--smoke`` it runs
the published config.  Weights come from a ``torch.Generator`` seeded with
``--seed``; batches are the reference's (``data.pipeline``): each step
takes rank 0's shard of the global batch split into ``global_batch //
(--batch or 4)`` shards, at most 256 tokens long, as the reference does.
Runs on the card unless ``--device cpu``.

Under ``python -m torch.distributed.run`` (``RANK`` and ``WORLD_SIZE`` in
the environment) it initialises the world, NCCL for the card (each process
on the card of its ``LOCAL_RANK``) and gloo for ``--device cpu``, and
requires ``--dp`` x ``--tp`` x ``--pods`` to equal the world's size.  It
then builds the mesh, the logical rules and the state sharded by
``state_shardings`` (each rank holds its shards), and every step is the
sharded step: each rank computes its rows of that batch, so the losses are
the one-device run's.  Only rank 0 prints.  ``--elastic-target`` runs the
elastic trainer over the world.  Without the launcher's environment every
degree must be 1: one process, one device.
"""
from __future__ import annotations

import argparse
import os
import time


def _init_world(args):
    """(rank, world size) under ``torch.distributed.run``, after
    initialising the process group; (0, None) without its environment."""
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return 0, None
    import torch
    import torch.distributed as dist
    world = int(os.environ["WORLD_SIZE"])
    want = args.dp * args.tp * args.pods
    if args.elastic_target <= 0 and want != world:
        raise ValueError(f"--dp {args.dp} x --tp {args.tp} x --pods "
                         f"{args.pods} is a mesh of {want} ranks; the world "
                         f"has {world} (WORLD_SIZE)")
    if torch.device(args.device).type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", 0))
        torch.cuda.set_device(local)
        args.device = f"cuda:{local}"
        dist.init_process_group("nccl")
    else:
        dist.init_process_group("gloo")
    return dist.get_rank(), world


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--pods", type=int, default=1)
    ap.add_argument("--seq", type=int, default=0, help="override seq len")
    ap.add_argument("--batch", type=int, default=0, help="override batch")
    ap.add_argument("--ckpt", default="checkpoints/train")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--elastic-target", type=float, default=0.0,
                    help=">0: run under the Enel elastic controller")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    rank, world = _init_world(args)
    if world is None and args.dp * args.tp * args.pods > 1:
        raise ValueError(
            f"--dp {args.dp} x --tp {args.tp} x --pods {args.pods} is a mesh "
            f"of {args.dp * args.tp * args.pods} ranks; without "
            "torch.distributed.run the world is one process")
    try:
        _run(args, rank, world)
    finally:
        if world is not None:
            import torch.distributed as dist
            dist.destroy_process_group()


def _run(args, rank: int, world) -> None:
    say = print if rank == 0 else (lambda *a, **k: None)

    import dataclasses

    import torch

    from repro_torch.configs import get_config, get_shape, smoke_config
    from repro_torch.data.pipeline import DataConfig, global_batch
    from repro_torch.launch.mesh import make_mesh, mesh_shape
    from repro_torch.launch.shardings import (logical_rules, shard_tree,
                                              state_shardings)
    from repro_torch.models.sharding import use_rules
    from repro_torch.train.checkpoint import (latest_step,
                                              restore_checkpoint,
                                              save_checkpoint)
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train import (batch_to_device, init_train_state,
                                         make_train_step)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    shape = get_shape(args.shape)
    if args.seq or args.batch:
        shape = dataclasses.replace(
            shape, seq_len=args.seq or shape.seq_len,
            global_batch=args.batch or shape.global_batch)

    if args.elastic_target > 0:
        from repro_torch.train.elastic import ElasticConfig, ElasticTrainer
        ecfg = ElasticConfig(target_runtime=args.elastic_target,
                             n_components=max(1, args.steps // 4),
                             steps_per_component=4,
                             dp_choices=tuple(sorted({1, 2, args.dp})),
                             ckpt_dir=args.ckpt, seed=args.seed)
        res = ElasticTrainer(cfg, shape, ecfg, device=args.device).run()
        say(f"[elastic] {res}")
        return

    opt = AdamWConfig(total_steps=args.steps)
    state = init_train_state(args.seed, cfg, opt, device=args.device)
    mesh = rules = specs = None
    if world is not None:
        mesh = make_mesh(args.dp, args.tp, args.pods,
                         device_type=torch.device(args.device).type)
        rules = logical_rules(cfg, mesh, shape)
        specs = state_shardings(cfg, mesh, state)
        state = shard_tree(state, mesh, specs)
    start = 0
    if args.resume and latest_step(args.ckpt) is not None:
        state, start, _ = restore_checkpoint(args.ckpt, state,
                                             device=args.device,
                                             shardings=specs, mesh=mesh)
        say(f"[train] resumed at step {start}")
    step_fn = make_train_step(cfg, opt)
    dcfg = DataConfig()
    t0 = time.time()
    with use_rules(mesh, rules):
        for i in range(start, args.steps):
            nb = global_batch(dcfg, cfg, shape, i,
                              dp_size=max(1, shape.global_batch //
                                          max(args.batch or 4, 1)),
                              seq_len=min(shape.seq_len, 256))
            state, metrics = step_fn(state, batch_to_device(nb, args.device))
            if i % 5 == 0 or i == args.steps - 1:
                say(f"[train] step {i} loss={float(metrics['loss']):.4f}")
            if (i + 1) % args.ckpt_every == 0:
                save_checkpoint(args.ckpt, i + 1, state)
    where = args.device if mesh is None else \
        f"mesh {mesh_shape(mesh)} of {args.device}"
    say(f"[train] {args.steps - start} steps in {time.time() - t0:.1f}s "
        f"on {where}")


if __name__ == "__main__":
    main()
