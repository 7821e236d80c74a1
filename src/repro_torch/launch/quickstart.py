"""Quickstart: build a reduced architecture, train a few steps, serve a
request wave, and ask Enel for a scale-out recommendation.

    PYTHONPATH=src python -m repro_torch.launch.quickstart \\
        [--arch qwen3-0.6b] [--steps 5] [--device cpu]

The port's twin of ``examples/quickstart.py``, step for step: the smoke
config and its parameter count; ``--steps`` AdamW steps on the
deterministic stream (``TRAIN_4K`` split into shards of 4 rows, 64 tokens
long); a wave of one request for the families the reference serves there
(dense, moe, ssm, hybrid); a toy Enel model fitted from scratch for 128
steps on 24 three-stage graphs, then one ``recommend``.  Weights come from
``torch.Generator`` seeds (the reference draws from ``jax.random``, so the
numbers differ).  Runs on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import numpy as np

    from repro_torch.configs import TRAIN_4K, get_config, smoke_config
    from repro_torch.data.pipeline import DataConfig, global_batch
    from repro_torch.models import param_count
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train import (batch_to_device, init_train_state,
                                         make_train_step)

    dev = args.device
    cfg = smoke_config(get_config(args.arch))
    print(f"arch={args.arch} (reduced: {param_count(cfg):,} params, "
          f"family={cfg.family})")

    # --- train a few steps on the deterministic synthetic stream
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=100)
    state = init_train_state(0, cfg, opt, device=dev)
    step = make_train_step(cfg, opt)
    dcfg = DataConfig()
    for i in range(args.steps):
        batch = batch_to_device(global_batch(
            dcfg, cfg, TRAIN_4K, i, dp_size=TRAIN_4K.global_batch // 4,
            seq_len=64), dev)
        state, metrics = step(state, batch)
        print(f"step {i}: loss={float(metrics['loss']):.3f} "
              f"grad_norm={float(metrics['grad_norm']):.2f}")

    # --- serve a small request wave
    if cfg.family in ("dense", "moe", "ssm", "hybrid"):
        eng = ServeEngine(cfg, state["params"], max_len=64, device=dev)
        reqs = [Request(prompt=np.arange(6) + 2, max_new_tokens=8)]
        stats = eng.serve_wave(reqs)
        print(f"served: {reqs[0].out_tokens} "
              f"({stats.decode_tok_s:.1f} tok/s decode)")

    # --- Enel: one scale-out recommendation on a toy trained model
    from repro_torch.core.graph import CTX_DIM, NodeAttrs, build_graph
    from repro_torch.core.scaling import EnelScaler
    from repro_torch.core.training import EnelTrainer

    rng = np.random.RandomState(0)
    trainer = EnelTrainer(device=dev)
    scaler = EnelScaler(trainer, (4, 36), candidate_stride=4)

    def nodes(k, a, z, observe=True):
        out = []
        for i in range(3):
            ctx = np.tanh(np.random.RandomState(i).randn(CTX_DIM)
                          ).astype(np.float32)
            rt = 30.0 / z + 1.0 if observe else None
            met = np.array([0.5, 1 / z, 0.1, 0.1, 0.0], np.float32) \
                if observe else None
            out.append(NodeAttrs(f"st{i}", ctx, met, a if i == 0 else z, z,
                                 1.0, rt))
        return out

    graphs = []
    for _ in range(6):
        for k in range(4):
            s = int(rng.choice([4, 8, 16, 32]))
            ns = nodes(k, s, s)
            graphs.append(build_graph(ns, [(0, 1), (1, 2)], k))
            scaler.record_component(k, ns, sum(n.runtime for n in ns))
    trainer.fit(graphs, steps=128, from_scratch=True)

    def builder(k, a, z, preds):
        return build_graph(
            nodes(k, a, z, observe=False) + preds,
            [(0, 1), (1, 2)] + [(3 + j, 0) for j in range(len(preds))], k)
    s, total, _ = scaler.recommend(graph_builder=builder, next_comp=1,
                                   n_components=4, elapsed=5.0,
                                   current_scaleout=8, target_runtime=20.0)
    print(f"Enel recommendation: scale-out {s} "
          f"(predicted total {total:.1f}s vs target 20s)")


if __name__ == "__main__":
    main()
