"""Serving launcher: batched request waves against a (reduced) model.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-350m
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \\
        --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch jamba-v0.1-52b --smoke --device cpu

Counterpart of ``repro.launch.serve``.  Weights are random, from a
``torch.Generator`` seeded with ``--seed``; prompts come from
``np.random.RandomState(--seed)``.  Runs on the card unless ``--device cpu``.
A wave of an MoE model (jamba, olmoe, arctic) must pad to at most the
config's ``moe_group`` (1024) tokens or a multiple of it.  The published
jamba-v0.1-52b (about 103 GB of bf16 weights) does not fit one 80 GB card;
``chip_smoke.py`` serves one period of it (8 layers) at full width.
"""
from __future__ import annotations

import argparse


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--waves", type=int, default=2)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=96)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import numpy as np

    from repro_torch.configs import get_config, smoke_config
    from repro_torch.models import init_model
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    params = init_model(cfg, seed=args.seed, device=args.device)
    eng = ServeEngine(cfg, params, max_len=args.max_len, device=args.device)
    rng = np.random.RandomState(args.seed)
    for w in range(args.waves):
        reqs = [Request(prompt=rng.randint(2, cfg.raw_vocab_size,
                                           rng.randint(4, 24)),
                        max_new_tokens=8) for _ in range(args.batch)]
        stats = eng.serve_wave(reqs)
        print(f"[serve] wave {w}: {stats.tokens_out} tokens, "
              f"prefill {stats.prefill_s*1e3:.0f}ms, "
              f"decode {stats.decode_tok_s:.1f} tok/s")


if __name__ == "__main__":
    main()
