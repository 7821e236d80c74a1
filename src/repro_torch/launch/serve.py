"""Serving launcher: batched request waves against a (reduced) model.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-350m
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \\
        --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch jamba-v0.1-52b --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch whisper-medium --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch pixtral-12b

Counterpart of ``repro.launch.serve``.  Weights are random, from a
``torch.Generator`` seeded with ``--seed``; prompts come from
``np.random.RandomState(--seed)``.  Runs on the card unless ``--device cpu``.
A wave of an MoE model (jamba, olmoe, arctic) must pad to at most the
config's ``moe_group`` (1024) tokens or a multiple of it.  The published
jamba-v0.1-52b (about 103 GB of bf16 weights) does not fit one 80 GB card;
``chip_smoke.py`` serves one period of it (8 layers) at full width.

whisper-medium and pixtral-12b take their stub frontends' outputs, as
``repro/launch/specs.py:40-43`` describes them: per request frames
(``enc_frames``, d) or patches (``n_patches``, d), in the model's compute
dtype, drawn from the same ``np.random.RandomState(--seed)`` times 0.1 (as
``data/pipeline.py`` draws them).  A vlm's cache holds its patches before
the ``--max-len`` text positions.  (The reference's launcher serves
neither: it passes no frames or patches, and its ``forward`` raises a
``KeyError``.)
"""
from __future__ import annotations

import argparse


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--waves", type=int, default=2)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=96,
                    help="text positions of the cache (a vlm adds its "
                         "n_patches)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from repro_torch.configs import get_config, smoke_config
    from repro_torch.models import frontend_input, init_model
    from repro_torch.models.layers import DTYPES
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    params = init_model(cfg, seed=args.seed, device=args.device)
    fe = frontend_input(cfg)
    eng = ServeEngine(cfg, params, max_len=args.max_len + fe.text_offset,
                      device=args.device)
    rng = np.random.RandomState(args.seed)
    for w in range(args.waves):
        reqs = [Request(prompt=rng.randint(2, cfg.raw_vocab_size,
                                           rng.randint(4, 24)),
                        max_new_tokens=8) for _ in range(args.batch)]
        extras = None
        if fe.name is not None:
            x = rng.randn(args.batch, fe.rows, cfg.d_model).astype(np.float32)
            extras = {fe.name: torch.from_numpy(x * 0.1).to(DTYPES[cfg.dtype])}
        stats = eng.serve_wave(reqs, extras)
        print(f"[serve] wave {w}: {stats.tokens_out} tokens, "
              f"prefill {stats.prefill_s*1e3:.0f}ms, "
              f"decode {stats.decode_tok_s:.1f} tok/s")


if __name__ == "__main__":
    main()
