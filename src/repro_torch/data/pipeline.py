"""Deterministic host-sharded synthetic token pipeline with prefetch.

Counterpart of ``repro.data.pipeline``, kept as its own numpy copy (the
port imports nothing of the reference): a batch equals the reference's
byte for byte at any ``dp_rank`` / ``dp_size``.

Every (step, dp_rank) pair maps to a unique RNG stream, so any elastic
re-mesh (different DP degree) replays EXACTLY the same global batch order —
a worker that restarts or a job that rescales never skips or repeats data.
Documents are variable-length with EOS separators; targets are next-token.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeConfig


@dataclass(frozen=True)
class DataConfig:
    seed: int = 1234
    mean_doc_len: int = 256
    eos_id: int = 1


def _batch_rng(cfg: DataConfig, step: int, sample: int) -> np.random.RandomState:
    # stable per-(step, global sample index) stream
    return np.random.RandomState((cfg.seed * 1_000_003 + step * 65_537 +
                                  sample) % (2 ** 31 - 1))


def sample_tokens(dcfg: DataConfig, mcfg: ModelConfig, step: int,
                  sample: int, seq_len: int) -> np.ndarray:
    """One sequence of packed synthetic documents."""
    rng = _batch_rng(dcfg, step, sample)
    out = np.empty(seq_len + 1, np.int32)
    pos = 0
    while pos < seq_len + 1:
        dlen = max(8, int(rng.exponential(dcfg.mean_doc_len)))
        dlen = min(dlen, seq_len + 1 - pos)
        # zipf-ish unigram stream over the real vocab
        toks = rng.zipf(1.3, dlen).astype(np.int64) % (mcfg.raw_vocab_size - 2)
        out[pos:pos + dlen] = toks + 2
        pos += dlen
        if pos < seq_len + 1:
            out[pos] = dcfg.eos_id
            pos += 1
    return out


def global_batch(dcfg: DataConfig, mcfg: ModelConfig, shape: ShapeConfig,
                 step: int, *, dp_rank: int = 0, dp_size: int = 1,
                 seq_len: Optional[int] = None) -> Dict[str, np.ndarray]:
    """The dp_rank'th shard of the step's global batch (tokens + targets)."""
    s = seq_len if seq_len is not None else shape.seq_len
    if mcfg.family == "vlm":
        s = s - mcfg.n_patches
    b_global = shape.global_batch
    assert b_global % dp_size == 0
    b_local = b_global // dp_size
    tok = np.stack([
        sample_tokens(dcfg, mcfg, step, dp_rank * b_local + i, s)
        for i in range(b_local)])
    batch = {"tokens": tok[:, :-1], "targets": tok[:, 1:]}
    if mcfg.family == "audio":
        rng = _batch_rng(dcfg, step, 10_000_000 + dp_rank)
        batch["frames"] = rng.randn(b_local, mcfg.enc_frames,
                                    mcfg.d_model).astype(np.float32) * 0.1
    if mcfg.family == "vlm":
        rng = _batch_rng(dcfg, step, 20_000_000 + dp_rank)
        batch["patches"] = rng.randn(b_local, mcfg.n_patches,
                                     mcfg.d_model).astype(np.float32) * 0.1
    return batch


class PrefetchLoader:
    """Background-thread prefetch of the deterministic stream."""

    def __init__(self, dcfg: DataConfig, mcfg: ModelConfig, shape: ShapeConfig,
                 *, start_step: int = 0, dp_rank: int = 0, dp_size: int = 1,
                 depth: int = 2, seq_len: Optional[int] = None):
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step

        def worker():
            step = start_step
            while not self._stop.is_set():
                b = global_batch(dcfg, mcfg, shape, step, dp_rank=dp_rank,
                                 dp_size=dp_size, seq_len=seq_len)
                while not self._stop.is_set():
                    try:
                        self._q.put((step, b), timeout=0.1)
                        break
                    except queue.Full:
                        continue
                step += 1

        self._t = threading.Thread(target=worker, daemon=True)
        self._t.start()

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        return self._q.get()

    def close(self):
        self._stop.set()
