"""Frozen copy of the port's synthetic token stream
(``data/pipeline.py::sample_tokens``): packed documents of Zipf(1.3)
tokens over the real vocabulary, exponential lengths (mean 256, at least
8), EOS between documents.  One stream per (seed, step, sample)."""
from __future__ import annotations

import numpy as np


def _rng(seed: int, step: int, sample: int) -> np.random.RandomState:
    return np.random.RandomState((seed * 1_000_003 + step * 65_537 +
                                  sample) % (2 ** 31 - 1))


def sample_tokens(seed: int, raw_vocab: int, step: int, sample: int,
                  seq_len: int, mean_doc_len: int = 256, eos_id: int = 1,
                  zipf_a: float = 1.3) -> np.ndarray:
    """One sequence of ``seq_len + 1`` packed synthetic tokens."""
    rng = _rng(seed, step, sample)
    out = np.empty(seq_len + 1, np.int32)
    pos = 0
    while pos < seq_len + 1:
        dlen = max(8, int(rng.exponential(mean_doc_len)))
        dlen = min(dlen, seq_len + 1 - pos)
        toks = rng.zipf(zipf_a, dlen).astype(np.int64) % (raw_vocab - 2)
        out[pos:pos + dlen] = toks + 2
        pos += dlen
        if pos < seq_len + 1:
            out[pos] = eos_id
            pos += 1
    return out


def train_batch(seed: int, raw_vocab: int, step: int, batch: int,
                seq_len: int, **kw):
    """(tokens, targets), each (batch, seq_len) int64: rows of the step's
    streams, targets the next tokens."""
    rows = np.stack([sample_tokens(seed, raw_vocab, step, i, seq_len, **kw)
                     for i in range(batch)]).astype(np.int64)
    return rows[:, :-1], rows[:, 1:]


def prompt_tokens(seed: int, raw_vocab: int, wave: int, index: int,
                  length: int, zipf_a: float = 1.3) -> np.ndarray:
    """A prompt of ``length`` Zipf tokens in [2, raw_vocab), one stream per
    (seed, wave, request)."""
    rng = np.random.default_rng([seed % (1 << 63), 7, wave, index])
    return (rng.zipf(zipf_a, length).astype(np.int64) % (raw_vocab - 2)) + 2
