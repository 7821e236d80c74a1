"""Batched serving engine: prefill + lockstep greedy decode over a KV cache.

Counterpart of ``repro.serve.engine``, with the same semantics: a wave's
prompts are left-padded with token 0 to the longest prompt (the pad tokens
are attended, as in the reference, which has no pad mask), positions run
0..P-1, one joint prefill fills the cache, then every step decodes one token
for the whole wave at the shared position ``pos``; greedy sampling takes the
first maximum.  The next tokens come to the host once per step.

A wave of the audio or vlm family takes its frontend's inputs as
``extras`` (``{"frames": ...}`` or ``{"patches": ...}``, the reference's
argument).  A vlm wave decodes from position ``n_patches + P``, after the
patch rows its prefill put in front of the text: the reference's model
contract (``tests/test_cache_consistency.py``), where the reference's
engine decodes at P and so writes over the prefill's rows.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import decode_step, frontend_input, prefill


@dataclass
class Request:
    prompt: np.ndarray                 # (P,) int
    max_new_tokens: int = 16
    out_tokens: List[int] = field(default_factory=list)
    done: bool = False


@dataclass
class ServeStats:
    prefill_s: float = 0.0
    decode_s: float = 0.0
    tokens_out: int = 0
    decode_steps: int = 0

    @property
    def decode_tok_s(self) -> float:
        return self.tokens_out / self.decode_s if self.decode_s else 0.0


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class ServeEngine:
    """Serves waves of requests against ``params`` (which must lie on
    ``device``) with a cache of ``max_len`` positions."""

    def __init__(self, cfg: ModelConfig, params: Dict, max_len: int = 256,
                 device: DeviceLike = "cuda"):
        self.device = resolve_device(device)
        where = params["embed"].device
        if where.type != self.device.type or (
                self.device.index is not None
                and where.index != self.device.index):
            raise ValueError(f"params lie on {where}, the engine runs on "
                             f"{self.device}")
        self.cfg = cfg
        self.params = params
        self.max_len = max_len

    def _pad_prompts(self, reqs: List[Request]) -> np.ndarray:
        plen = max(len(r.prompt) for r in reqs)
        toks = np.zeros((len(reqs), plen), np.int64)
        for i, r in enumerate(reqs):
            toks[i, plen - len(r.prompt):] = r.prompt    # left-pad
        return toks

    @torch.no_grad()
    def serve_wave(self, reqs: List[Request],
                   extras: Optional[Dict] = None) -> ServeStats:
        """One wave: joint prefill, then lockstep decode.  ``extras`` maps
        batch names (``frames``, ``patches``) to numpy arrays or tensors,
        which go to the engine's device with their values and dtype
        unchanged.  ``prefill_s`` runs to the first tokens on the host,
        whose copy waits for the prefill; one synchronize ends the wave."""
        stats = ServeStats()
        toks = self._pad_prompts(reqs)
        b, plen = toks.shape
        pos = plen + frontend_input(self.cfg).text_offset
        max_new = max(r.max_new_tokens for r in reqs)
        with obs.span("serve.wave"):
            t0 = time.perf_counter()
            with obs.span("serve.prefill", rows=b * pos):
                batch = {"tokens": torch.from_numpy(toks).to(self.device)}
                for k, v in (extras or {}).items():
                    batch[k] = torch.as_tensor(v).to(self.device)
                logits, cache = prefill(self.params, self.cfg, batch,
                                        cache_len=self.max_len)
                next_tok = logits[:, -1:].argmax(dim=-1)          # (B, 1)
                host = next_tok[:, 0].tolist()
            t1 = time.perf_counter()
            stats.prefill_s = t1 - t0
            for step in range(max_new):
                if step:
                    host = next_tok[:, 0].tolist()
                for i, r in enumerate(reqs):
                    if not r.done and step < r.max_new_tokens:
                        r.out_tokens.append(host[i])
                        stats.tokens_out += 1
                if pos + 1 >= self.max_len:
                    break
                with obs.span("serve.decode"):
                    logits, cache = decode_step(self.params, self.cfg,
                                                cache, next_tok, pos)
                    next_tok = logits[:, -1:].argmax(dim=-1)
                stats.decode_steps += 1
                pos += 1
            _sync(self.device)
            stats.decode_s = time.perf_counter() - t1
        for r in reqs:
            r.done = True
        return stats
