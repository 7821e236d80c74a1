"""Auto-encoder for dense low-dimensional context embeddings (paper §III-C).

min || p - h(g(p)) ||^2 with encoder g: R^N -> R^M, decoder h, M << N.
PyTorch counterpart of ``repro.core.autoencoder``: parameters are a plain
dict of tensors in the ``(in, out)`` weight layout, initialised from an
explicit ``torch.Generator`` and trained with the same hand-written Adam.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.core.encoding import DEFAULT_L
from repro_torch.device import DeviceLike, resolve_device

N_DIM = DEFAULT_L + 1
EMBED_DIM = 8
ADAM_CHUNK = 100          # the reference trains in scanned blocks of 100 steps


def init_autoencoder(generator: torch.Generator, n_dim: int = N_DIM,
                     m_dim: int = EMBED_DIM, hidden: int = 24,
                     device: DeviceLike = "cuda") -> Dict[str, torch.Tensor]:
    """Weights ~ N(0, 1/fan_in) drawn on the CPU from ``generator`` (so the
    draw does not depend on the device), zero biases."""
    dev = resolve_device(device)

    def s(i, o):
        w = torch.randn(i, o, generator=generator, dtype=torch.float32)
        return (w / math.sqrt(i)).to(dev)

    z = lambda n: torch.zeros(n, dtype=torch.float32, device=dev)
    return {
        "enc_w1": s(n_dim, hidden), "enc_b1": z(hidden),
        "enc_w2": s(hidden, m_dim), "enc_b2": z(m_dim),
        "dec_w1": s(m_dim, hidden), "dec_b1": z(hidden),
        "dec_w2": s(hidden, n_dim), "dec_b2": z(n_dim),
    }


def encode(params: Dict[str, torch.Tensor], p: torch.Tensor) -> torch.Tensor:
    h = torch.tanh(p @ params["enc_w1"] + params["enc_b1"])
    return torch.tanh(h @ params["enc_w2"] + params["enc_b2"])


def decode(params: Dict[str, torch.Tensor], e: torch.Tensor) -> torch.Tensor:
    h = torch.tanh(e @ params["dec_w1"] + params["dec_b1"])
    return h @ params["dec_w2"] + params["dec_b2"]


def recon_loss(params: Dict[str, torch.Tensor],
               batch: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.square(decode(params, encode(params, batch))
                                   - batch))


def train_autoencoder(vectors: np.ndarray, *, steps: int = 300,
                      lr: float = 1e-2, seed: int = 0,
                      device: DeviceLike = "cuda"
                      ) -> Tuple[Dict[str, torch.Tensor], float]:
    """Fit on the property-vector pool; returns (params, final_loss).

    Runs ``max(1, steps // 100) * 100`` Adam steps (beta1 0.9, beta2 0.999,
    eps 1e-8, bias correction by the step count), as the reference does.
    """
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    params = init_autoencoder(gen, device=dev)
    names = list(params)
    mu = {k: torch.zeros_like(v) for k, v in params.items()}
    nu = {k: torch.zeros_like(v) for k, v in params.items()}
    batch = torch.as_tensor(np.asarray(vectors, np.float32), device=dev)
    loss = torch.tensor(float("inf"))
    for t in range(1, max(1, steps // ADAM_CHUNK) * ADAM_CHUNK + 1):
        leaves = [params[k].requires_grad_(True) for k in names]
        loss = recon_loss(params, batch)
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            for k, g in zip(names, grads):
                mu[k] = 0.9 * mu[k] + 0.1 * g
                nu[k] = 0.999 * nu[k] + 0.001 * g * g
                mh = mu[k] / (1 - 0.9 ** t)
                vh = nu[k] / (1 - 0.999 ** t)
                params[k] = params[k].detach() - lr * mh / (vh.sqrt() + 1e-8)
    return params, float(loss.detach())


def embed_properties(params: Dict[str, torch.Tensor],
                     vectors: np.ndarray) -> np.ndarray:
    if vectors.shape[0] == 0:
        return np.zeros((0, EMBED_DIM), np.float32)
    dev = params["enc_w1"].device
    with torch.no_grad():
        out = encode(params, torch.as_tensor(vectors, device=dev))
    return out.cpu().numpy()
