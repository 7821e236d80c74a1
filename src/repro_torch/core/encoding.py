"""Context encoding (paper §III-C, eqs. 1-2).

Every descriptive property p is mapped to a fixed-size vector
``p_vec = [lambda, q_1..q_L]`` where q comes from

  hasher     textual properties: character cleansing -> n-gram extraction ->
             hashing-trick term counts -> projection onto the L2 unit sphere
  binarizer  natural numbers: base-2 digits (valid while p <= 2^L)

and ``lambda`` in {0,1} flags which method was used.  Encoding is host-side
numpy (deterministic across processes: md5, not python hash()).
"""
from __future__ import annotations

import hashlib
import re
from typing import Iterable, List, Union

import numpy as np

DEFAULT_L = 31          # q length; N = L + 1 with the lambda prefix
NGRAM = 3


def is_natural(p: Union[str, int, float]) -> bool:
    if isinstance(p, bool):
        return False
    if isinstance(p, (int, np.integer)):
        return int(p) >= 0
    return False


def _cleanse(text: str) -> str:
    return re.sub(r"[^a-z0-9 ]+", " ", str(text).lower()).strip()


def _ngrams(text: str, n: int = NGRAM) -> List[str]:
    toks = []
    for word in text.split():
        if len(word) < n:
            toks.append(word)
        else:
            toks.extend(word[i:i + n] for i in range(len(word) - n + 1))
    return toks


def _stable_bucket(term: str, L: int) -> int:
    digest = hashlib.md5(term.encode("utf-8")).digest()
    return int.from_bytes(digest[:4], "little") % L


def hasher(p: str, L: int = DEFAULT_L) -> np.ndarray:
    q = np.zeros(L, np.float32)
    for term in _ngrams(_cleanse(p)):
        q[_stable_bucket(term, L)] += 1.0
    norm = np.linalg.norm(q)
    if norm > 0:
        q /= norm                       # euclidean unit sphere (paper §III-C)
    return q


def binarizer(p: int, L: int = DEFAULT_L) -> np.ndarray:
    p = int(p)
    if p < 0 or p >= (1 << L):
        raise ValueError(f"binarizer domain: 0 <= p < 2^{L}, got {p}")
    bits = np.zeros(L, np.float32)
    for i in range(L):
        bits[i] = (p >> i) & 1
    return bits


def encode_property(p: Union[str, int], L: int = DEFAULT_L) -> np.ndarray:
    """eq. (1): [lambda, q_1..q_L]; lambda=1 -> binarizer, 0 -> hasher."""
    if is_natural(p):
        lam, q = 1.0, binarizer(p, L)
    else:
        lam, q = 0.0, hasher(str(p), L)
    return np.concatenate([[lam], q]).astype(np.float32)


def encode_properties(props: Iterable[Union[str, int]],
                      L: int = DEFAULT_L) -> np.ndarray:
    props = list(props)
    if not props:
        return np.zeros((0, L + 1), np.float32)
    return np.stack([encode_property(p, L) for p in props])
