"""The character n-gram LM of the decode configuration, rebuilt from the
transcripts: counts of every order up to ``order`` with the blank (0) as
the context before a transcript's start, add-k smoothed, the orders
mixed with weights proportional to 2^(o-1), as the configuration file's
``lm`` section states."""
from __future__ import annotations

from typing import List

import numpy as np


def train(seqs: List[np.ndarray], vocab: int, order: int,
          add_k: float) -> np.ndarray:
    """log P(c | the order-1 chars before it), a float32 table [vocab]*order
    indexed [c_-2, c_-1, c] for order 3."""
    flat = np.concatenate([np.asarray(s, dtype=np.int64) for s in seqs])
    starts = np.zeros(len(flat), dtype=bool)
    starts[np.cumsum([0] + [len(s) for s in seqs[:-1]])] = True
    # prev[j-1]: the char j places back in the same transcript, 0 before
    pos = np.arange(len(flat))
    since = pos - np.maximum.accumulate(np.where(starts, pos, 0))
    prev = []
    for j in range(1, order):
        back = np.concatenate([np.zeros(j, dtype=np.int64), flat[:-j]])
        prev.append(np.where(since >= j, back, 0))
    mix = np.zeros((vocab,) * order, dtype=np.float64)
    weights = np.array([2.0 ** i for i in range(order)])
    weights /= weights.sum()
    for o in range(1, order + 1):
        idx = tuple(reversed(prev[:o - 1])) + (flat,)
        counts = np.zeros((vocab,) * o, dtype=np.float64)
        np.add.at(counts, idx, 1.0)
        counts += add_k
        counts[..., 0] = 0.0
        denom = counts.sum(axis=-1, keepdims=True)
        p = counts / np.where(denom <= 0, 1.0, denom)
        mix += weights[o - 1] * p.reshape((1,) * (order - o) + p.shape)
    return np.log(np.maximum(mix, 1e-30)).astype(np.float32)
