"""The one traffic generator: a pool of utterances from a traffic file and
a seed.

A traffic file (``ctcbench/traffic/<name>.json``) gives the pool's size,
the distribution of utterance durations, the characters per audio second
and the feature width.  The durations are the distribution's quantiles at
(i + 0.5) / n, clipped, so every seed gets the same set of lengths and
labels of the same lengths, and so the same work; the seed draws the
characters, the features and (through the loader's shuffle) the order.
Features are standard normal float32, drawn on the device in a few large
calls and held in host memory, as a job's feature cache would be.
"""
from __future__ import annotations

import math
from statistics import NormalDist
from typing import List, Tuple

import numpy as np
import torch

CHUNK = 1 << 24          # floats drawn per call (64 MB)


def durations(spec: dict) -> np.ndarray:
    """Seconds of each utterance of the pool, the same for every seed."""
    n = int(spec["utterances"])
    d = spec["seconds"]
    unit = NormalDist()
    z = np.array([unit.inv_cdf((i + 0.5) / n) for i in range(n)])
    if d["dist"] == "normal":
        s = d["mean"] + d["sd"] * z
    elif d["dist"] == "lognormal":
        s = np.exp(math.log(d["median"]) + d["sigma"] * z)
    else:
        raise ValueError(f"unknown duration distribution {d['dist']!r}")
    return np.clip(s, d["min"], d["max"])


def lengths(spec: dict) -> Tuple[np.ndarray, np.ndarray]:
    """(frames, characters) of each utterance."""
    s = durations(spec)
    frames = np.rint(s * spec["frames_per_second"]).astype(np.int64)
    chars = np.maximum(1, np.rint(s * spec["chars_per_second"])).astype(
        np.int64)
    return frames, chars


def bucket_shares(spec: dict, boundaries) -> List[float]:
    """The share of the pool's utterances in each bucket."""
    frames, _ = lengths(spec)
    edges = [0] + list(boundaries)
    return [float(np.mean((frames > lo) & (frames <= hi)))
            for lo, hi in zip(edges[:-1], edges[1:])]


def make_pool(spec: dict, seed: int, vocab: int, device
              ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """[(features [T, D] float32, labels [L] int32)] of the traffic file,
    from ``seed``.  Labels are characters 1..vocab-1 (0 is the blank)."""
    frames, chars = lengths(spec)
    dim = int(spec["feature_dim"])
    rng = np.random.default_rng(seed)
    flat_labels = rng.integers(1, vocab, size=int(chars.sum()),
                               dtype=np.int32)
    feats = np.empty((int(frames.sum()), dim), dtype=np.float32)
    out = torch.from_numpy(feats).view(-1)
    gen = torch.Generator(device=device).manual_seed(seed)
    for start in range(0, out.numel(), CHUNK):
        n = min(CHUNK, out.numel() - start)
        out[start:start + n].copy_(torch.randn(n, generator=gen,
                                               device=device))
    pool = []
    f0 = l0 = 0
    for t, n in zip(frames, chars):
        pool.append((feats[f0:f0 + t], flat_labels[l0:l0 + n]))
        f0 += t
        l0 += n
    return pool
