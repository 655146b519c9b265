"""Manifest-file dataset: features/audio on disk -> (feats, labels) pairs.

Counterpart of ``tpu_ctc.data.manifest``.  A split is
``<dir>/<split>.jsonl``, one record a line:

  {"id": "utt1", "feats": "utt1.npy", "text": "hello world", "frames": 412}
  {"id": "utt2", "audio": "utt2.wav", "text": "...", "samples": 51200}

Paths are relative to the manifest's directory (absolute paths pass
through).  ``feats`` files are ``.npy`` [T, n_mels] float32; ``audio``
files are RIFF-WAV, NIST-SPHERE or 1-D ``.npy`` waveforms, read by
:mod:`tpu_ctc_torch.data.audio_io`, resampled to the config's rate and run
through the port's frontend (:mod:`tpu_ctc_torch.frontend.features`).

:class:`ManifestDataset` is lazy: it holds the record list and the decoded
labels, and each ``[i]`` reads and processes one utterance.  Frame lengths
come from the records' metadata or the containers' headers, so bucketing
reads no payload.  :func:`load_manifest_dataset` materializes a split.

The frontend runs on the CPU, one utterance at a time, as the reference
runs it on the host CPU backend: data preparation does not occupy the
card.  The reference pads each waveform to a quantum of samples to bound
jit's shapes; the port needs no such padding and pads only ``context``
hops of zeros, so that the last valid frame's right context is masked
frames, as it is in the reference (whose padding differs only when a
waveform's length is an exact multiple of its quantum).
"""
from __future__ import annotations

import json
import os
from math import gcd
from typing import List, Optional, Tuple

import numpy as np
import torch

from tpu_ctc_torch.data import audio_io
from tpu_ctc_torch.data.alphabet import DEFAULT_ALPHABET, Alphabet
from tpu_ctc_torch.frontend import features as F


def _strided_len(n_frames: int, stride: int) -> int:
    """Valid frames after ``[::stride]`` of a prefix-ones mask."""
    return (int(n_frames) + stride - 1) // stride if stride > 1 else int(n_frames)


class ManifestDataset:
    """Lazy Sequence of (feats [T, D] float32, labels [L] int32).

    Only the parsed manifest (id, path, text, length metadata) and the
    labels live in memory; payloads are read per access (``payload_reads``
    counts them).  ``cache_items`` keeps that many processed items."""

    def __init__(self, manifest_dir: str, cfg,
                 alphabet: Alphabet = DEFAULT_ALPHABET,
                 split: str = "train", cache_items: int = 0):
        self.manifest_dir = manifest_dir
        self.cfg = cfg
        self.alphabet = alphabet
        self.records: List[dict] = []
        with open(os.path.join(manifest_dir, f"{split}.jsonl")) as f:
            for line in f:
                if line.strip():
                    self.records.append(json.loads(line))
        self._labels = [
            np.asarray(alphabet.encode(r["text"]), dtype=np.int32)
            for r in self.records
        ]
        self._frame_lengths: Optional[np.ndarray] = None
        self._cache: dict = {}
        self._cache_items = cache_items
        self.payload_reads = 0

    def __len__(self) -> int:
        return len(self.records)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return DatasetView(self, range(*i.indices(len(self))))
        if i in self._cache:
            return self._cache[i]
        rec = self.records[i]
        self.payload_reads += 1
        if "feats" in rec:
            feats = self._process_feats(
                np.load(self._abspath(rec["feats"]), mmap_mode="r"))
        elif "audio" in rec:
            wav, _ = audio_io.read_audio(
                self._abspath(rec["audio"]),
                target_rate=self.cfg.frontend.sample_rate)
            feats = self._process_audio(wav, utt_index=i)
        else:
            raise ValueError(f"manifest record needs 'feats' or 'audio': {rec}")
        item = (feats, self._labels[i])
        if self._cache_items:
            if len(self._cache) >= self._cache_items:
                self._cache.pop(next(iter(self._cache)))
            self._cache[i] = item
        return item

    @property
    def frame_lengths(self) -> np.ndarray:
        """Model-input frame count per utterance, from metadata/headers only."""
        if self._frame_lengths is None:
            fe = self.cfg.frontend
            out = np.zeros(len(self.records), dtype=np.int64)
            for i, rec in enumerate(self.records):
                if "feats" in rec:
                    t = rec.get("frames")
                    if t is None:
                        t = np.load(self._abspath(rec["feats"]),
                                    mmap_mode="r").shape[0]
                else:
                    n = rec.get("samples")
                    rate = rec.get("rate", 0)
                    if n is not None and rate and rate != fe.sample_rate:
                        g = gcd(int(rate), fe.sample_rate)
                        n = int(np.ceil(n * (fe.sample_rate // g) / (rate // g)))
                    if n is None:
                        n = audio_io.num_samples(self._abspath(rec["audio"]),
                                                 target_rate=fe.sample_rate)
                    t = F.num_frames(int(n), fe)
                out[i] = _strided_len(t, fe.frame_stride)
            self._frame_lengths = out
        return self._frame_lengths

    def _abspath(self, p: str) -> str:
        return p if os.path.isabs(p) else os.path.join(self.manifest_dir, p)

    def _process_feats(self, feats: np.ndarray) -> np.ndarray:
        fe = self.cfg.frontend
        x = torch.from_numpy(np.array(feats, dtype=np.float32))[None]
        if fe.cmvn:
            x = F.cmvn(x)
        x = F.stack_context(x, fe.context)
        if fe.frame_stride > 1:
            x = x[:, ::fe.frame_stride]
        return x[0].numpy()

    def _process_audio(self, wav: np.ndarray, utt_index: int = 0) -> np.ndarray:
        """The frontend on the CPU; dither (if any) from a generator seeded
        with the utterance index, so each utterance gets its own noise."""
        fe = self.cfg.frontend
        n = len(wav)
        x = np.zeros(max(n, fe.frame_length) + fe.context * fe.hop_length,
                     dtype=np.float32)
        x[:n] = wav
        gen = (torch.Generator().manual_seed(utt_index)
               if fe.dither > 0.0 else None)
        feats, mask = F.extract_features(
            torch.from_numpy(x)[None], fe,
            sample_lengths=torch.tensor([n], dtype=torch.int64),
            generator=gen)
        t = int(mask[0].sum())
        return feats[0, :t].numpy()


class DatasetView:
    """Lazy index-remapped view of a ManifestDataset (slices stay
    streaming; no payload reads)."""

    def __init__(self, base, indices):
        self.base = base
        self.indices = list(indices)

    def __len__(self) -> int:
        return len(self.indices)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return DatasetView(self.base, [self.indices[j]
                                           for j in range(*i.indices(len(self)))])
        return self.base[self.indices[i]]

    @property
    def frame_lengths(self) -> np.ndarray:
        return np.asarray(self.base.frame_lengths)[self.indices]

    @property
    def records(self):
        return [self.base.records[i] for i in self.indices]


def load_manifest_dataset(manifest_dir: str, cfg,
                          alphabet: Alphabet = DEFAULT_ALPHABET,
                          split: str = "train"
                          ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Eagerly load ``<manifest_dir>/<split>.jsonl`` into in-memory pairs."""
    ds = ManifestDataset(manifest_dir, cfg, alphabet=alphabet, split=split)
    return [ds[i] for i in range(len(ds))]


def write_manifest(manifest_dir: str, split: str, records: List[dict]) -> str:
    os.makedirs(manifest_dir, exist_ok=True)
    path = os.path.join(manifest_dir, f"{split}.jsonl")
    with open(path, "w") as f:
        for rec in records:
            f.write(json.dumps(rec) + "\n")
    return path
