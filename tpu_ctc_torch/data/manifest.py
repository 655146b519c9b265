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
card.  ``ManifestDataset(workers=N)`` gives :meth:`ManifestDataset.fetch`
(the loader's access, a batch's items at once) a pool of N worker
processes, each with a ``ManifestDataset`` of its own over the same split
that computes ``[i]`` as this process does (one intra-op thread: the
features do not depend on the thread count, which the tests hold), so an
item's features are bit-equal whichever process made them.  The workers
are forked by a fork server that this process starts once, with this
module and torch imported (so the first pool waits for one import of
torch and later pools for none); the server never touches a card.  The
pool starts at the first fetch, lives across epochs, and stops at
:meth:`ManifestDataset.close`; a worker's exception, or a pool that
cannot start, raises in the caller of the fetch.  Each worker imports the
main module, as a spawned one would: a script that starts a pool runs its
work under ``if __name__ == "__main__":``, as the CLI and
``chip_smoke.py`` do.  :func:`host_workers`
is the pool size the CLI gives a loader that feeds a card.

The reference pads each waveform to a quantum of samples to bound jit's
shapes; the port needs no such padding and pads only ``context`` hops of
zeros, so that the last valid frame's right context is masked frames, as
it is in the reference (whose padding differs only when a waveform's
length is an exact multiple of its quantum).
"""
from __future__ import annotations

import json
import multiprocessing
import os
import weakref
from concurrent.futures import ProcessPoolExecutor
from math import gcd
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tpu_ctc_torch.data import audio_io
from tpu_ctc_torch.data.alphabet import DEFAULT_ALPHABET, Alphabet
from tpu_ctc_torch.frontend import features as F


def _strided_len(n_frames: int, stride: int) -> int:
    """Valid frames after ``[::stride]`` of a prefix-ones mask."""
    return (int(n_frames) + stride - 1) // stride if stride > 1 else int(n_frames)


def host_workers() -> int:
    """The frontend pool's size for a rank that feeds a card: the CPUs
    this process may run on (``os.sched_getaffinity``) shared among the
    host's ranks (``LOCAL_WORLD_SIZE``, which torchrun sets), less one for
    the rank's training thread."""
    local = max(int(os.environ.get("LOCAL_WORLD_SIZE", "1")), 1)
    return max(len(os.sched_getaffinity(0)) // local - 1, 0)


_WORKER_DATASET = None          # a pool worker's own in-process dataset


def _pool_context():
    """The pools' start method: a fork server, started once a process
    with this module (and so torch) imported, which forks each worker: a
    pool starts in a fraction of a second after the first, where spawned
    workers each import torch anew.  The server never touches a card, so
    its forks are as clean as spawned processes."""
    ctx = multiprocessing.get_context("forkserver")
    ctx.set_forkserver_preload([__name__])
    return ctx


def _worker_init(manifest_dir, cfg, alphabet, split):
    global _WORKER_DATASET
    torch.set_num_threads(1)
    _WORKER_DATASET = ManifestDataset(manifest_dir, cfg, alphabet=alphabet,
                                      split=split)


def _worker_features(ids: List[int]) -> List[np.ndarray]:
    return [_WORKER_DATASET[i][0] for i in ids]


class ManifestDataset:
    """Lazy Sequence of (feats [T, D] float32, labels [L] int32).

    Only the parsed manifest (id, path, text, length metadata) and the
    labels live in memory; payloads are read per access (``payload_reads``
    counts them, in this process or in the pool).  ``cache_items`` keeps
    that many processed items.  ``workers`` > 0 featurizes
    :meth:`fetch`'s items in that many worker processes; 0 in this
    process."""

    def __init__(self, manifest_dir: str, cfg,
                 alphabet: Alphabet = DEFAULT_ALPHABET,
                 split: str = "train", cache_items: int = 0,
                 workers: int = 0):
        self.manifest_dir = manifest_dir
        self.cfg = cfg
        self.alphabet = alphabet
        self.split = split
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
        self.workers = workers
        self._pool: Optional[ProcessPoolExecutor] = None
        self._stop_pool = None

    def __len__(self) -> int:
        return len(self.records)

    @property
    def labels(self) -> List[np.ndarray]:
        """Every item's labels, from the manifest (no payload read)."""
        return self._labels

    def fetch(self, ids: Sequence[int]
              ) -> Callable[[], List[Tuple[np.ndarray, np.ndarray]]]:
        """Start on the items ``ids``; the function returned waits for
        them and returns them in order.  With ``workers`` the uncached
        items go to the pool now, as one task a worker (every
        ``workers``-th item: a batch's items are of one length bucket);
        with none, the function computes ``self[i]`` for each when it is
        called.  One task a worker, not one an item: the pool's threads in
        this process then wake a few times a batch, not once an item,
        and take the GIL less from the training step (``PERF.md`` §5)."""
        if not self.workers:
            return lambda: [self[i] for i in ids]
        pool = self._started_pool()
        ready = {i: self._cache[i] for i in ids if i in self._cache}
        todo = [i for i in dict.fromkeys(ids) if i not in ready]
        chunks = [todo[k::self.workers]
                  for k in range(min(self.workers, len(todo)))]
        futures = [pool.submit(_worker_features, c) for c in chunks]
        self.payload_reads += len(todo)

        def wait():
            for chunk, fut in zip(chunks, futures):
                for i, feats in zip(chunk, fut.result()):
                    ready[i] = (feats, self._labels[i])
                    self._remember(i, ready[i])
            return [ready[i] for i in ids]
        return wait

    def close(self) -> None:
        """Stop the pool's workers (waiting for them to exit); a later
        :meth:`fetch` starts a new pool."""
        if self._stop_pool is not None:
            self._stop_pool()
        self._pool = self._stop_pool = None

    def _started_pool(self) -> ProcessPoolExecutor:
        if self._pool is None:
            pool = ProcessPoolExecutor(
                self.workers, mp_context=_pool_context(),
                initializer=_worker_init,
                initargs=(self.manifest_dir, self.cfg, self.alphabet,
                          self.split))
            # also stops the workers of a dataset dropped without close()
            self._stop_pool = weakref.finalize(self, pool.shutdown,
                                               wait=True, cancel_futures=True)
            self._pool = pool
        return self._pool

    def _remember(self, i, item) -> None:
        if self._cache_items:
            if len(self._cache) >= self._cache_items:
                self._cache.pop(next(iter(self._cache)))
            self._cache[i] = item

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
        self._remember(i, item)
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

    @property
    def labels(self) -> List[np.ndarray]:
        return [self.base.labels[i] for i in self.indices]

    def fetch(self, ids: Sequence[int]):
        return self.base.fetch([self.indices[i] for i in ids])

    def close(self) -> None:
        self.base.close()


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
