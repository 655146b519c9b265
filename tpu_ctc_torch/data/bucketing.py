"""Bucketed-by-length batching with static padded shapes.

The reference streamed one utterance at a time from pickled "file dicts"
(SURVEY.md C7) — fine for a single GPU, hostile to XLA.  Here utterances are
bucketed by frame count into a small, fixed set of padded shapes
(BASELINE north_star: "utterance batches are data-parallel over hosts with
bucketed-by-length padding"), so jit compiles once per bucket shape
(SURVEY.md §7.3-4 "Bucketing × jit") and every batch is a static-shape
pytree ready for `device_put` with a 'data'-axis sharding.

Determinism/resume: the shuffle is a pure function of (seed, epoch), and the
iterator exposes a cursor that the checkpoint can record (SURVEY.md §7.3-5).

A lazy dataset (one with ``fetch``, ``ManifestDataset``) is asked for a
batch's items at once, and for the next batch's before this one's are
awaited, so a frontend pool works ahead of the consumer.  On a mesh a
loader built with ``rows`` (the rows of every global batch that this rank
featurizes, ``train.step.feature_rows``) featurizes only the utterances of
those rows: the other rows keep their lengths, labels and weights from the
manifest and zero features, so the global batch's metadata is whole.
Where several ranks read the same rows (a 'model' or 'seq' line), each
featurizes a share of them and ``exchange`` (``parallel.mesh.RowExchange``)
fills in the others' shares, so the rows the rank reads are bit-equal to
those of the fully featurized batch and each is featurized once.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from tpu_ctc_torch.config import DataConfig
from tpu_ctc_torch.utils import profiling


@dataclasses.dataclass
class Batch:
    """Static-shape training batch (numpy host-side; device_put by the loop)."""
    feats: np.ndarray          # [B, T_pad, D] float32
    frame_mask: np.ndarray     # [B, T_pad] float32
    frame_lengths: np.ndarray  # [B] int32
    labels: np.ndarray         # [B, L_pad] int32 (zero-padded)
    label_lengths: np.ndarray  # [B] int32
    # Number of genuine utterances (< B when the tail batch is padded with
    # repeats; repeated rows have weight 0).
    weights: np.ndarray        # [B] float32
    # Dataset index per row (repeated-tail rows keep the repeated index but
    # carry weight 0); -1 when the batch was built without indices.  Host
    # metadata only — never shipped to device.  Lets eval jobs map hyps
    # back to utterance ids for trn emission (SURVEY.md C13 scoring).
    utt_indices: np.ndarray = None  # [B] int64

    @property
    def shape_key(self) -> Tuple[int, int, int]:
        return (self.feats.shape[0], self.feats.shape[1], self.labels.shape[1])

    def audio_seconds(self, frames_per_second: float = 100.0) -> float:
        return float((self.frame_lengths * self.weights).sum() / frames_per_second)


def _bucket_for(t: int, boundaries: Sequence[int]) -> Optional[int]:
    for i, b in enumerate(boundaries):
        if t <= b:
            return i
    return None  # longer than the largest bucket: dropped (logged by caller)


def _label_pad_for(bucket_frames: int, max_label_len: int) -> int:
    # Labels padded to a per-bucket cap: no more labels than frames can emit.
    return int(min(max_label_len, bucket_frames))


# The label columns a step keeps are cut to a multiple of this.
LABEL_ALIGN = 32


def label_width(label_lengths, padded: int) -> int:
    """The label columns a step keeps of a batch padded to ``padded``: its
    longest label (at least 1) rounded up to a multiple of
    :data:`LABEL_ALIGN`, at most ``padded``.  Host arithmetic on the
    lengths the loader already holds; the CTC lattice then takes its width
    from the columns it is given and never reads the device."""
    lengths = np.asarray(label_lengths)
    longest = max(int(lengths.max()) if lengths.size else 0, 1)
    return min(-(-longest // LABEL_ALIGN) * LABEL_ALIGN, int(padded))


def cut_labels(arrays: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """A batch's host arrays with ``labels`` cut to :func:`label_width`
    columns (the dead columns past every label leave the loss as it was);
    the same dict when there is nothing to cut."""
    labels = np.asarray(arrays["labels"])
    width = label_width(arrays["label_lengths"], labels.shape[1])
    if width == labels.shape[1]:
        return arrays
    return dict(arrays, labels=np.ascontiguousarray(labels[:, :width]))


def make_batch(utts: List[Tuple[Optional[np.ndarray], np.ndarray]],
               t_pad: int, l_pad: int, batch_size: int,
               indices: Optional[Sequence[int]] = None,
               lengths: Optional[Sequence[int]] = None) -> Batch:
    """Pad a list of (feats [T,D], labels [L]) to one static-shape Batch.
    An utterance whose feats are None (another rank featurizes it) gets
    its frame count from ``lengths`` and zero features."""
    n = len(utts)
    assert 0 < n <= batch_size
    d = next(f for f, _ in utts if f is not None).shape[1]
    feats = np.zeros((batch_size, t_pad, d), dtype=np.float32)
    mask = np.zeros((batch_size, t_pad), dtype=np.float32)
    f_len = np.zeros(batch_size, dtype=np.int32)
    labels = np.zeros((batch_size, l_pad), dtype=np.int32)
    l_len = np.zeros(batch_size, dtype=np.int32)
    weights = np.zeros(batch_size, dtype=np.float32)
    for i in range(batch_size):
        f, l = utts[i % n]           # tail batches repeat, weight 0
        t, ll = (int(lengths[i % n]) if f is None else len(f)), len(l)
        if f is not None:
            feats[i, :t] = f
        mask[i, :t] = 1.0
        f_len[i] = t
        labels[i, :ll] = l
        l_len[i] = ll
        weights[i] = 1.0 if i < n else 0.0
    if indices is None:
        utt_idx = np.full(batch_size, -1, dtype=np.int64)
    else:
        utt_idx = np.asarray([indices[i % n] for i in range(batch_size)],
                             dtype=np.int64)
    return Batch(feats, mask, f_len, labels, l_len, weights, utt_idx)


class BucketedLoader:
    """Epoch iterator over bucketed static-shape batches.

    ``dataset`` is a sequence of (feats [T, D] float32, labels [L] int32).
    For multi-host data parallelism pass (host_id, num_hosts): each host
    deterministically takes a disjoint strided shard of every epoch's
    shuffled order (SURVEY.md §2.2 P1 "per-host input sharding").
    ``rows`` (row indices of a global batch; None for all) limits what a
    lazy dataset featurizes to the utterances of those rows, and
    ``exchange`` (called with each batch's features) fills in the rows
    that other ranks featurized; in-memory datasets ignore both.
    :meth:`close` releases the exchange.
    """

    def __init__(self, dataset: Sequence[Tuple[np.ndarray, np.ndarray]],
                 cfg: DataConfig, host_id: int = 0, num_hosts: int = 1,
                 rows: Optional[Sequence[int]] = None, exchange=None):
        self.cfg = cfg
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.rows = None if rows is None else [int(r) for r in rows]
        self.exchange = exchange
        # Lazy datasets (ManifestDataset) are kept as-is: list() would read
        # every payload, defeating the streaming path.  Anything indexable
        # passes through; generators are materialized.
        self.dataset = dataset if hasattr(dataset, "__getitem__") else list(dataset)
        self.num_dropped = 0
        self._bucket_items: List[List[int]] = [[] for _ in cfg.bucket_boundaries]
        if hasattr(self.dataset, "frame_lengths"):
            # Metadata-only lengths: bucket a 300h corpus without touching
            # audio payloads (SURVEY.md C7 at configs 3/5).
            self._lengths = np.asarray(self.dataset.frame_lengths)
        else:
            self._lengths = np.array([len(f) for f, _ in self.dataset])
        for i, t in enumerate(self._lengths):
            b = _bucket_for(int(t), cfg.bucket_boundaries)
            if b is None:
                self.num_dropped += 1
            else:
                self._bucket_items[b].append(i)

    def _epoch_order(self, epoch: int) -> List[Tuple[int, List[int]]]:
        """Deterministic (bucket, utterance-ids) batch plan for an epoch."""
        cfg = self.cfg
        plan: List[Tuple[int, List[int]]] = []
        rng = np.random.RandomState((cfg.seed * 1000003 + epoch) % (2**31))
        for b, items in enumerate(self._bucket_items):
            items = list(items)
            if cfg.sortagrad and epoch == 0:
                items.sort(key=lambda i: int(self._lengths[i]))
            elif cfg.shuffle:
                rng.shuffle(items)
            for s in range(0, len(items), cfg.batch_size):
                plan.append((b, items[s:s + cfg.batch_size]))
        if cfg.shuffle and not (cfg.sortagrad and epoch == 0):
            order = rng.permutation(len(plan))
            plan = [plan[i] for i in order]
        # Multi-host: strided disjoint shard of the batch plan.
        return plan[self.host_id::self.num_hosts]

    def num_batches(self, epoch: int = 0) -> int:
        return len(self._epoch_order(epoch))

    def epoch(self, epoch: int, start_batch: int = 0) -> Iterator[Tuple[int, Batch]]:
        """Yield (cursor, Batch); ``start_batch`` resumes mid-epoch.  With
        an exchange, a failure while the batch is made, or a close before
        the epoch's end, tells the other ranks (``exchange.abort``), which
        then raise instead of waiting.  A batch's making (its utterances
        awaited, then padded) is the span ``loader.make_batch``
        (``utils.profiling``)."""
        cfg = self.cfg
        plan = self._epoch_order(epoch)
        fetch = getattr(self.dataset, "fetch", None)
        rows = self.rows if fetch is not None else None
        exchange = self.exchange if fetch is not None else None
        if fetch is None:           # in memory: items when they are awaited
            def fetch(ids):
                return lambda: [self.dataset[i] for i in ids]

        def request(cursor):
            ids = plan[cursor][1]
            mine = (range(len(ids)) if rows is None else
                    sorted({r % len(ids) for r in rows}))
            return mine, fetch([ids[j] for j in mine])

        def make(cursor, ids, mine, wait):
            got = dict(zip(mine, wait()))
            if rows is not None:
                for j, (f, _) in got.items():
                    if len(f) != self._lengths[ids[j]]:
                        raise ValueError(
                            f"utterance {ids[j]} has {len(f)} frames, its "
                            f"manifest metadata {self._lengths[ids[j]]}: a "
                            f"rank's rows need the metadata's lengths")
            utts = [got[j] if j in got else (None, labels[ids[j]])
                    for j in range(len(ids))]
            t_pad = cfg.bucket_boundaries[plan[cursor][0]]
            l_pad = _label_pad_for(t_pad, cfg.max_label_len)
            return make_batch(utts, t_pad, l_pad, cfg.batch_size,
                              indices=ids, lengths=self._lengths[ids])

        labels = self.dataset.labels if rows is not None else None
        pending = request(start_batch) if start_batch < len(plan) else None
        cursor = start_batch
        try:
            for cursor in range(start_batch, len(plan)):
                ids = plan[cursor][1]
                try:
                    mine, wait = pending
                    pending = (request(cursor + 1) if cursor + 1 < len(plan)
                               else None)
                    with profiling.span("loader.make_batch"):
                        batch = make(cursor, ids, mine, wait)
                except BaseException:
                    if exchange is not None:
                        exchange.abort()
                    raise
                if exchange is not None:
                    exchange(batch.feats)
                yield cursor, batch
        except GeneratorExit:           # closed at a yield, not at the end
            if exchange is not None and cursor + 1 < len(plan):
                exchange.abort()
            raise

    def close(self) -> None:
        if self.exchange is not None:
            self.exchange.close()

    def shape_keys(self) -> List[Tuple[int, int, int]]:
        """All (B, T_pad, L_pad) shapes jit will ever see (compile-cache bound)."""
        cfg = self.cfg
        return [(cfg.batch_size, t, _label_pad_for(t, cfg.max_label_len))
                for t in cfg.bucket_boundaries]
