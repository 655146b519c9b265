"""What the cells share: the run's settings, the loader over the pool and
its plan, the reference's copies of batches, the work a batch asks of the
kernels, and the port's launch counters."""
from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch


@dataclasses.dataclass
class Run:
    workload: dict          # the cell's entry of BENCHMARK.json
    cfg_file: dict          # ctcbench/configs/<config>.json
    traffic: dict           # ctcbench/traffic/<traffic>.json
    seed: int
    seconds: float
    trace: bool
    t_start: float          # time.time() at process start
    device: str = "cuda"    # a rank's "cuda:<rank>"; "cpu" in the tests
    rank: int = 0
    world: int = 1
    coord: str = ""         # host:port of the ranks' process group

    @property
    def config(self):
        from ctcbench.spec import port_config
        cfg = port_config(self.cfg_file)
        data = dataclasses.replace(cfg.data, seed=int(self.seed))
        return dataclasses.replace(cfg, data=data)


def stage(run: Run, stages: list, what: str) -> None:
    """Note when a part of set-up has ended (seconds since process start)."""
    stages.append([what, time.time() - run.t_start])


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def loader(pool, cfg):
    from tpu_ctc_torch.data.bucketing import BucketedLoader
    return BucketedLoader(pool, cfg.data)


def batches(ldr, start_epoch: int) -> Iterator:
    """(cursor, Batch) over the epochs from ``start_epoch`` on, each
    reshuffled, as a job cycles its corpus."""
    return itertools.chain.from_iterable(
        ldr.epoch(e) for e in itertools.count(start_epoch))


def plan(ldr, start_epoch: int, n_epochs: int):
    """(bucket, utterance ids) of every batch of those epochs, in order:
    host arithmetic on the loader's plan alone."""
    for e in range(start_epoch, start_epoch + n_epochs):
        yield from ldr._epoch_order(e)


def host_batch(ldr, bucket: int, ids):
    """The Batch the loader makes of ``ids`` in ``bucket``."""
    from tpu_ctc_torch.data.bucketing import _label_pad_for, make_batch
    cfg = ldr.cfg
    t_pad = cfg.bucket_boundaries[bucket]
    return make_batch([ldr.dataset[i] for i in ids], t_pad,
                      _label_pad_for(t_pad, cfg.max_label_len),
                      cfg.batch_size, indices=ids,
                      lengths=ldr._lengths[ids])


def ref_batch(pool, ids, t_pad: int) -> Dict[str, np.ndarray]:
    """The reference's copy of a batch: the utterances ``ids`` of the pool
    padded to ``t_pad`` frames, one row each (the loader's weight-0 rows
    that repeat a short batch's utterances add nothing to a loss or a
    hypothesis, and are left out)."""
    feats = [pool[i][0] for i in ids]
    labels = [pool[i][1] for i in ids]
    n, dim = len(ids), feats[0].shape[1]
    out = {"feats": np.zeros((n, t_pad, dim), np.float32),
           "frame_mask": np.zeros((n, t_pad), np.float32),
           "frame_lengths": np.array([len(f) for f in feats], np.int32),
           "labels": np.zeros((n, max(len(x) for x in labels)), np.int32),
           "label_lengths": np.array([len(x) for x in labels], np.int32),
           "weights": np.ones(n, np.float32)}
    for r, (f, lab) in enumerate(zip(feats, labels)):
        out["feats"][r, :len(f)] = f
        out["frame_mask"][r, :len(f)] = 1.0
        out["labels"][r, :len(lab)] = lab
    return out


def launches() -> Dict[str, int]:
    from tpu_ctc_torch.ops import kernels
    return {k.name: k.launches for k in kernels()}


def launch_delta(before: Dict[str, int]) -> Dict[str, int]:
    """Launches of each kernel since ``before`` (``launches()``), where
    there were any."""
    now = launches()
    return {k: n - before.get(k, 0) for k, n in now.items()
            if n != before.get(k, 0)}


def memory_peak(device) -> int:
    if torch.device(device).type != "cuda":
        return 0
    return int(torch.cuda.max_memory_allocated(device))


def work(batch, rows: Optional[np.ndarray] = None) -> dict:
    """What one batch asks of the kernels that process ``rows`` of it
    (None: all rows), and the live audio it trains or decodes (all rows,
    weight-1 rows only)."""
    f = batch.frame_lengths.astype(np.int64)
    ll = batch.label_lengths.astype(np.int64)
    if rows is not None:
        f, ll = f[rows], ll[rows]
    return {"t_pad": int(batch.feats.shape[1]), "rows": int(len(f)),
            "frames": int(f.sum()),
            "ctc_cells": int((f * (2 * ll + 1)).sum()),
            "ctc_emit": int((f * (ll + 1)).sum()),
            "audio_frames": float((batch.frame_lengths
                                   * batch.weights).sum())}


def nonfinite(values: List[float]) -> int:
    return int(sum(1 for v in values if not np.isfinite(v)))
