"""Training loop: epochs over bucketed batches, metrics, checkpoints, eval.

Counterpart of ``tpu_ctc.train.loop``: a plain loop over
``BucketedLoader.epoch`` calling the step of ``train.step.make_train_step``
(on a card, with one rank or NCCL ranks, its CUDA graphs of the step, one
per batch shape; on the CPU and on gloo ranks ``train_step`` itself),
JSONL metrics
(:class:`MetricsLogger`), checkpoints of the full state with the data
cursor (``train.checkpoint.save``), graceful exit on SIGTERM/SIGINT
(:class:`PreemptionGuard`), and greedy-CER/NLL evaluation, with the beam
search's corpus WER/CER too when ``train.eval_beam`` is set (the decoder's
n-gram LM trains on the train split's transcripts; on a TP or PP mesh it
decodes the log posteriors that the split eval gathers, so every mesh
decodes the whole model).  Batches reach the card
through ``data.prefetch.prefetch_to_device``: a thread runs the loader (and
the lazy manifest's frontend, or awaits its pool) and copies ahead of the
step.  The step's
metrics stay on the card; they are read (one synchronisation) every
``log_every`` steps.

On a mesh of ranks (``cfg.mesh``, the process group of
``parallel.distributed.initialize``) every rank plans the same global
batches and keeps its block (rows over 'data', frames over 'seq'), as the
JAX loop shards one global batch: its loader featurizes only the
utterances of its rows (``train.step.local_rows``; the eval loader those
its eval step reads, ``train.step.eval_rows``), and the prefetch thread
copies only the block to the rank's card, its labels cut to the global
batch's width (so every rank replays the same graph at every step).  A
lazy dataset's frontend pool is stopped when ``train`` returns or raises,
and the compiled steps' graphs are released before it returns or raises
(they keep NCCL's communicators alive).  Metrics, ``metrics.jsonl`` and
checkpoints are written by rank 0 while the others wait at a barrier; a
state split over 'model' (TP, PP) is gathered first
(``train.step.full_state``), so the file is the one-card file and a
checkpoint restores under any world size and mesh (PP's holds the stacked
layers).  The
ranks agree on a preemption request every step (one all-reduce of a flag,
read on the host), so all of them checkpoint and stop at the same step.
"""
from __future__ import annotations

import json
import os
import signal
import threading
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from tpu_ctc_torch import resolve_device
from tpu_ctc_torch.config import Config
from tpu_ctc_torch.data.alphabet import DEFAULT_ALPHABET
from tpu_ctc_torch.data.bucketing import Batch, BucketedLoader
from tpu_ctc_torch.data.prefetch import prefetch_to_device
from tpu_ctc_torch.decode.beam import make_beam_decoder
from tpu_ctc_torch.decode.lm import train_char_lm_from_data
from tpu_ctc_torch.decode.wer import cer, score_corpus
from tpu_ctc_torch.parallel.mesh import make_mesh
from tpu_ctc_torch.train import checkpoint
from tpu_ctc_torch.train.step import (TrainState, batch_to_tensors,
                                      create_train_state, eager_reason,
                                      eval_step, eval_rows, full_state,
                                      local_batch, local_rows,
                                      make_eval_step, make_train_step)


class MetricsLogger:
    """Structured JSONL metrics writer (one line per event)."""

    def __init__(self, path: Optional[str]):
        self.path = path
        self._f = open(path, "a") if path else None

    def log(self, **event):
        event.setdefault("time", time.time())
        if self._f:
            self._f.write(json.dumps(event) + "\n")
            self._f.flush()

    def close(self):
        if self._f:
            self._f.close()


class PreemptionGuard:
    """On SIGTERM/SIGINT a flag is set; the train loop checks it each
    step, writes a checkpoint with the exact data cursor and returns, so a
    ``--resume`` run continues mid-epoch.  Handlers install only on the main
    thread; elsewhere the guard is inert."""

    def __init__(self, enable: bool = True):
        self.requested = False
        self._prev = {}
        if enable and threading.current_thread() is threading.main_thread():
            for sig in (signal.SIGTERM, signal.SIGINT):
                try:
                    self._prev[sig] = signal.signal(sig, self._handler)
                except (ValueError, OSError):
                    pass

    def _handler(self, signum, frame):
        self.requested = True

    def restore(self):
        for sig, prev in self._prev.items():
            try:
                signal.signal(sig, prev)
            except (ValueError, OSError):
                pass


def batch_to_device_dict(batch: Batch) -> Dict[str, np.ndarray]:
    """The arrays a train, decode or eval step reads from a :class:`Batch`."""
    return {
        "feats": batch.feats, "frame_mask": batch.frame_mask,
        "frame_lengths": batch.frame_lengths, "labels": batch.labels,
        "label_lengths": batch.label_lengths, "weights": batch.weights,
    }


def evaluate(model, cfg: Config, loader: BucketedLoader, device,
             alphabet=None, max_batches: Optional[int] = None,
             beam_decode_fn=None, eval_fn=None) -> Dict[str, float]:
    """Greedy-decode CER (host edit distance) and mean NLL over an eval
    set, or over its first ``max_batches`` batches.  With
    ``beam_decode_fn`` (``train.eval_beam``, a
    ``decode.beam.make_beam_decoder`` function) it also beam-decodes each
    batch and reports the corpus WER/CER of the decoded text.
    ``eval_fn(model, batch)`` (``train.step.make_eval_step``) replaces
    ``train.step.eval_step`` when given; where its outputs hold the whole
    batch's ``log_probs`` (the split eval of a TP or PP mesh, whose
    ``model`` holds only this rank's shards or stage), the beam search
    decodes those instead of running ``model``."""
    alphabet = alphabet or DEFAULT_ALPHABET
    if eval_fn is None:
        def eval_fn(model, batch):
            return eval_step(model, cfg, batch)
    refs, hyps, nlls = [], [], []
    ref_texts, beam_texts = {}, {}
    for i, (_, batch) in enumerate(loader.epoch(0)):
        if max_batches is not None and i >= max_batches:
            break
        bd = batch_to_device_dict(batch)
        out = eval_fn(model, batch_to_tensors(bd, device))
        hyp = out["hyp"].cpu().numpy()
        hyp_len = out["hyp_len"].cpu().numpy()
        nll = out["nll"].cpu().numpy()
        if beam_decode_fn is not None:
            b_hyp, b_len = (t.cpu().numpy() for t in beam_decode_fn(
                model, bd, log_probs=out.get("log_probs")))
        for b in range(len(hyp)):
            if batch.weights[b] > 0:
                ref_ids = batch.labels[b][: batch.label_lengths[b]]
                refs.append(list(ref_ids))
                hyps.append(list(hyp[b][: hyp_len[b]]))
                nlls.append(float(nll[b]))
                if beam_decode_fn is not None:
                    utt = f"e{i}b{b}"
                    ref_texts[utt] = alphabet.decode(ref_ids)
                    beam_texts[utt] = alphabet.decode(b_hyp[b][: b_len[b]])
    result = {"cer": cer(refs, hyps),
              "nll": float(np.mean(nlls)) if nlls else 0.0,
              "num_utts": len(refs)}
    if ref_texts:
        result.update(
            beam_wer=score_corpus(ref_texts, beam_texts, "word")[0][
                "error_rate"],
            beam_cer=score_corpus(ref_texts, beam_texts, "char")[0][
                "error_rate"])
    return result


def _agreed(mesh, flag: bool, device) -> bool:
    """``flag`` on any rank of the mesh (one all-reduce, read on the
    host); ``flag`` itself on one rank."""
    if mesh.size == 1:
        return flag
    x = torch.tensor([int(flag)], dtype=torch.int32, device=device)
    dist.all_reduce(x, op=dist.ReduceOp.MAX)
    return bool(x.item())


def train(cfg: Config,
          train_data: Sequence[Tuple[np.ndarray, np.ndarray]],
          eval_data: Optional[Sequence[Tuple[np.ndarray, np.ndarray]]] = None,
          work_dir: Optional[str] = None, resume: bool = False,
          device=None, alphabet=None,
          mesh=None) -> Tuple[TrainState, Dict[str, float]]:
    """Run the training job on ``device`` (default ``cuda``) and the mesh
    of ``cfg.mesh`` over the process group (one rank without one) unless
    ``mesh`` is given; returns (final state, last logged metrics).  The
    datasets' frontend pools (``ManifestDataset.close``) are stopped at
    the end, on preemption and on an error."""
    device = resolve_device(device)
    if mesh is None:
        mesh = make_mesh(cfg.mesh)
    try:
        return _train(cfg, train_data, eval_data, work_dir, resume, device,
                      alphabet, mesh)
    finally:
        for data in (train_data, eval_data):
            if hasattr(data, "close"):
                data.close()


def _train(cfg, train_data, eval_data, work_dir, resume, device, alphabet,
           mesh):
    lead = mesh.rank == 0

    def barrier():
        if mesh.size > 1:
            dist.barrier()

    loader = BucketedLoader(train_data, cfg.data,
                            rows=local_rows(mesh, cfg.data.batch_size))
    eval_loader = (BucketedLoader(eval_data, cfg.data,
                                  rows=eval_rows(cfg, mesh))
                   if eval_data is not None else None)
    if loader.num_dropped and lead:
        print(f"[data] dropped {loader.num_dropped} utterances longer than "
              f"{cfg.data.bucket_boundaries[-1]} frames")

    work_dir = work_dir or "."
    os.makedirs(work_dir, exist_ok=True)
    logger = MetricsLogger(os.path.join(work_dir, cfg.train.metrics_path)
                           if cfg.train.metrics_path and lead else None)
    ckpt_dir = os.path.join(work_dir, cfg.train.checkpoint_dir)
    keep = cfg.train.keep_checkpoints

    def save(state, epoch, cursor):
        whole = full_state(state)       # shards gathered on every rank
        if lead:
            checkpoint.save(ckpt_dir, whole, epoch, cursor, keep)
        barrier()

    state = create_train_state(cfg, device=device)
    start_epoch, start_batch = 0, 0
    if resume:
        restored = checkpoint.restore(ckpt_dir, state)
        if restored is not None:
            state, start_epoch, start_batch = restored
            if lead:
                print(f"[ckpt] resumed at epoch {start_epoch} batch "
                      f"{start_batch} step {state.step}")
    step_fn, state = make_train_step(cfg, mesh, state)
    eval_fn = make_eval_step(cfg, mesh, device)
    if lead:
        why = eager_reason(cfg, mesh, device)
        print(f"[step] {mesh.size} rank(s), mesh {mesh.shape}: "
              + ("one CUDA graph per batch shape" if why is None
                 else f"eager: {why}"))

    # A graph that holds NCCL operations keeps its communicator alive, and
    # an exception's traceback keeps this frame: release them here, or
    # the caller's destroy_process_group waits for ever.
    try:
        beam_decode_fn = None
        if cfg.train.eval_beam and eval_loader is not None:
            lm = train_char_lm_from_data(train_data, cfg)
            beam_decode_fn = make_beam_decoder(cfg, lm=lm, device=device)

        last_metrics: Dict[str, float] = {}
        t_start = time.time()
        guard = PreemptionGuard()
        t_win, audio_win, steps_win = time.time(), 0.0, 0
        for epoch in range(start_epoch, cfg.train.num_epochs):
            sb = start_batch if epoch == start_epoch else 0
            for cursor, batch, dev_batch in prefetch_to_device(
                    loader.epoch(epoch, sb), device,
                    select=lambda arrays: local_batch(arrays, mesh)):
                if _agreed(mesh, guard.requested, device):
                    save(state, epoch, cursor)
                    logger.log(kind="preempted", epoch=epoch, cursor=cursor,
                               step=state.step)
                    logger.close()
                    guard.restore()
                    if lead:
                        print(f"[preempt] checkpointed at step {state.step} "
                              f"(epoch {epoch}, batch {cursor}); exiting")
                    return state, last_metrics
                state, m = step_fn(state, dev_batch)
                audio_win += batch.audio_seconds()
                steps_win += 1
                if state.step % cfg.train.log_every == 0:
                    # Reading the metrics waits for the card.
                    m = {k: float(v) for k, v in m.items()}
                    dt = time.time() - t_win
                    m.update(step=state.step, epoch=epoch,
                             audio_s_per_s=audio_win / max(dt, 1e-9),
                             step_time_s=dt / max(steps_win, 1))
                    logger.log(kind="train", **m)
                    last_metrics = m
                    t_win, audio_win, steps_win = time.time(), 0.0, 0
                if cfg.train.checkpoint_every and \
                        state.step % cfg.train.checkpoint_every == 0:
                    t0 = time.time()
                    save(state, epoch, cursor + 1)
                    t_win += time.time() - t0     # exclude the save
                if (eval_loader is not None and cfg.train.eval_every
                        and state.step % cfg.train.eval_every == 0):
                    t0 = time.time()
                    ev = evaluate(state.model, cfg, eval_loader, device,
                                  alphabet=alphabet,
                                  beam_decode_fn=beam_decode_fn,
                                  eval_fn=eval_fn)
                    logger.log(kind="eval", step=state.step, **ev)
                    t_win += time.time() - t0     # exclude the eval
            logger.log(kind="epoch_end", epoch=epoch,
                       wall_s=time.time() - t_start)
        guard.restore()
        save(state, cfg.train.num_epochs, 0)
        logger.close()
        return state, last_metrics
    finally:
        for fn in (step_fn, eval_fn):
            if hasattr(fn, "release"):
                fn.release()
