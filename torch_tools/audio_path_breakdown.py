#!/usr/bin/env python
"""Where a training step from audio spends its time, on the host and the card.

The port trains from audio files through ``ManifestDataset`` (payload reads
and the frontend on the host CPU), ``BucketedLoader`` (``make_batch``) and
``prefetch_to_device`` (pin and copy on a side stream), then the step of
``make_train_step`` (on a card one CUDA graph per batch shape).  This tool
takes that path apart, for each shape and each frontend pool size given
(``ManifestDataset(workers=N)``; 0 is the in-process path):

* a corpus: ``preset2`` is preset 2 at its full width (H = 1024, B = 32,
  buckets (200, 400, 800)) on synthetic tone waveforms of 4-8 s written as
  WAV files (``synthetic_audio_batch``); ``chain`` is ``docs/EVAL.md``'s
  chain shape (preset 2 at H = 512, B = 16, buckets (80, 160, 320), labels
  <= 64) on SPHERE files from ``make_sample_corpus.py``;
* per utterance, on the host alone: the payload read, and the frontend on
  the read waveform, split into the operators' own time (their self time
  under ``torch.profiler``) and the rest (Python, dispatch, allocation);
* ``ManifestDataset``'s audio-s/s over an epoch's batches alone, and again
  in a thread while the main thread runs the step on batches held on
  the device (the GIL's and the cores' share), with the step's ms alone
  and so contended;
* the step on features in memory (the epoch's batches copied once): ms a
  step, audio-s/s, the step's host time to its return and the device's
  idle share, for the compiled step and, for the record, the eager
  ``train_step`` on the same state;
* the epoch through an instrumented copy of the prefetch thread, per batch:
  the loader's featurization (reads and frontend apart when in process),
  ``make_batch``, pin plus copy, the consumer's wait in ``queue.get``, the
  step's host time up to its return (its last launch: the step does
  not synchronise) and the step's wall;
* the same epochs through the real ``prefetch_to_device``: ms a step,
  audio-s/s and the device's busy time and idle share (union of the device
  intervals of a ``torch.profiler`` trace of the card's activity alone
  over one epoch: a trace of the host's operators too would record the
  in-process frontend's and slow the epoch it measures);
* ``torch.get_num_threads()`` and ``os.sched_getaffinity``.

Usage (the card; numbers are the card's and its host's, printed with
``nvidia-smi``'s name and power limit):
  python3 torch_tools/audio_path_breakdown.py [--shapes preset2,chain]
      [--workers 0,host] [--epochs 3] [--json FILE]
On the CPU, at a cut size (the step then runs on the CPU too; device
numbers are "not measured"):
  python3 torch_tools/audio_path_breakdown.py --device cpu --utts 12 \
      --hidden 16 --layers 1 --batch 4 --epochs 2

``host`` in ``--workers`` is ``manifest.host_workers()``, the pool size
the CLI gives a loader on a card.
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import queue
import shutil
import statistics
import sys
import threading
import time

import numpy as np

if __package__ in (None, ""):          # run as a script, not imported
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

import torch  # noqa: E402

SHAPES = {
    "preset2": {"config": "timit_full_3layer", "set": {}},
    "chain": {"config": "timit_full_3layer",
              "set": {"model.hidden_dim": 512, "data.batch_size": 16,
                      "data.bucket_boundaries": (80, 160, 320),
                      "data.max_label_len": 64}},
}
DEFAULT_UTTS = {"preset2": 96, "chain": 608}


def tone_corpus(root, fe, seed, splits=(("train", 96), ("valid", 32))):
    """A manifest corpus of synthetic tone waveforms (50-100 characters of
    1280 samples, 4-8 s: 400-800 frames) in ``root``, one WAV file an
    utterance, a split of ``n`` utterances from seed ``seed + k`` for the
    k-th of ``splits``.  Returns {split: (waveforms, sample lengths)}."""
    from tpu_ctc_torch.data import audio_io
    from tpu_ctc_torch.data.alphabet import DEFAULT_ALPHABET
    from tpu_ctc_torch.data.manifest import write_manifest
    from tpu_ctc_torch.data.synthetic import synthetic_audio_batch
    os.makedirs(root, exist_ok=True)
    out = {}
    for k, (split, n) in enumerate(splits):
        audio, sl, labels, ll = synthetic_audio_batch(
            n, 8 * fe.sample_rate, sample_rate=fe.sample_rate, min_chars=50,
            max_chars=100, seed=seed + k, samples_per_char=1280)
        recs = []
        for i in range(n):
            name = f"{split}_{i:03d}.wav"
            audio_io.write_wav(os.path.join(root, name), audio[i, :sl[i]],
                               fe.sample_rate)
            recs.append({"id": f"{split}-{i:03d}", "audio": name,
                         "text": DEFAULT_ALPHABET.decode(labels[i, :ll[i]]),
                         "samples": int(sl[i]), "rate": fe.sample_rate})
        write_manifest(root, split, recs)
        out[split] = (audio, sl)
    return out


def sample_corpus(root, n, seed):
    """``make_sample_corpus.py``'s SPHERE tree of ``n`` utterances under
    ``root``/tree and its TIMIT-layout manifest (all of it the train
    split) in ``root``/manifests; returns the manifests' directory."""
    from torch_tools import make_manifest, make_sample_corpus
    tree, man = os.path.join(root, "tree"), os.path.join(root, "manifests")
    with open(os.devnull, "w") as null:
        stdout, sys.stdout = sys.stdout, null
        try:
            make_sample_corpus.main(["--out", tree, "--n", str(n),
                                     "--seed", str(seed)])
            make_manifest.main(["--layout", "timit", "--src", tree,
                                "--out", man])
        finally:
            sys.stdout = stdout
    return man


def host_info():
    return {"torch_threads": torch.get_num_threads(),
            "affinity": len(os.sched_getaffinity(0)),
            "cpu_count": os.cpu_count()}


def med(xs):
    return float(statistics.median(xs)) if xs else None


def device_busy_ms(prof) -> float:
    """Union of the device-side intervals (kernels, copies, sets) of a
    ``torch.profiler`` trace, in ms: time the card was busy."""
    from torch.autograd import DeviceType
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy, end = 0, None
    for s, e in spans:
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy / 1e3


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def featurize(ds, ids):
    """The items ``ids`` of ``ds`` as the loader asks for them."""
    return ds.fetch(ids)()


def per_utterance(ds, ids, limit=64, profiled=16):
    """Reads and the frontend apart, one utterance at a time in this
    thread: ms each (medians), and the frontend's operators' self time
    under ``torch.profiler`` against its whole time on the same waves."""
    from torch.profiler import ProfilerActivity, profile

    from tpu_ctc_torch.data import audio_io
    fe = ds.cfg.frontend
    read_ms, fe_ms, waves = [], [], []
    for i in ids[:limit]:
        path = ds._abspath(ds.records[i]["audio"])
        t0 = time.perf_counter()
        wav, _ = audio_io.read_audio(path, target_rate=fe.sample_rate)
        t1 = time.perf_counter()
        ds._process_audio(wav, utt_index=i)
        t2 = time.perf_counter()
        read_ms.append((t1 - t0) * 1e3)
        fe_ms.append((t2 - t1) * 1e3)
        waves.append((i, wav))
    some = waves[:profiled]
    t0 = time.perf_counter()
    for i, wav in some:
        ds._process_audio(wav, utt_index=i)
    whole = (time.perf_counter() - t0) * 1e3 / len(some)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t0 = time.perf_counter()
        for i, wav in some:
            ds._process_audio(wav, utt_index=i)
        traced = (time.perf_counter() - t0) * 1e3 / len(some)
    ops = sum(e.self_cpu_time_total for e in prof.key_averages()) / 1e3
    ops /= len(some)
    audio_s = sum(len(w) for _, w in waves) / fe.sample_rate
    return {"utts": len(waves), "audio_s": audio_s,
            "read_ms": med(read_ms), "frontend_ms": med(fe_ms),
            "read_ms_sum": sum(read_ms), "frontend_ms_sum": sum(fe_ms),
            "frontend_ms_profiled_set": whole,
            "frontend_ms_traced": traced,
            "frontend_ops_self_ms": ops,
            "frontend_rest_ms": traced - ops}


def dataset_rate(ds, plan, frames_per_s=100.0):
    """Audio-s/s of the loader's featurization of ``plan``'s batches."""
    t0 = time.perf_counter()
    frames = 0
    for _, ids in plan:
        frames += sum(len(f) for f, _ in featurize(ds, ids))
    return frames / frames_per_s / (time.perf_counter() - t0)


def step_loop(state, step_fn, tensors, dev, stop=None, steps=None,
              host=None):
    """``step_fn`` over ``tensors`` in turn until ``stop`` is set or
    ``steps`` are done, each call's host ms (to its return) appended to
    ``host`` when given; returns (state, ms a step)."""
    n = 0
    sync(dev)
    t0 = time.perf_counter()
    while (steps is None or n < steps) and not (stop and stop.is_set()):
        h0 = time.perf_counter()
        state, _ = step_fn(state, tensors[n % len(tensors)])
        if host is not None:
            host.append((time.perf_counter() - h0) * 1e3)
        n += 1
    sync(dev)
    return state, (time.perf_counter() - t0) * 1e3 / max(n, 1)


def contended(ds, plan, state, step_fn, tensors, dev):
    """``dataset_rate`` in a thread while this thread runs the step;
    returns (the dataset's audio-s/s, the step's ms) so contended."""
    out, stop = {}, threading.Event()

    def reader():
        try:
            out["rate"] = dataset_rate(ds, plan)
        finally:
            stop.set()
    th = threading.Thread(target=reader)
    th.start()
    state, ms = step_loop(state, step_fn, tensors, dev, stop=stop)
    th.join()
    return out["rate"], ms, state


def instrumented_epoch(loader, epoch, state, step_fn, cfg, dev, in_process):
    """One epoch through a copy of ``prefetch_to_device``'s thread with
    every stage timed; per batch a dict of ms."""
    from tpu_ctc_torch.data import audio_io
    from tpu_ctc_torch.data.bucketing import (_label_pad_for, cut_labels,
                                              make_batch)
    from tpu_ctc_torch.train.loop import batch_to_device_dict
    ds, dcfg = loader.dataset, loader.cfg
    fe = cfg.frontend
    plan = loader._epoch_order(epoch)
    q: "queue.Queue" = queue.Queue(maxsize=2)
    stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None

    def worker():
        for cursor, (b, ids) in enumerate(plan):
            rec = {"batch": cursor, "utts": len(ids)}
            t0 = time.perf_counter()
            if in_process:
                reads = fronts = 0.0
                utts = []
                for i in ids:
                    r0 = time.perf_counter()
                    wav, _ = audio_io.read_audio(
                        ds._abspath(ds.records[i]["audio"]),
                        target_rate=fe.sample_rate)
                    r1 = time.perf_counter()
                    utts.append((ds._process_audio(wav, utt_index=i),
                                 ds._labels[i]))
                    reads += r1 - r0
                    fronts += time.perf_counter() - r1
                rec.update(read_ms=reads * 1e3, frontend_ms=fronts * 1e3)
            else:
                utts = featurize(ds, ids)
            t1 = time.perf_counter()
            t_pad = dcfg.bucket_boundaries[b]
            batch = make_batch(utts, t_pad,
                               _label_pad_for(t_pad, dcfg.max_label_len),
                               dcfg.batch_size, indices=ids)
            t2 = time.perf_counter()
            arrays = cut_labels(batch_to_device_dict(batch))
            if stream is None:
                tens = {k: torch.as_tensor(v) for k, v in arrays.items()}
                event = None
            else:
                with torch.cuda.stream(stream):
                    tens = {k: torch.from_numpy(np.ascontiguousarray(v))
                            .pin_memory().to(dev, non_blocking=True)
                            for k, v in arrays.items()}
                    event = torch.cuda.Event()
                    event.record(stream)
            t3 = time.perf_counter()
            rec.update(fetch_ms=(t1 - t0) * 1e3, make_batch_ms=(t2 - t1) * 1e3,
                       pin_copy_ms=(t3 - t2) * 1e3,
                       audio_s=batch.audio_seconds())
            q.put((rec, tens, event))
        q.put(None)

    th = threading.Thread(target=worker, daemon=True)
    sync(dev)
    th.start()
    recs = []
    t_prev = time.perf_counter()
    while True:
        g0 = time.perf_counter()
        item = q.get()
        g1 = time.perf_counter()
        if item is None:
            break
        rec, tens, event = item
        if event is not None:
            cur = torch.cuda.current_stream(dev)
            cur.wait_event(event)
            for t in tens.values():
                t.record_stream(cur)
        s0 = time.perf_counter()
        state, _ = step_fn(state, tens)
        s1 = time.perf_counter()
        sync(dev)          # the step's wall ends when the card is done
        t_now = time.perf_counter()
        rec.update(get_wait_ms=(g1 - g0) * 1e3, step_host_ms=(s1 - s0) * 1e3,
                   step_wall_ms=(t_now - t_prev) * 1e3)
        t_prev = t_now
        recs.append(rec)
    th.join()
    return recs, state


def real_epochs(loader, epochs, state, step_fn, dev):
    """``epochs`` epochs through ``prefetch_to_device`` and the step as
    ``train.loop.train`` runs them (no synchronisation in between);
    returns (ms a step, audio-s/s, steps, state) of the epochs after the
    first (a warm-up)."""
    from tpu_ctc_torch.data.prefetch import prefetch_to_device
    audio, steps, t0 = 0.0, 0, None
    for e in range(epochs):
        if e == 1:
            sync(dev)
            t0 = time.perf_counter()
        for _, batch, tb in prefetch_to_device(loader.epoch(e), dev):
            state, _ = step_fn(state, tb)
            if e >= 1:
                audio += batch.audio_seconds()
                steps += 1
    sync(dev)
    wall = time.perf_counter() - t0
    return wall * 1e3 / steps, audio / wall, steps, state


def profiled_epoch(loader, state, step_fn, dev):
    """One epoch of the real path under ``torch.profiler``: (wall ms,
    device busy ms) or None on the CPU or when the trace holds no device
    time."""
    if dev.type != "cuda":
        return None
    from torch.profiler import ProfilerActivity, profile

    from tpu_ctc_torch.data.prefetch import prefetch_to_device
    sync(dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _, _, tb in prefetch_to_device(loader.epoch(1), dev):
            state, _ = step_fn(state, tb)
        sync(dev)
        wall = (time.perf_counter() - t0) * 1e3
    busy = device_busy_ms(prof)
    return None if busy <= 0 else (wall, busy)


def in_memory(loader, state, step_fn, dev, epochs):
    """The step on the epoch's batches held on the device: ({"ms" a step,
    "rate" audio-s/s, "idle" share or None, "host_ms" a step's host time
    to its return (median), "steps"}, the tensors, state)."""
    from tpu_ctc_torch.train import step
    from tpu_ctc_torch.train.loop import batch_to_device_dict
    batches = [b for _, b in loader.epoch(1)]
    tensors = [step.batch_to_tensors(batch_to_device_dict(b), dev)
               for b in batches]
    audio = sum(b.audio_seconds() for b in batches)
    state, _ = step_loop(state, step_fn, tensors, dev, steps=len(tensors))
    n = len(tensors) * max(epochs - 1, 1)
    host = []
    state, ms = step_loop(state, step_fn, tensors, dev, steps=n, host=host)
    idle = None
    if dev.type == "cuda":
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            state, _ = step_loop(state, step_fn, tensors, dev,
                                 steps=len(tensors))
            wall = (time.perf_counter() - t0) * 1e3
        busy = device_busy_ms(prof)
        idle = 1 - busy / wall if busy > 0 else None
    rate = audio / len(tensors) / (ms / 1e3)
    return {"ms": ms, "rate": rate, "idle": idle, "host_ms": med(host),
            "steps": len(tensors)}, tensors, state


def run_shape(shape, workers_list, args, dev, log=print):
    """All the measurements of one shape, for each pool size; returns the
    shape's record."""
    from tpu_ctc_torch.config import get_config
    from tpu_ctc_torch.data.bucketing import BucketedLoader
    from tpu_ctc_torch.data.manifest import ManifestDataset
    from tpu_ctc_torch.parallel.mesh import make_mesh
    from tpu_ctc_torch.train import step

    dev = torch.device(dev)
    over = dict(SHAPES[shape]["set"])
    if args.hidden:
        over["model.hidden_dim"] = args.hidden
    if args.layers:
        over["model.num_bi_layers"] = args.layers
    if args.batch:
        over["data.batch_size"] = args.batch
    cfg = get_config(SHAPES[shape]["config"], **over)
    n = args.utts or DEFAULT_UTTS[shape]
    root = os.path.join(args.out, shape)
    shutil.rmtree(root, ignore_errors=True)
    if shape == "preset2":
        tone_corpus(root, cfg.frontend, args.seed, splits=(("train", n),))
        man = root
    else:
        man = sample_corpus(root, n, args.seed)
    record = {"shape": shape, "utts": n, "hidden": cfg.model.hidden_dim,
              "layers": cfg.model.num_bi_layers,
              "batch": cfg.data.batch_size,
              "buckets": list(cfg.data.bucket_boundaries),
              "host": host_info(), "runs": []}
    log(f"[audio_path] {shape}: {n} utterances, H={cfg.model.hidden_dim}, "
        f"{cfg.model.num_bi_layers} BiRNN layers, B={cfg.data.batch_size}, "
        f"buckets {tuple(cfg.data.bucket_boundaries)}; host "
        f"{record['host']}")

    ds0 = ManifestDataset(man, cfg)
    loader0 = BucketedLoader(ds0, cfg.data)
    plan = loader0._epoch_order(1)
    ids = [i for _, b in plan for i in b]
    pu = per_utterance(ds0, ids)
    record["per_utterance"] = pu
    log(f"[audio_path] {shape}: per utterance (host alone, {pu['utts']} "
        f"utterances, {pu['audio_s']:.1f} audio s): read "
        f"{pu['read_ms']:.3f} ms, frontend {pu['frontend_ms']:.3f} ms "
        f"(medians; sums {pu['read_ms_sum']:.1f} and "
        f"{pu['frontend_ms_sum']:.1f} ms); the frontend on 16 of them "
        f"{pu['frontend_ms_profiled_set']:.3f} ms each, under the profiler "
        f"{pu['frontend_ms_traced']:.3f} ms: operators' self time "
        f"{pu['frontend_ops_self_ms']:.3f} ms, the rest (Python between "
        f"them) {pu['frontend_rest_ms']:.3f} ms")

    # the step a run makes (make_train_step: on a card one CUDA graph per
    # batch shape), and the eager train_step on the same state for the
    # record; both update the state's tensors in place
    step_fn, state = step.make_train_step(
        cfg, make_mesh(cfg.mesh), step.create_train_state(cfg, device=dev))
    eager = functools.partial(step.train_step, cfg=cfg)
    for name, fn in (("in_memory_eager", eager), ("in_memory", step_fn)):
        record[name], tensors, state = in_memory(loader0, state, fn, dev,
                                                 args.epochs)
        mem = record[name]
        idle = ("not measured" if mem["idle"] is None
                else f"{mem['idle']:.3f}")
        log(f"[audio_path] {shape}: features in memory, "
            f"{'eager train_step' if fn is eager else 'make_train_step'}: "
            f"{mem['ms']:.2f} ms a step, {mem['rate']:.1f} audio-s/s, host "
            f"{mem['host_ms']:.3f} ms a step to return, idle share {idle}")
    mem_rate = record["in_memory"]["rate"]
    if hasattr(step_fn, "stats"):
        record["graphs"] = step_fn.stats()
        log(f"[audio_path] {shape}: {record['graphs']['shapes']} batch "
            f"shapes captured, in "
            f"{[round(x, 3) for x in record['graphs']['capture_s']]} s")

    for w in workers_list:
        if w == "host":
            from tpu_ctc_torch.data.manifest import host_workers
            n_w = host_workers()
        else:
            n_w = int(w)
        ds = ManifestDataset(man, cfg, workers=n_w) if n_w else ds0
        try:
            loader = BucketedLoader(ds, cfg.data)
            featurize(ds, plan[0][1])            # a started pool
            run = {"workers": n_w}
            run["dataset_rate"] = dataset_rate(ds, plan)
            rate_c, ms_c, state = contended(ds, plan, state, step_fn,
                                            tensors, dev)
            run.update(dataset_rate_contended=rate_c, step_ms_contended=ms_c)
            recs = []
            for e in range(args.epochs):
                r, state = instrumented_epoch(loader, 1, state, step_fn,
                                              cfg, dev, in_process=n_w == 0)
                if e:
                    recs += r
            run["batches"] = recs
            keys = [k for k in recs[0] if k.endswith("_ms")]
            run["medians"] = {k: med([r[k] for r in recs]) for k in keys}
            ms, rate, steps, state = real_epochs(loader, args.epochs, state,
                                                 step_fn, dev)
            run.update(ms=ms, rate=rate, steps=steps)
            prof = profiled_epoch(loader, state, step_fn, dev)
            run["busy_ms"], run["idle"] = (
                (None, None) if prof is None else
                (prof[1] / len(plan), 1 - prof[1] / prof[0]))
        finally:
            if n_w and hasattr(ds, "close"):
                ds.close()
        record["runs"].append(run)
        report(shape, run, mem_rate, log, per_batch=args.per_batch)
    return record


def report(shape, run, mem_rate, log, per_batch=True):
    w = run["workers"]
    tag = f"[audio_path] {shape} workers={w}"
    if per_batch:
        for r in run["batches"]:
            log(f"{tag} batch {r['batch']}: " + ", ".join(
                f"{k[:-3]} {v:.2f}" for k, v in r.items()
                if k.endswith("_ms")) + f" ms; {r['audio_s']:.1f} audio s")
    m = run["medians"]
    log(f"{tag}: medians (ms) " + ", ".join(
        f"{k[:-3]} {v:.2f}" for k, v in m.items()))
    log(f"{tag}: ManifestDataset {run['dataset_rate']:.1f} audio-s/s alone, "
        f"{run['dataset_rate_contended']:.1f} while the step runs (the step "
        f"then {run['step_ms_contended']:.2f} ms)")
    idle = ("not measured" if run["idle"] is None else
            f"{run['idle']:.3f} (device busy {run['busy_ms']:.2f} ms a step)")
    log(f"{tag}: prefetch_to_device + make_train_step's step: "
        f"{run['ms']:.2f} ms a step over {run['steps']} steps, "
        f"{run['rate']:.1f} audio-s/s = {run['rate'] / mem_rate:.3f} of "
        f"features in memory; idle share {idle}")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--shapes", default="preset2,chain")
    p.add_argument("--workers", default="0,host",
                   help="frontend pool sizes, comma-separated; 'host' is "
                        "manifest.host_workers()")
    p.add_argument("--epochs", type=int, default=3,
                   help="epochs a run; the first is a warm-up")
    p.add_argument("--utts", type=int, default=0,
                   help="utterances a corpus (default: the shape's)")
    p.add_argument("--hidden", type=int, default=0)
    p.add_argument("--layers", type=int, default=0)
    p.add_argument("--batch", type=int, default=0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--no-per-batch", dest="per_batch", action="store_false",
                   help="print medians only (the JSON keeps every batch)")
    p.add_argument("--out", default=os.path.join("build", "audio_path"),
                   help="where the corpora are written")
    p.add_argument("--json", default=None, help="write the records here")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    from tpu_ctc_torch import resolve_device
    from tpu_ctc_torch.utils.profiling import card_line
    dev = resolve_device(args.device)
    if args.epochs < 2:
        raise SystemExit("--epochs must be at least 2 (one warm-up)")
    result = {"card": card_line(dev), "shapes": []}
    print(f"[audio_path] device {result['card']}")
    for shape in args.shapes.split(","):
        result["shapes"].append(
            run_shape(shape, args.workers.split(","), args, dev))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
