"""A decode cell: the pool through the port's loader, one batch at a time
(as the port's decode job reads it, without prefetch), into the port's
decode entry point, ``make_beam_decoder``'s ``decode``, called as the
port's CLI calls it: the acoustic model's log posteriors, then the prefix
beam search on them (kernel B5 or B6, then the walk), to hypotheses and
lengths on the host.  A closed loop: the next batch is read once a call
has returned.

Set-up makes the pool, the weights and the port's trigram LM from the
transcripts, and runs one batch of every bucket.  The window's calls are
kept (hypotheses on the host), and so are the host batches of a sample of
them, drawn from the seed, and of the first call of the longest bucket.
Once the window has closed and the peak memory is read, the program's
log posteriors of those batches are computed again, by the function that
``decode`` calls, for the check.
"""
from __future__ import annotations

import gc
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from ctcbench import checks, common
from ctcbench.generator import make_pool
from ctcbench.trace import Spans, profiler, summarise
from ctcbench.weights import make_weights, stream_seed

SAMPLED_CALLS = 2          # kept at random, besides the longest


def _on_host(out) -> Tuple[np.ndarray, np.ndarray]:
    hyps, lens = out
    return hyps.cpu().numpy(), lens.cpu().numpy()


def measure(run) -> Tuple[dict, Optional[dict]]:
    from tpu_ctc_torch.decode.beam import make_beam_decoder
    from tpu_ctc_torch.decode.lm import train_ngram_lm
    from tpu_ctc_torch.models import birnn
    from tpu_ctc_torch.train.loop import batch_to_device_dict

    cfg = run.config
    dev = torch.device(run.device)
    stages: List[list] = []
    model_spec = run.cfg_file["port"]["model"]
    pool = make_pool(run.traffic, stream_seed(run.seed, "pool"),
                     model_spec["vocab_size"], dev)
    common.stage(run, stages, "pool")
    w0 = make_weights(model_spec, run.cfg_file["weights"], run.seed, dev)
    model = birnn.BiRNN(cfg.model, device=dev)
    with torch.no_grad():
        for k, p in model.named_parameters():
            p.requires_grad_(False)
            p.copy_(w0[k])
    del w0
    lm = train_ngram_lm([lab for _, lab in pool], cfg.model.vocab_size,
                        order=cfg.decode.lm_order)
    decode = make_beam_decoder(cfg, lm=lm, device=dev)
    common.stage(run, stages, "weights and LM")
    ldr = common.loader(pool, cfg)
    start = run.traffic["start_epoch"]
    warm = {}
    for b, ids in common.plan(ldr, start, 1):
        warm.setdefault(b, ids)
    for b in sorted(warm):
        _on_host(decode(model, batch_to_device_dict(
            common.host_batch(ldr, b, warm[b]))))
    common.sync(dev)
    common.stage(run, stages, "one call a bucket")

    rng = np.random.default_rng(stream_seed(run.seed, "sample"))
    spans = Spans(keep=run.trace)
    calls: List[dict] = []
    kept = {}                  # call index -> its host batch
    longest = None
    gen = common.batches(ldr, start)
    before = common.launches()
    prof = profiler() if run.trace else None
    if prof is not None:
        prof.start()
    common.sync(dev)
    t_setup = time.time()
    t0 = time.time_ns()
    limit = int(run.seconds * 1e9)
    while True:
        with spans.span("input"):
            _, batch = next(gen)
        a = time.time_ns()
        with spans.span("decode_call"):
            hyps, lens = _on_host(decode(model, batch_to_device_dict(batch)))
        b = time.time_ns()
        i = len(calls)
        calls.append(dict(common.work(batch), ms=(b - a) / 1e6,
                          ids=[int(x) for x in batch.utt_indices],
                          rows_real=int(batch.weights.sum()),
                          hyps=[h[:n].tolist() for h, n in zip(hyps, lens)],
                          max_len=int(hyps.shape[1])))
        # a reservoir of SAMPLED_CALLS calls, uniform over those made
        if i < SAMPLED_CALLS:
            kept[i] = batch
        else:
            j = int(rng.integers(0, i + 1))
            if j < SAMPLED_CALLS:
                kept.pop(sorted(kept)[j])
                kept[i] = batch
        if longest is None or batch.feats.shape[1] > longest[1].feats.shape[1]:
            longest = (i, batch)
        if b - t0 >= limit:
            break
    common.sync(dev)
    t1 = time.time_ns()
    summary = None
    if prof is not None:
        prof.stop()
        summary = summarise(prof, t0, t1, spans)
        del prof
    kept[longest[0]] = longest[1]
    failed = sum(1 for c in calls for h in c["hyps"]
                 if len(h) > c["max_len"])
    peak = common.memory_peak(dev)
    lps = {}
    with torch.no_grad():
        for i, bt in kept.items():
            bd = batch_to_device_dict(bt)
            lps[i] = birnn.log_posteriors(
                model, cfg.model, torch.as_tensor(bd["feats"], device=dev),
                torch.as_tensor(bd["frame_mask"], device=dev))
    record = {
        "kind": "decode", "rank": 0, "stages": stages,
        "setup_end": t_setup,
        "window_s": (t1 - t0) / 1e9, "steps": calls, "spans": spans.totals,
        "launches": common.launch_delta(before),
        "attempted": sum(c["rows_real"] for c in calls), "failed": failed,
        "memory_peak_bytes": peak,
        "device_kind": (torch.cuda.get_device_name(dev)
                        if dev.type == "cuda" else "cpu"),
        "trace": summary,
        "audio_s": sum(c["audio_frames"] for c in calls)
        / run.traffic["frames_per_second"],
    }
    del model, decode
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return record, {"pool": pool, "kept": lps}


def reference_forward(run, pool, entries, device, q=None):
    """The LM table the reference rebuilds from the transcripts, and for
    each (bucket, ids) batch its reference copy and the reference's log
    posteriors [n, T, A] (products through ``q``: exact, or the
    control's fp8)."""
    from ctcbench.reference import lm as ref_lm
    from ctcbench.reference.model import log_posteriors, no_tf32
    from ctcbench.reference.quant import exact

    port = run.cfg_file["port"]
    bounds = port["data"]["bucket_boundaries"]
    dev = torch.device(device)
    no_tf32()
    table = ref_lm.train([lab for _, lab in pool],
                         port["model"]["vocab_size"],
                         port["decode"]["lm_order"],
                         run.cfg_file["lm"]["add_k"])
    w0 = make_weights(port["model"], run.cfg_file["weights"], run.seed, dev)
    out = []
    for b, ids in entries:
        batch = common.ref_batch(pool, ids, bounds[b])
        with torch.no_grad():
            lp = log_posteriors(
                w0, port["model"], torch.as_tensor(batch["feats"]).to(dev),
                torch.as_tensor(batch["frame_mask"]).to(dev), q or exact)
        out.append((batch, lp))
    return table, out


def search(run, table, batch, lp, dtype=torch.float32):
    """The reference search's hypotheses on log posteriors ``lp``
    [n, T, A] of ``batch``, its scores summed in ``dtype``."""
    from ctcbench.reference import beam
    port = run.cfg_file["port"]
    d = port["decode"]
    t_pad = batch["feats"].shape[1]
    # the hypothesis's room: twice the loader's label padding + 16
    l_pad = min(port["data"]["max_label_len"], t_pad)
    hyps, lens, _ = beam.search(
        lp, torch.as_tensor(batch["frame_lengths"]).to(lp.device),
        d["beam_width"], min(2 * l_pad + 16, t_pad), torch.as_tensor(table),
        d["lm_order"], d["lm_alpha"], d["lm_beta"], d["prune_logp"],
        dtype=dtype)
    hyps, lens = hyps.cpu().numpy(), lens.cpu().numpy()
    return [h[:n].tolist() for h, n in zip(hyps, lens)]


def numbers(run, table, refs, lps, outs) -> dict:
    """One side's log posteriors (one tensor a batch) and hypotheses (a
    list a batch): ``lp_gap`` against the reference's posteriors
    ``refs``; ``hyp_mismatch``, the share of the utterances whose
    hypothesis differs from the float32 reference search's on that side's
    own posteriors."""
    lp_gap, differ, n_all = 0.0, 0, 0
    for (batch, lp_ref), lp, hyps in zip(refs, lps, outs):
        n = lp_ref.shape[0]
        lp = lp[:n].to(lp_ref.device).float()
        live = torch.as_tensor(batch["frame_mask"]).to(lp_ref.device) > 0
        lp_gap = max(lp_gap, float((lp - lp_ref).abs()[live].max()))
        want = search(run, table, batch, lp)
        differ += sum(1 for r in range(n) if hyps[r] != want[r])
        n_all += n
    return {"lp_gap": lp_gap, "hyp_mismatch": differ / max(n_all, 1)}


def check(run, records: List[dict], keep: dict, device) -> dict:
    rec = records[0]
    calls = rec["steps"]
    idx = sorted(keep["kept"])
    entries = [(run.config.data.bucket_boundaries.index(calls[i]["t_pad"]),
                calls[i]["ids"][:calls[i]["rows_real"]]) for i in idx]
    table, refs = reference_forward(run, keep["pool"], entries, device)
    got = numbers(run, table, refs, [keep["kept"][i] for i in idx],
                  [calls[i]["hyps"] for i in idx])
    return checks.verdict(got, run.cfg_file["limits"])


def finish(run, records: List[dict]) -> dict:
    return records[0]
