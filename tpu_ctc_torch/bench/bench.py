"""The port's one-line benchmark: training throughput in audio-seconds/s on
one card, beside the decode throughputs.

Counterpart of the repository's root ``bench.py``.  Prints ONE JSON line:

  {"metric": "train_throughput", "value": N,
   "unit": "audio_seconds_per_second_per_card", "vs_baseline": N,
   "decode_throughput": N, "decode_unit": "...",
   "decode_vs_plain_search": N, "decode_neural_lm_throughput": N,
   "decode_preset4_throughput": N}

* ``value``: the step of ``make_train_step`` (forward, CTC, backward, the
  Nesterov update; kernels B1-B4 on a card, captured in a CUDA graph) on a
  device-resident batch, B = 128, H = 1024, 3 BiRNN layers, T = 400:
  audio seconds (100 frames a second) over the wall clock of 20 steps
  after 3 warm-up steps, synchronised with ``torch.cuda.synchronize``; the
  eager ``train_step``'s rate beside it on stderr.
* ``vs_baseline``: over the reference's per-utterance CPU path
  (:mod:`tpu_ctc_torch.bench.reference_numpy`); null only under
  ``--skip-cpu-baseline``.
* decode: B = 32, T = 400, K = 64 on random posteriors through
  ``ops.beam_cuda.beam_search`` (the search that ``make_beam_decoder``
  runs: kernel B5 on a card), against the plain search
  ``decode.beam.prefix_beam_search`` on the same device; preset 4's shape
  (B = 64, T = 1600, K = 128, a trigram, alpha 1.25, beta 1.5), kernel
  only; and B5's GRU branch (E = 64, H = 128).

The step's model FLOP/s utilization (:func:`..utils.profiling.mfu`,
against the H100 SXM's dense bf16 peak) goes to stderr beside the card's
name and power limit; stdout carries only the JSON line.  Any failure
exits non-zero.  ``--device cpu`` runs the same on the CPU (the plain
versions in the kernels' place) as a functional check at small shapes;
its units then read ``audio_seconds_per_second_on_cpu``.

Run: python -m tpu_ctc_torch.bench.bench [--steps 20] [--device cuda]
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

FRAMES_PER_SECOND = 100.0
# (B, T, K) of preset 4's decode: its batch, longest bucket and beam width.
PRESET4_SHAPE = (64, 1600, 128)


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def unit_for(dev: torch.device) -> str:
    """The throughputs' unit: per card, or marked as the CPU's (a CPU run
    is a functional check, not a device number)."""
    return ("audio_seconds_per_second_per_card" if dev.type == "cuda"
            else "audio_seconds_per_second_on_cpu")


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def train_config(hidden=1024, num_bi=3, batch=128, t_frames=400, vocab=29,
                 input_dim=120):
    from tpu_ctc_torch.config import (Config, DataConfig, MeshConfig,
                                      ModelConfig, OptimConfig, TrainConfig)
    return Config(
        model=ModelConfig(input_dim=input_dim, hidden_dim=hidden,
                          num_pre_layers=1, num_bi_layers=num_bi,
                          vocab_size=vocab),
        optim=OptimConfig(learning_rate=1e-3),
        data=DataConfig(batch_size=batch, max_frames=t_frames,
                        bucket_boundaries=(t_frames,)),
        mesh=MeshConfig(data=1, model=1, seq=1),
        train=TrainConfig(metrics_path=""),
        ctc_impl="auto")


def time_steps(step_fn, state, bt, steps, dev):
    """``steps`` calls of ``step_fn`` from ``state`` on the batch ``bt``,
    synchronised at the end; returns (state, the last metrics, seconds)."""
    sync(dev)
    t0 = time.time()
    for _ in range(steps):
        state, m = step_fn(state, bt)
    sync(dev)
    return state, m, time.time() - t0


def bench_train(hidden=1024, num_bi=3, batch=128, t_frames=400, vocab=29,
                input_dim=120, steps=20, warmup=3, device="cuda"):
    """Training throughput on a device-resident batch, through the step
    that ``make_train_step`` returns (on a card one CUDA graph per batch
    shape, as the JAX bench times its jitted step); the eager
    ``train_step``'s from the same seed timed after it, to stderr.
    Returns (audio-s/s, step seconds, the config)."""
    import functools

    from tpu_ctc_torch import resolve_device
    from tpu_ctc_torch.data.bucketing import make_batch
    from tpu_ctc_torch.parallel.mesh import make_mesh
    from tpu_ctc_torch.train.loop import batch_to_device_dict
    from tpu_ctc_torch.train.step import (batch_to_tensors,
                                          create_train_state,
                                          make_train_step, train_step)

    dev = resolve_device(device)
    cfg = train_config(hidden, num_bi, batch, t_frames, vocab, input_dim)
    rng = np.random.RandomState(0)
    utts = [(rng.randn(t_frames, input_dim).astype(np.float32),
             rng.randint(1, vocab, min(40, t_frames // 3)).astype(np.int32))
            for _ in range(batch)]
    b = make_batch(utts, t_pad=t_frames, l_pad=48, batch_size=batch)
    step_fn, state = make_train_step(cfg, make_mesh(cfg.mesh),
                                     create_train_state(cfg, device=dev))
    eager = functools.partial(train_step, cfg=cfg)
    # Device-resident batch: the training loop prefetches input copies on
    # a side stream (data/prefetch.py), so the steady-state step is what
    # the card computes.
    bt = batch_to_tensors(batch_to_device_dict(b), dev)
    audio = batch * t_frames / FRAMES_PER_SECOND * steps
    thr = {}
    for name, fn in (("make_train_step", step_fn), ("eager train_step",
                                                    eager)):
        st = state if fn is step_fn else create_train_state(cfg, device=dev)
        st, m, dt = time_steps(fn, st, bt, warmup, dev)
        log(f"[bench] {name}: warmup (and kernel build, graph capture) "
            f"{dt:.1f}s, loss={float(m['loss']):.3f}")
        st, m, dt = time_steps(fn, st, bt, steps, dev)
        if not np.isfinite(float(m["loss"])):
            raise FloatingPointError(f"train loss {float(m['loss'])}")
        thr[name] = (audio / dt, dt / steps)
        log(f"[bench] train on {dev}, {name}: {steps} steps in {dt:.2f}s "
            f"-> {audio / dt:.1f} audio-s/s (step {dt / steps * 1e3:.2f} "
            f"ms)")
        del st
    return (*thr["make_train_step"], cfg)


def log_softmax_np(x: np.ndarray) -> np.ndarray:
    return x - np.log(np.exp(x).sum(-1, keepdims=True))


def time_decode(fn, label, audio, n_iters, dev, tag="[bench]"):
    """Mean wall time of ``fn()`` over ``n_iters`` synchronised calls after
    one warm-up call (which builds the kernel); returns audio-s/s, with
    ``audio`` the seconds of audio a call decodes."""
    fn()
    sync(dev)
    t0 = time.time()
    for _ in range(n_iters):
        fn()
    sync(dev)
    dt = (time.time() - t0) / n_iters
    thr = audio / dt
    log(f"{tag} {label}: {dt * 1e3:.2f} ms/batch -> {thr:.0f} audio-s/s")
    return thr


def bench_decode(batch=32, t_frames=400, vocab=29, beam=64, iters=10,
                 plain_iters=2, device="cuda"):
    """Beam-decode throughput (audio-s/s/card) of the kernel path against
    the plain search, on device-resident posteriors; then preset 4's shape
    and the GRU branch, kernel only.  Returns (kernel, plain, GRU,
    preset 4) audio-s/s."""
    from tpu_ctc_torch import resolve_device
    from tpu_ctc_torch.decode import neural_lm
    from tpu_ctc_torch.decode.beam import prefix_beam_search
    from tpu_ctc_torch.decode.lm import train_ngram_lm
    from tpu_ctc_torch.ops.beam_cuda import beam_search

    dev = resolve_device(device)
    rng = np.random.RandomState(0)
    x = rng.randn(batch, t_frames, vocab).astype(np.float32) * 2
    lp = torch.as_tensor(log_softmax_np(x), device=dev)
    lens = torch.full((batch,), t_frames, dtype=torch.int32, device=dev)
    audio_s = batch * t_frames / FRAMES_PER_SECOND

    kernel_thr = time_decode(lambda: beam_search(
        lp, lens, beam_width=beam, max_len=128), "decode kernel (B5)",
        audio_s, iters, dev)
    plain_thr = time_decode(lambda: prefix_beam_search(
        lp, lens, beam_width=beam, max_len=128), "decode plain search",
        audio_s, plain_iters, dev)

    b4, t4, k4 = PRESET4_SHAPE
    r4 = np.random.RandomState(7)
    seqs = [list(r4.randint(1, vocab, size=r4.randint(5, 20)))
            for _ in range(200)]
    lm = train_ngram_lm(seqs, vocab_size=vocab, order=3)
    x4 = r4.randn(b4, t4, vocab).astype(np.float32) * 2
    lp4 = torch.as_tensor(log_softmax_np(x4), device=dev)
    lens4 = torch.full((b4,), t4, dtype=torch.int32, device=dev)
    table = lm.tables(dev)
    p4_thr = time_decode(lambda: beam_search(
        lp4, lens4, beam_width=k4, max_len=256, lm_table=table, lm_order=3,
        lm_alpha=1.25, lm_beta=1.5),
        f"decode preset4 (B={b4}/T={t4}/K={k4}/trigram)",
        b4 * t4 / FRAMES_PER_SECOND, max(iters // 2, 1), dev)

    nlm = neural_lm.init_params(
        neural_lm.CharRNNLMConfig(vocab_size=vocab, embed_dim=64,
                                  hidden_dim=128), seed=0, device=dev)
    nlm_thr = time_decode(lambda: beam_search(
        lp, lens, beam_width=beam, max_len=128, nlm_params=nlm,
        lm_alpha=0.7, lm_beta=0.3), "decode kernel + GRU LM", audio_s,
        iters, dev)
    return kernel_thr, plain_thr, nlm_thr, p4_thr


def bench_cpu_reference(hidden=1024, num_bi=3, t_frames=400, vocab=29,
                        input_dim=120, utts=3, budget_s=120.0):
    """The reference's CPU path: per-utterance, Python time loop, numpy CTC."""
    from tpu_ctc_torch.bench.reference_numpy import ReferenceBRNN

    model = ReferenceBRNN(input_dim=input_dim, hidden_dim=hidden,
                          vocab_size=vocab, num_pre=1, num_bi=num_bi)
    rng = np.random.RandomState(0)
    velocity = None
    done, t_total = 0, 0.0
    for _ in range(utts):
        feats = rng.randn(t_frames, input_dim)
        labels = rng.randint(1, vocab, 40)
        t0 = time.time()
        _, grads = model.cost_and_grad(feats, labels)
        velocity = model.sgd_step(grads, velocity=velocity)
        t_total += time.time() - t0
        done += 1
        if t_total > budget_s:
            break
    thr = done * (t_frames / FRAMES_PER_SECOND) / t_total
    log(f"[bench] cpu reference: {done} utts in {t_total:.2f}s -> "
        f"{thr:.2f} audio-s/s")
    return thr


def main(argv=None):
    from tpu_ctc_torch import resolve_device
    from tpu_ctc_torch.utils.profiling import card_line, mfu

    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--hidden", type=int, default=1024)
    p.add_argument("--layers", type=int, default=3)
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--frames", type=int, default=400)
    p.add_argument("--cpu-utts", type=int, default=3,
                   help="utterances of the CPU reference")
    p.add_argument("--skip-cpu-baseline", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda)")
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    kw = dict(hidden=args.hidden, num_bi=args.layers, t_frames=args.frames)
    thr, step_s, cfg = bench_train(batch=args.batch, steps=args.steps,
                                   device=dev, **kw)
    if dev.type == "cuda":
        log(f"[bench] {card_line(dev)}: step mfu "
            f"{mfu(cfg, args.batch, args.frames, step_s):.4f} of the H100 "
            f"SXM's dense bf16 peak")
    else:
        log("[bench] cpu: mfu not measured (no card)")
    dec, dec_plain, dec_nlm, dec_p4 = bench_decode(t_frames=args.frames,
                                                   device=dev)
    cpu_thr = (None if args.skip_cpu_baseline
               else bench_cpu_reference(utts=args.cpu_utts, **kw))
    unit = unit_for(dev)
    print(json.dumps({
        "metric": "train_throughput",
        "value": round(thr, 2),
        "unit": unit,
        "vs_baseline": round(thr / cpu_thr, 2) if cpu_thr else None,
        "decode_throughput": round(dec, 2),
        "decode_unit": unit,
        "decode_vs_plain_search": round(dec / dec_plain, 2),
        "decode_neural_lm_throughput": round(dec_nlm, 2),
        "decode_preset4_throughput": round(dec_p4, 2),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
