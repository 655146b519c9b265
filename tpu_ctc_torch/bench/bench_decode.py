"""Decode benchmark: the batched beam search on the card against the host
decoder.

Counterpart of ``tpu_ctc.bench.bench_decode``.  The reference decoded per
utterance on the CPU after copying posteriors off the device (SURVEY.md
§3.3).  This bench measures two decoders on the same posteriors:

  * device  -- ``ops.beam_cuda.beam_search``, the search that
               ``make_beam_decoder`` runs: kernel B5 for K <= 128 and B6 for
               K in (128, 256] on a card (``--neural-lm H`` fuses a GRU
               char LM of hidden size H).  On a card a configuration the
               kernels do not take raises ``NotImplementedError`` before
               anything is timed, as ``make_beam_decoder`` does.  Beside
               it, unless ``--skip-plain``, the plain search
               ``decode.beam.prefix_beam_search`` on the same device: a
               row of its own on stderr, never the JSON line's value;
  * cpp     -- the native host decoder (``cpp/ctc_beam.cpp`` through
               :mod:`tpu_ctc_torch.decode.cpp_decoder`), standing in for the
               reference's compiled Cython decoder.

The host decoder scores the same n-gram LM (``--lm-order``); it takes no
GRU, ``--char-topk`` or ``--prune-logp``.  Prints ONE JSON line: the
device's decode audio-s/s with ``vs_baseline`` = its speedup over the
compiled host decoder (null only when no host utterance runs:
``--host-utts 0``, the default of ``--preset4``).  The cpp row raises if
the library does not build.  ``--device cpu`` runs every row on the CPU
(the plain search in the kernels' place) as a functional check; its unit
says so.

Run: python -m tpu_ctc_torch.bench.bench_decode [--batch 32 --frames 400 --beam 64]
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

FRAMES_PER_SECOND = 100.0


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--frames", type=int, default=400)
    p.add_argument("--beam", type=int, default=64)
    p.add_argument("--vocab", type=int, default=29)
    p.add_argument("--max-len", type=int, default=64)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--host-utts", type=int, default=None,
                   help="utterances to run through each host decoder "
                        "(default 4; 0 under --preset4)")
    p.add_argument("--char-topk", type=int, default=0,
                   help="static per-frame extension-char cap (0 = exact)")
    p.add_argument("--prune-logp", type=float, default=None,
                   help="acoustic log-prob pruning threshold")
    p.add_argument("--lm-order", type=int, default=0,
                   help="fuse a char n-gram LM of this order (trained "
                        "in-repo on random sequences; timing-faithful)")
    p.add_argument("--sweep-beams", default=None, metavar="K1,K2,...",
                   help="bench the kernels at each beam width and print a "
                        "sweep table (e.g. 64,100,128,200,256: K > 128 runs "
                        "kernel B6; the reference's canonical widths were "
                        "100-200, SURVEY C9)")
    p.add_argument("--preset4", action="store_true",
                   help="shortcut: the shipped preset-4 decode shape "
                        "(B=64, T=1600, K=128, trigram char LM)")
    p.add_argument("--skip-plain", action="store_true",
                   help="skip the plain-search row (seconds a batch at "
                        "K=128/T=1600-scale shapes)")
    p.add_argument("--neural-lm", type=int, default=0, metavar="H",
                   help="score with a GRU char LM of hidden size H: the "
                        "device row is the kernel's GRU branch (SURVEY C10 "
                        "/ NAACL'15 headline path)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda)")
    args = p.parse_args(argv)
    if args.preset4:
        args.batch, args.frames, args.beam, args.lm_order = 64, 1600, 128, 3
        args.max_len = 256
    if args.host_utts is None:
        # the host decoder takes minutes at preset 4's shape
        args.host_utts = 0 if args.preset4 else 4

    from tpu_ctc_torch import resolve_device
    from tpu_ctc_torch.bench.bench import log_softmax_np, time_decode, unit_for
    from tpu_ctc_torch.decode import cpp_decoder, neural_lm
    from tpu_ctc_torch.decode.beam import prefix_beam_search
    from tpu_ctc_torch.ops import beam_cuda
    from tpu_ctc_torch.utils.profiling import card_line

    dev = resolve_device(args.device)
    sweep_beams = ([int(v) for v in args.sweep_beams.split(",")]
                   if args.sweep_beams else [])
    nlm_cfg = (neural_lm.CharRNNLMConfig(vocab_size=args.vocab,
                                         hidden_dim=args.neural_lm)
               if args.neural_lm else None)
    if dev.type == "cuda":
        # the device row is make_beam_decoder's kernel path, which refuses
        # what B5 and B6 do not take; so does the bench, before any timing
        beam_cuda.check_supported(
            args.beam, args.vocab, args.lm_order,
            nlm_dims=(nlm_cfg.embed_dim, nlm_cfg.hidden_dim) if nlm_cfg
            else None)
        for kb in sweep_beams:
            beam_cuda.check_supported(kb, args.vocab, args.lm_order)
    log(f"[decode-bench] {card_line(dev)}")
    nlm_params = (neural_lm.init_params(nlm_cfg, seed=0, device=dev)
                  if nlm_cfg else None)

    lm, lm_table, lm_order = None, None, 0
    if args.lm_order:
        from tpu_ctc_torch.decode.lm import train_ngram_lm
        r = np.random.RandomState(7)
        seqs = [list(r.randint(1, args.vocab, size=r.randint(5, 20)))
                for _ in range(200)]
        lm = train_ngram_lm(seqs, vocab_size=args.vocab, order=args.lm_order)
        lm_table, lm_order = lm.tables(dev), args.lm_order

    rng = np.random.RandomState(0)
    lp_np = log_softmax_np(
        rng.randn(args.batch, args.frames, args.vocab).astype(np.float32))
    lp = torch.as_tensor(lp_np, device=dev)
    fl = torch.full((args.batch,), args.frames, dtype=torch.int32,
                    device=dev)
    audio_s = args.batch * args.frames / FRAMES_PER_SECOND
    shape = f"({args.batch} utts x {args.frames} frames)"

    def time_path(fn, label, iters=args.iters):
        return time_decode(fn, f"{label} {shape}", audio_s, iters, dev,
                           tag="[decode-bench]")

    def kernel(k):
        """The label of the device row: the kernel it launches on a card."""
        return (f"kernel {beam_cuda.kernel_for(k).name}" if dev.type == "cuda"
                else "kernel path (the plain search on the cpu)")

    lm_kw = dict(lm_table=lm_table, lm_order=lm_order,
                 char_topk=args.char_topk, prune_logp=args.prune_logp)
    sweep = {}
    for kb in sweep_beams:
        sweep[kb] = round(time_path(lambda kb=kb: beam_cuda.beam_search(
            lp, fl, beam_width=kb, max_len=args.max_len, **lm_kw),
            f"{kernel(kb)} K={kb}"), 1)

    dev_kw = dict(beam_width=args.beam, max_len=args.max_len,
                  nlm_params=nlm_params, **lm_kw)
    dev_thr = time_path(
        lambda: beam_cuda.beam_search(lp, fl, **dev_kw),
        f"{kernel(args.beam)} K={args.beam}"
        + (" + GRU LM" if nlm_params is not None else "")
        + (" trigram (preset-4 shape)" if args.preset4 else ""))
    if not args.skip_plain:
        # a row of its own, never the bench's value
        plain_thr = time_path(
            lambda: prefix_beam_search(lp, fl, **dev_kw), "plain search",
            iters=max(args.iters // 10, 1))
        log(f"[decode-bench] the kernel path is {dev_thr / plain_thr:.1f}x "
            f"the plain search")

    n = min(args.host_utts, args.batch)
    cpp_thr = None
    if n > 0:
        lens = np.full(n, args.frames, np.int32)
        # warm-up (the build, ctypes dispatch, page-in) so host and device
        # timing are measured the same way
        cpp_decoder.beam_search_batch(lp_np[:1], lens[:1],
                                      beam_width=args.beam, lm=lm,
                                      max_len=args.max_len)
        t0 = time.time()
        cpp_decoder.beam_search_batch(lp_np[:n], lens, beam_width=args.beam,
                                      lm=lm, max_len=args.max_len)
        cpp_s = (time.time() - t0) / n
        cpp_thr = (args.frames / FRAMES_PER_SECOND) / cpp_s
        log(f"[decode-bench] cpp host: {cpp_s * 1e3:.1f} ms/utt "
            f"-> {cpp_thr:,.0f} audio-s/s")

    out = {
        "metric": "decode_throughput",
        "value": round(dev_thr, 1),
        "unit": unit_for(dev),
        "vs_baseline": round(dev_thr / cpp_thr, 2) if cpp_thr else None,
    }
    if sweep:
        out["beam_sweep"] = {str(k): v for k, v in sorted(sweep.items())}
    if args.preset4:
        out["shape"] = "preset4:B=64,T=1600,K=128,trigram"
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
