#!/usr/bin/env python
"""Decode hyperparameter sweep of the port: a grid over (lm_alpha, lm_beta)
on a dev split.

Counterpart of ``tools/sweep_decode.py``: the role the reference's
``decoder_config.py`` constants and sweep scripts played (SURVEY.md C9):
pick the LM fusion weight alpha and the insertion bonus beta on a DEV
split, then decode the eval split once with the winners.  It reads the
port's own checkpoints (``train/checkpoint.py``, ``.pt``), computes the
log posteriors of the split once, then decodes every grid point with
``decode.beam.make_beam_search`` (the search ``make_beam_decoder`` runs:
kernels B5/B6 on the card, the plain search on the CPU).  The LMs train on
the train split.  Prints ONE JSON line: the best point and the full grid.

Usage (mirrors `cli decode` flags):
  python3 torch_tools/sweep_decode.py --config 2 --set model.hidden_dim=512 ... \
      --data manifests --split dev --checkpoint runs/x/checkpoints \
      --alphas 0.5,0.75,1.0,1.25 --betas 0.5,1.0,1.5,2.0 [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

if __package__ in (None, ""):          # run as a script, not imported
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main(argv=None):
    from tpu_ctc_torch.cli import _parse_overrides, _utt_ids

    p = argparse.ArgumentParser()
    p.add_argument("--config", default="default")
    p.add_argument("--set", action="append", metavar="PATH=VAL")
    p.add_argument("--data", required=True)
    p.add_argument("--split", default="dev")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--alphas", default="0.5,0.75,1.0,1.25,1.5")
    p.add_argument("--betas", default="0.0,0.5,1.0,1.5,2.0")
    p.add_argument("--unit", choices=["word", "char"], default="word")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda)")
    args = p.parse_args(argv)

    import torch

    from tpu_ctc_torch import resolve_device
    from tpu_ctc_torch.config import get_config
    from tpu_ctc_torch.data.bucketing import BucketedLoader
    from tpu_ctc_torch.data.manifest import ManifestDataset
    from tpu_ctc_torch.decode.beam import make_beam_search
    from tpu_ctc_torch.decode.lm import train_char_lm_from_data
    from tpu_ctc_torch.decode.neural_lm import train_nlm_from_data
    from tpu_ctc_torch.decode.wer import score_corpus
    from tpu_ctc_torch.models import birnn
    from tpu_ctc_torch.train import checkpoint
    from tpu_ctc_torch.train.step import create_train_state

    cfg = get_config(args.config, **_parse_overrides(args.set))
    dev = resolve_device(args.device)
    data = ManifestDataset(args.data, cfg, split=args.split)
    lm_data = ManifestDataset(args.data, cfg, split="train")
    alphabet = data.alphabet

    restored = checkpoint.restore(args.checkpoint,
                                  create_train_state(cfg, device=dev))
    if restored is None:
        raise SystemExit(f"no checkpoint in {args.checkpoint}")
    model = restored[0].model

    lm = train_char_lm_from_data(lm_data, cfg) if cfg.decode.lm_order else None
    nlm = train_nlm_from_data(lm_data, cfg, device=dev)
    search = make_beam_search(cfg, lm=lm, nlm_params=nlm, device=dev)

    # ---- posteriors once, kept on the device ----------------------------
    cached = []          # (log_probs [B, T, A], lens [B], max_len, utts)
    ids = _utt_ids(data)
    refs = {}
    for _, batch in BucketedLoader(data, cfg.data).epoch(0):
        feats = torch.as_tensor(batch.feats, device=dev)
        mask = torch.as_tensor(batch.frame_mask, device=dev)
        with torch.no_grad():
            lp = birnn.log_posteriors(model, cfg.model, feats, mask)
        utts = []
        for b in range(len(batch.weights)):
            if batch.weights[b] > 0:
                utt = ids[int(batch.utt_indices[b])]
                refs[utt] = alphabet.decode(
                    batch.labels[b][:batch.label_lengths[b]])
                utts.append((b, utt))
        max_len = min(int(batch.labels.shape[1]) * 2 + 16, lp.shape[1])
        cached.append((lp, torch.as_tensor(batch.frame_lengths, device=dev),
                       max_len, utts))
    log(f"[sweep] cached posteriors for {len(refs)} utts "
        f"in {len(cached)} batches on {dev}")

    results = []
    alphas = [float(x) for x in args.alphas.split(",")]
    betas = [float(x) for x in args.betas.split(",")]
    for alpha in alphas:
        for beta in betas:
            hyps = {}
            for lp, lens, max_len, utts in cached:
                hyp, hlen, _ = search(lp, lens, max_len, lm_alpha=alpha,
                                      lm_beta=beta)
                hyp, hlen = hyp.cpu().numpy(), hlen.cpu().numpy()
                for b, utt in utts:
                    hyps[utt] = alphabet.decode(hyp[b][:hlen[b]])
            totals, _ = score_corpus(refs, hyps, args.unit)
            er = totals["error_rate"]
            results.append({"alpha": alpha, "beta": beta,
                            "error_rate": round(er, 4)})
            log(f"[sweep] alpha={alpha:<5} beta={beta:<5} "
                f"{args.unit[0].upper()}ER={100*er:.2f}%")
    best = min(results, key=lambda r: r["error_rate"])
    print(json.dumps({"best": best, "grid": results, "unit": args.unit,
                      "split": args.split, "n_utts": len(refs)}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
