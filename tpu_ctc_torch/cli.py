"""Command line of the PyTorch/CUDA port: train, decode, score,
export-weights and print-config.

Counterpart of ``tpu_ctc.cli`` with the same flags, plus:

  * ``decode --weights PATH.npz`` loads the file that ``export-weights``
    (this CLI's or the JAX package's) writes; ``decode --checkpoint DIR``
    reads this CLI's own ``train`` checkpoints (``.pt``; the JAX package's
    orbax checkpoints are not read here); with neither the model is
    random-initialised from ``--seed``;
  * ``--device`` picks the torch device (default ``cuda``: without a card
    the command fails rather than run on the CPU);
  * ``train --seed`` overrides the config's seed of the initial weights;
  * ``train`` under ``torchrun`` (``WORLD_SIZE`` set) joins the process
    group (NCCL between cards, gloo for ``--device cpu``) and trains on the
    mesh of ``cfg.mesh``: the batch's rows over 'data', and with ``--set
    mesh.seq=N`` its frames over 'seq' too, with ``--set mesh.model=N``
    the parameters over 'model' (tensor parallelism; with ``--set
    mesh.pipeline=True`` pipeline stages instead); rank 0 writes the
    metrics and checkpoints.  A plain ``python -m`` run is one process on
    one card.

``--data DIR`` reads a manifest directory (``data/manifest.py``, lazily:
each batch's audio goes through the frontend on the CPU when the loader
reaches it); ``--synthetic-audio N`` synthesizes N tone waveforms and runs
them through the frontend on the CPU in batches of 32.

Usage:
  python -m tpu_ctc_torch.cli train --config 2 --data corpus --work-dir runs/x
  torchrun --standalone --nproc-per-node 4 -m tpu_ctc_torch.cli train \
      --config 3 --synthetic 256 --work-dir runs/dp [--set mesh.seq=2]
  python -m tpu_ctc_torch.cli decode --config 2 --checkpoint runs/x/checkpoints \
      --data corpus --split valid --beam --hyp-out runs/x/hyp
  python -m tpu_ctc_torch.cli score --ref runs/x/hyp/ref.trn \
      --hyp runs/x/hyp/hyp.trn
  python -m tpu_ctc_torch.cli export-weights --config 2 \
      --checkpoint runs/x/checkpoints --out w.npz
  python -m tpu_ctc_torch.cli decode --config 4 --synthetic 64 --beam \
      --set decode.neural_lm=True            # + the GRU char LM
  python -m tpu_ctc_torch.cli decode --config 4 --weights w.npz --synthetic 64
  python -m tpu_ctc_torch.cli print-config --config 4
"""
from __future__ import annotations

import argparse
import ast
import sys

import numpy as np


def _parse_overrides(pairs):
    out = {}
    for p in pairs or []:
        k, _, v = p.partition("=")
        try:
            out[k] = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            out[k] = v
    return out


def _load_config(args):
    from tpu_ctc_torch.config import get_config
    return get_config(args.config, **_parse_overrides(args.set))


def _synthetic_audio_data(cfg, n, seconds=4.0):
    """Tone-per-character waveforms through the frontend on the CPU, in
    batches of 32 (the reference's ``_synthetic_audio_data``)."""
    import torch

    from tpu_ctc_torch.data.alphabet import DEFAULT_ALPHABET
    from tpu_ctc_torch.data.synthetic import synthetic_audio_batch
    from tpu_ctc_torch.frontend.features import extract_features

    fe = cfg.frontend
    data = []
    bs = 32
    for start in range(0, n, bs):
        b = min(bs, n - start)
        audio, sl, labels, ll = synthetic_audio_batch(
            b, int(seconds * fe.sample_rate), sample_rate=fe.sample_rate,
            seed=start)
        feats, mask = extract_features(torch.from_numpy(audio), fe,
                                       sample_lengths=torch.from_numpy(sl))
        feats = feats.numpy()
        nf = mask.numpy().sum(axis=1).astype(np.int32)
        for i in range(b):
            data.append((feats[i, :nf[i]], labels[i, :ll[i]]))
    return data, DEFAULT_ALPHABET


def _dataset(cfg, args, split="train"):
    """(utterances, alphabet) of the command's data flags; ``--data`` gives
    a lazy ``ManifestDataset`` of ``split``."""
    if getattr(args, "synthetic_audio", 0):
        return _synthetic_audio_data(cfg, args.synthetic_audio)
    if args.synthetic:
        from tpu_ctc_torch.data.synthetic import SyntheticCorpus
        corpus = SyntheticCorpus(num_utterances=args.synthetic,
                                 feature_dim=cfg.model.input_dim,
                                 frames_per_char=8)
        return corpus.all_utterances(), corpus.alphabet
    if not args.data:
        raise SystemExit("one of --data, --synthetic or --synthetic-audio "
                         "is needed")
    from tpu_ctc_torch.data.manifest import ManifestDataset
    data = ManifestDataset(args.data, cfg, split=split)
    return data, data.alphabet


def _utt_ids(data):
    """Utterance id per dataset index (the manifest's ids when there are)."""
    records = getattr(data, "records", None)
    if records is not None:
        return [r["id"] for r in records]
    return [f"utt{i:05d}" for i in range(len(data))]


def _restore_model(cfg, directory, dev):
    """The model of the newest checkpoint in ``directory`` (on ``dev``) and
    its step, or None when there is none."""
    from tpu_ctc_torch.train import checkpoint
    from tpu_ctc_torch.train.step import create_train_state
    restored = checkpoint.restore(directory,
                                  create_train_state(cfg, device=dev))
    if restored is None:
        print(f"no checkpoint found in {directory}", file=sys.stderr)
        return None
    return restored[0].model, restored[0].step


def cmd_train(args):
    """Train on the data flags' utterances, the first tenth held out for
    eval; metrics and checkpoints go to ``--work-dir``."""
    import os

    import torch.distributed as dist

    from tpu_ctc_torch import resolve_device
    from tpu_ctc_torch.parallel import distributed
    from tpu_ctc_torch.train.loop import train

    cfg = _load_config(args)
    if args.seed is not None:
        cfg = cfg.override(seed=args.seed)
    if "WORLD_SIZE" in os.environ:
        dev = distributed.initialize(device=args.device)
    else:
        dev = resolve_device(args.device)
    try:
        data, alphabet = _dataset(cfg, args)
        n_eval = max(len(data) // 10, 1)
        _, metrics = train(cfg, data[n_eval:], eval_data=data[:n_eval],
                           work_dir=args.work_dir, resume=args.resume,
                           device=dev, alphabet=alphabet)
        if not dist.is_initialized() or dist.get_rank() == 0:
            print("final metrics:", metrics)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return 0


def cmd_decode(args):
    """Decode -> corpus CER/WER (+ optional trn files for rescoring)."""
    import os

    import torch

    from tpu_ctc_torch import resolve_device
    from tpu_ctc_torch.data.bucketing import BucketedLoader
    from tpu_ctc_torch.decode.greedy import greedy_decode
    from tpu_ctc_torch.decode.wer import (format_score_line, score_corpus,
                                          write_trn)
    from tpu_ctc_torch.models import birnn
    from tpu_ctc_torch.train import checkpoint
    from tpu_ctc_torch.train.loop import batch_to_device_dict

    cfg = _load_config(args)
    dev = resolve_device(args.device)
    data, alphabet = _dataset(cfg, args, split=args.split)
    if args.checkpoint:
        restored = _restore_model(cfg, args.checkpoint, dev)
        if restored is None:
            return 1
        model = restored[0]
    elif args.weights:
        model = checkpoint.load_npz(birnn.BiRNN(cfg.model, device="cpu"),
                                    args.weights).to(dev)
    else:
        model = birnn.init_params(cfg.model, seed=args.seed, device=dev)

    if args.beam:
        from tpu_ctc_torch.decode.beam import make_beam_decoder
        from tpu_ctc_torch.decode.lm import train_char_lm_from_data
        from tpu_ctc_torch.decode.neural_lm import train_nlm_from_data
        from tpu_ctc_torch.ops.beam_cuda import MAX_ORDER, check_supported
        # Refuse before the LMs train: on the card, what the fused kernels
        # do not take (make_beam_decoder raises for it there); everywhere,
        # n-gram orders over 3, which the plain search refuses too.
        d = cfg.decode
        if d.use_fused_kernel and dev.type == "cuda":
            check_supported(d.beam_width, cfg.model.vocab_size, d.lm_order,
                            nlm_dims=((d.neural_lm_embed, d.neural_lm_hidden)
                                      if d.neural_lm else None))
        if d.lm_order > MAX_ORDER:
            raise ValueError(f"device decoder supports LM order<={MAX_ORDER}, "
                             f"got {d.lm_order}")
        # Both LMs train on the train split's transcripts, never on the
        # split being decoded (the synthetic corpora are the train split).
        lm_data = data
        if args.split != "train" and hasattr(data, "records"):
            lm_data = _dataset(cfg, args)[0]
        lm = (train_char_lm_from_data(lm_data, cfg) if cfg.decode.lm_order
              else None)
        nlm = train_nlm_from_data(lm_data, cfg, device=dev)
        decode_fn = make_beam_decoder(cfg, lm=lm, nlm_params=nlm, device=dev)
    else:
        def decode_fn(model, bd):
            feats = torch.as_tensor(bd["feats"], device=dev)
            mask = torch.as_tensor(bd["frame_mask"], device=dev)
            with torch.no_grad():
                lp = birnn.log_posteriors(model, cfg.model, feats, mask)
            return greedy_decode(lp, mask)

    loader = BucketedLoader(data, cfg.data)
    ids = _utt_ids(data)
    ref_texts, hyp_texts = {}, {}
    for _, batch in loader.epoch(0):
        hyp, hyp_len = decode_fn(model, batch_to_device_dict(batch))
        hyp, hyp_len = hyp.cpu().numpy(), hyp_len.cpu().numpy()
        for b in range(len(hyp)):
            if batch.weights[b] > 0:
                utt = ids[int(batch.utt_indices[b])]
                ref_texts[utt] = alphabet.decode(
                    batch.labels[b][:batch.label_lengths[b]])
                hyp_texts[utt] = alphabet.decode(hyp[b][:hyp_len[b]])

    wer_totals, _ = score_corpus(ref_texts, hyp_texts, "word")
    cer_totals, _ = score_corpus(ref_texts, hyp_texts, "char")
    print(f"decoded {len(hyp_texts)} utterances on {dev}")
    print(format_score_line(wer_totals, "word"))
    print(format_score_line(cer_totals, "char"))
    for utt in sorted(ref_texts)[:5]:
        print("  ref:", ref_texts[utt])
        print("  hyp:", hyp_texts[utt])
    if args.hyp_out:
        os.makedirs(args.hyp_out, exist_ok=True)
        write_trn(os.path.join(args.hyp_out, "ref.trn"), ref_texts)
        write_trn(os.path.join(args.hyp_out, "hyp.trn"), hyp_texts)
        print(f"wrote {args.hyp_out}/ref.trn and hyp.trn")
    return 0


def cmd_score(args):
    from tpu_ctc_torch.decode.wer import (bootstrap_ci, format_score_line,
                                          parse_trn, score_corpus)
    refs = parse_trn(args.ref)
    hyps = parse_trn(args.hyp)
    for unit in (["word", "char"] if args.unit == "both" else [args.unit]):
        totals, _ = score_corpus(refs, hyps, unit)
        line = format_score_line(totals, unit)
        if args.ci:
            lo, hi = bootstrap_ci(refs, hyps, unit)
            line += f"  95% CI [{100*lo:.2f}, {100*hi:.2f}]"
        print(line)
    return 0


def cmd_export_weights(args):
    """Write a checkpoint's parameters as a flat npz with the JAX export's
    '/'-joined keys (what ``decode --weights`` and the JAX package's
    ``checkpoint`` npz bridge read)."""
    from tpu_ctc_torch import resolve_device
    from tpu_ctc_torch.train import checkpoint
    cfg = _load_config(args)
    restored = _restore_model(cfg, args.checkpoint,
                              resolve_device(args.device))
    if restored is None:
        return 1
    n = checkpoint.export_npz(restored[0], args.out)
    print(f"wrote {n} arrays to {args.out} (step {restored[1]})")
    return 0


def cmd_print_config(args):
    print(_load_config(args).to_json(indent=2))
    return 0


def main(argv=None):
    p = argparse.ArgumentParser(prog="tpu_ctc_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--config", default="default",
                        help="preset name or ordinal 1-5")
    common.add_argument("--set", action="append", metavar="PATH=VAL",
                        help="dotted-path config override")
    common.add_argument("--synthetic", type=int, default=0,
                        help="use N synthetic utterances instead of --data")
    common.add_argument("--synthetic-audio", type=int, default=0,
                        help="use N synthetic tone-waveform utterances "
                             "through the frontend")
    common.add_argument("--data", help="manifest directory")

    t = sub.add_parser("train", parents=[common])
    t.add_argument("--work-dir", default=".")
    t.add_argument("--resume", action="store_true")
    t.add_argument("--seed", type=int, default=None,
                   help="seed of the initial weights (default: the "
                        "config's seed)")
    t.add_argument("--device", default="cuda",
                   help="torch device (default cuda)")
    t.set_defaults(fn=cmd_train)

    d = sub.add_parser("decode", parents=[common])
    d.add_argument("--checkpoint",
                   help="checkpoint directory of `train` (the newest .pt)")
    d.add_argument("--weights",
                   help="npz written by `export-weights` (this CLI's or "
                        "`python -m tpu_ctc.cli`'s); random weights from "
                        "--seed without it or --checkpoint")
    d.add_argument("--seed", type=int, default=0,
                   help="seed of the random weights when no --weights")
    d.add_argument("--device", default="cuda",
                   help="torch device (default cuda)")
    d.add_argument("--beam", action="store_true",
                   help="prefix beam search instead of greedy")
    d.add_argument("--hyp-out", default=None,
                   help="directory to write ref.trn/hyp.trn for scoring")
    d.add_argument("--split", default="train",
                   help="manifest split to decode (e.g. valid)")
    d.set_defaults(fn=cmd_decode)

    sc = sub.add_parser("score")
    sc.add_argument("--ref", required=True)
    sc.add_argument("--hyp", required=True)
    sc.add_argument("--unit", choices=["word", "char", "both"], default="both")
    sc.add_argument("--ci", action="store_true",
                    help="bootstrap 95%% CI (utterance resampling)")
    sc.set_defaults(fn=cmd_score)

    ew = sub.add_parser("export-weights", parents=[common])
    ew.add_argument("--checkpoint", required=True)
    ew.add_argument("--out", required=True, help=".npz output path")
    ew.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    ew.set_defaults(fn=cmd_export_weights)

    pc = sub.add_parser("print-config", parents=[common])
    pc.set_defaults(fn=cmd_print_config)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
