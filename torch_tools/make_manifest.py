#!/usr/bin/env python
"""Corpus manifest maker of the port — the TIMIT/SWBD prep pipeline.

Counterpart of ``tools/make_manifest.py`` on the port's
:mod:`tpu_ctc_torch.data.audio_io` and
:func:`tpu_ctc_torch.data.manifest.write_manifest`: the same layouts,
records and splits.

Reference analogue (SURVEY.md C12/C13): Kaldi shell pipelines in
``timit-utils/`` / ``swbd-utils/`` producing binary feature blobs + key
manifests.  Here corpora are described by a JSONL manifest consumed by
:mod:`tpu_ctc_torch.data.manifest`; features come from the in-framework
STFT/log-mel frontend (waveform mode) or from precomputed ``.npy``
matrices (feature mode).

Raw corpus trees ingest with ZERO external steps: RIFF-WAV and
NIST-SPHERE files (TIMIT's ``.WAV`` is SPHERE pcm16; Switchboard is
SPHERE ulaw) are parsed by :mod:`tpu_ctc_torch.data.audio_io` — no sph2pipe,
no sox, no Kaldi.  ``.npy`` waveforms/features still work.

Supported layouts:

  * ``--layout dir``   — a directory of ``<utt>.{wav,sph,npy}`` (npy: 1-D
    waveform or [T, D] features, detected by ndim) with ``<utt>.txt``
    transcripts alongside.
  * ``--layout tsv``    — a TSV file: ``utt_id<TAB>path<TAB>transcript``.
  * ``--layout timit``  — a raw TIMIT tree: ``*.WAV`` (NIST-SPHERE or
    RIFF; ``*.WAV.npy`` pre-converted also accepted) next to ``*.TXT``
    prompts (start/end sample numbers stripped).

Every record carries length metadata (``samples`` at the file's native
rate plus ``rate``, or ``frames`` for feature matrices) read from
container HEADERS only, so downstream bucketing never touches payloads.

Usage:
  python3 torch_tools/make_manifest.py --layout timit --src /data/timit/train \
      --out manifests/timit --split train [--val-frac 0.05]
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import re
import sys

if __package__ in (None, ""):          # run as a script, not imported
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

from tpu_ctc_torch.data import audio_io  # noqa: E402
from tpu_ctc_torch.data.alphabet import DEFAULT_ALPHABET  # noqa: E402
from tpu_ctc_torch.data.manifest import write_manifest  # noqa: E402

AUDIO_EXTS = (".wav", ".sph", ".npy")


def normalize_text(text: str) -> str:
    """Lexicon-free char normalization: lowercase letters, space,
    apostrophe; everything else dropped (the papers' character set)."""
    text = text.lower()
    text = re.sub(r"[^a-z' ]+", " ", text)
    return re.sub(r"\s+", " ", text).strip()


def _record_for(utt: str, path: str, text: str, rel_to: str = None) -> dict:
    """Build one manifest record with header-only length metadata.

    Paths are stored relative to ``rel_to`` (the manifest output dir —
    the loader resolves relative paths against the manifest's own
    directory) or absolute when no base is given.
    """
    import numpy as np
    path = os.path.abspath(path)
    stored = os.path.relpath(path, rel_to) if rel_to else path
    if path.lower().endswith(".npy"):
        arr = np.load(path, mmap_mode="r")
        if arr.ndim >= 2:
            return {"id": utt, "feats": stored, "text": text,
                    "frames": int(arr.shape[0])}
        return {"id": utt, "audio": stored, "text": text,
                "samples": int(arr.shape[0])}
    n, rate = audio_io.audio_info(path)
    return {"id": utt, "audio": stored, "text": text,
            "samples": n, "rate": rate}


def records_from_dir(src: str, out: str = None):
    seen = set()
    for ext in AUDIO_EXTS:
        for path in sorted(glob.glob(os.path.join(src, f"*{ext}"))):
            utt = os.path.splitext(os.path.basename(path))[0]
            if utt in seen:
                continue
            txt = os.path.join(src, utt + ".txt")
            if not os.path.exists(txt):
                continue
            text = normalize_text(open(txt).read())
            if not text:
                continue
            seen.add(utt)
            yield _record_for(utt, path, text, rel_to=out)


def records_from_tsv(src: str, out: str = None):
    base = os.path.dirname(os.path.abspath(src))
    for line in open(src):
        parts = line.rstrip("\n").split("\t")
        if len(parts) != 3:
            continue
        utt, path, text = parts
        text = normalize_text(text)
        if not text:
            continue
        full = path if os.path.isabs(path) else os.path.join(base, path)
        yield _record_for(utt, full, text, rel_to=out)


def records_from_timit(src: str, out: str = None):
    """Raw TIMIT tree: *.WAV (SPHERE/RIFF) or pre-converted *.WAV.npy."""
    paths = sorted(
        glob.glob(os.path.join(src, "**", "*.WAV"), recursive=True)
        + glob.glob(os.path.join(src, "**", "*.wav"), recursive=True)
        + glob.glob(os.path.join(src, "**", "*.WAV.npy"), recursive=True))
    seen = set()
    for path in paths:
        stem = path[:-len(".WAV.npy")] if path.endswith(".WAV.npy") \
            else os.path.splitext(path)[0]
        if stem in seen:
            continue
        txt = stem + ".TXT"
        if not os.path.exists(txt):
            txt = stem + ".txt"
            if not os.path.exists(txt):
                continue
        raw = open(txt).read().split(None, 2)
        text = normalize_text(raw[2] if len(raw) >= 3 else "")
        if not text:
            continue
        seen.add(stem)
        utt = os.path.relpath(stem, src).replace(os.sep, "_").lower()
        yield _record_for(utt, path, text, rel_to=out)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--layout", choices=["dir", "tsv", "timit"], required=True)
    p.add_argument("--src", required=True)
    p.add_argument("--out", required=True, help="manifest output directory")
    p.add_argument("--split", default="train")
    p.add_argument("--val-frac", type=float, default=0.0,
                   help="carve off a validation split deterministically")
    p.add_argument("--dev-frac", type=float, default=0.0,
                   help="additionally carve a 'dev' split (for decode "
                        "hyperparameter tuning — the role the reference's "
                        "decoder_config.py sweeps played, SURVEY C9)")
    p.add_argument("--alphabet-out", default=None)
    args = p.parse_args(argv)

    gen = {"dir": records_from_dir, "tsv": records_from_tsv,
           "timit": records_from_timit}[args.layout]
    records = list(gen(args.src, os.path.abspath(args.out)))
    if not records:
        print("no records found", file=sys.stderr)
        return 1
    # deterministic split by utterance-id hash (a bare --dev-frac takes
    # this branch too — it used to be silently ignored without
    # --val-frac)
    if args.val_frac > 0 or args.dev_frac > 0:
        import hashlib
        val, dev, train = [], [], []
        v_bar = args.val_frac * 10000
        d_bar = (args.val_frac + args.dev_frac) * 10000
        for r in records:
            h = int(hashlib.md5(r["id"].encode()).hexdigest()[:8], 16) % 10000
            (val if h < v_bar else dev if h < d_bar else train).append(r)
        write_manifest(args.out, args.split, train)
        parts = [f"wrote {len(train)} train"]
        if args.val_frac > 0:
            write_manifest(args.out, "valid", val)
            parts.append(f"{len(val)} valid")
        if args.dev_frac > 0:
            write_manifest(args.out, "dev", dev)
            parts.append(f"{len(dev)} dev")
        print(" / ".join(parts) + " records")
    else:
        write_manifest(args.out, args.split, records)
        print(f"wrote {len(records)} {args.split} records")
    if args.alphabet_out:
        DEFAULT_ALPHABET.save(args.alphabet_out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
