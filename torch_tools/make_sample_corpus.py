#!/usr/bin/env python
"""Bundled sample corpus: synthesized speech-like audio in a TIMIT layout.

Counterpart of ``tools/make_sample_corpus.py`` (numpy and the port's
:mod:`tpu_ctc_torch.data.audio_io` only): with the same arguments and seed
it writes the same tree, byte for byte.

No real speech corpus is redistributable with this repo (and none is
mounted in the build environment), so the end-to-end accuracy chain —
raw audio tree → manifest → train → beam decode → WER — is proven on a
synthesized stand-in (VERDICT r1 item 1; SURVEY.md C12/§6).  This is NOT
a claim of human-speech WER parity; it proves every pipeline stage on
real audio *files* (NIST-SPHERE/RIFF containers, real STFT features,
real transcripts with a reusable word distribution for the LM).

Synthesis: each character maps to a formant pattern — vowels are
pitch-pulsed two-formant resonances, consonants are shaped noise bursts
or stops, space is silence.  Per-speaker pitch/formant scaling, linear
formant coarticulation between adjacent phones, duration jitter, and
additive noise make the mapping non-trivial but learnable at TIMIT-ish
corpus sizes.  Texts are drawn from a pseudo-English unigram/bigram word
process so a char n-gram LM has real structure to exploit.

Usage:
  python3 torch_tools/make_sample_corpus.py --out /tmp/sample_tree --n 400 \
      [--seconds-max 6] [--format sphere|wav] [--rate 16000] [--seed 0]
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

if __package__ in (None, ""):          # run as a script, not imported
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

from tpu_ctc_torch.data import audio_io  # noqa: E402

# Per-character articulation spec: (kind, F1, F2) — vowels voiced, others
# noise-shaped.  Values loosely follow vowel-space conventions; exact
# values are irrelevant, distinctness is what matters.
PHONES = {
    "a": ("v", 850, 1600), "e": ("v", 600, 2000), "i": ("v", 300, 2300),
    "o": ("v", 500, 900), "u": ("v", 350, 750), "y": ("v", 320, 2100),
    "w": ("v", 380, 850), "l": ("v", 450, 1100), "r": ("v", 490, 1350),
    "m": ("n", 280, 1000), "n": ("n", 320, 1450), "h": ("f", 900, 1800),
    "s": ("f", 4200, 6200), "z": ("f", 3800, 5600), "f": ("f", 3200, 5200),
    "v": ("f", 2800, 4600), "x": ("f", 2400, 4000), "j": ("f", 2000, 3400),
    "c": ("f", 2600, 4400), "g": ("p", 400, 1300), "k": ("p", 600, 1800),
    "t": ("p", 1800, 4000), "d": ("p", 1200, 2800), "p": ("p", 500, 1500),
    "b": ("p", 350, 1100), "q": ("p", 700, 2000), "'": ("p", 900, 2400),
    " ": ("sil", 0, 0),
}

WORDS = ["the", "a", "and", "to", "of", "in", "it", "is", "was", "he",
         "she", "that", "for", "on", "are", "with", "as", "his", "they",
         "be", "at", "one", "have", "this", "from", "or", "had", "by",
         "hot", "word", "but", "what", "some", "we", "can", "out",
         "other", "were", "all", "there", "when", "up", "use", "your",
         "how", "said", "an", "each", "she's", "which", "do", "their",
         "time", "if", "will", "way", "about", "many", "then", "them",
         "write", "would", "like", "so", "these", "her", "long", "make",
         "thing", "see", "him", "two", "has", "look", "more", "day",
         "could", "go", "come", "did", "number", "sound", "no", "most",
         "people", "my", "over", "know", "water", "than", "call",
         "first", "who", "may", "down", "side", "been", "now", "find"]


def sample_text(rng: np.random.RandomState, n_words: int) -> str:
    # Zipf-ish draw over the word list: common words much more likely.
    p = 1.0 / np.arange(1, len(WORDS) + 1) ** 0.8
    p /= p.sum()
    return " ".join(rng.choice(WORDS, size=n_words, p=p))


def synth_utterance(text: str, rate: int, rng: np.random.RandomState
                    ) -> np.ndarray:
    """Formant-synthesize one utterance."""
    f0 = rng.uniform(90, 220)             # speaker pitch
    fscale = rng.uniform(0.88, 1.15)      # vocal-tract length factor
    segs = []
    chars = list(text)
    for ci, c in enumerate(chars):
        kind, f1, f2 = PHONES.get(c, ("sil", 0, 0))
        dur = {"v": 0.11, "n": 0.09, "f": 0.09, "p": 0.06,
               "sil": 0.07}[kind] * rng.uniform(0.8, 1.25)
        n = max(int(dur * rate), 8)
        t = np.arange(n) / rate
        # Coarticulation: ramp formants toward the next phone's targets
        # over the final third of the segment.
        nf1, nf2 = f1, f2
        for cn in chars[ci + 1:ci + 2]:
            k2, g1, g2 = PHONES.get(cn, ("sil", f1, f2))
            if k2 != "sil":
                nf1, nf2 = g1, g2
        ramp = np.clip(3.0 * (t / dur) - 2.0, 0.0, 1.0)
        f1t = (f1 + (nf1 - f1) * 0.5 * ramp) * fscale
        f2t = (f2 + (nf2 - f2) * 0.5 * ramp) * fscale
        if kind == "sil":
            seg = 0.002 * rng.randn(n)
        elif kind == "v" or kind == "n":
            # Voiced: two formant sinusoids amplitude-modulated at f0
            # (a cheap stand-in for a pulsed source through resonances).
            pitch = 0.6 + 0.4 * np.cos(2 * np.pi * f0 * t)
            ph1 = 2 * np.pi * np.cumsum(f1t) / rate
            ph2 = 2 * np.pi * np.cumsum(f2t) / rate
            w1 = 1.0 if kind == "v" else 1.3
            seg = pitch * (w1 * np.sin(ph1) + 0.6 * np.sin(ph2))
            if kind == "n":
                seg *= 0.5
        elif kind == "f":
            # Fricative: noise heterodyned to the formant band.
            noise = rng.randn(n)
            seg = 0.45 * noise * np.cos(2 * np.pi * f1t * t / 2)
            seg += 0.25 * noise * np.sin(2 * np.pi * f2t * t / 2)
        else:  # plosive: short burst then near-silence
            burst = max(int(0.25 * n), 4)
            seg = np.zeros(n)
            seg[:burst] = 0.8 * rng.randn(burst) * np.cos(
                2 * np.pi * f1t[:burst] * t[:burst])
        # Segment amplitude envelope (attack/decay) avoids clicks.
        env = np.minimum(np.arange(n), np.arange(n)[::-1])
        env = np.minimum(env / max(int(0.01 * rate), 1), 1.0)
        segs.append(seg * env)
    x = np.concatenate(segs)
    x += 0.01 * rng.randn(len(x))         # channel noise
    peak = np.max(np.abs(x)) + 1e-6
    return (0.6 * x / peak).astype(np.float32)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out", required=True)
    p.add_argument("--n", type=int, default=200)
    p.add_argument("--words-min", type=int, default=2)
    p.add_argument("--words-max", type=int, default=7)
    p.add_argument("--rate", type=int, default=16000)
    p.add_argument("--format", choices=["sphere", "wav"], default="sphere")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    rng = np.random.RandomState(args.seed)
    n_speakers = max(args.n // 10, 1)
    for i in range(args.n):
        spk = i % n_speakers
        # Per-speaker RNG stream for voice parameters, per-utt for content.
        urng = np.random.RandomState(args.seed * 7919 + i)
        vrng = np.random.RandomState(args.seed * 104729 + spk)
        n_words = urng.randint(args.words_min, args.words_max + 1)
        text = sample_text(urng, n_words)
        # blend: voice params from speaker stream, jitter from utt stream
        mix = np.random.RandomState(
            (vrng.randint(1 << 30) * 31 + urng.randint(1 << 30)) % (1 << 31))
        wav = synth_utterance(text, args.rate, mix)
        d = os.path.join(args.out, f"dr1/spk{spk:03d}")
        os.makedirs(d, exist_ok=True)
        stem = os.path.join(d, f"su{i:04d}")
        if args.format == "sphere":
            audio_io.write_sphere(stem + ".WAV", wav, args.rate)
        else:
            audio_io.write_wav(stem + ".WAV", wav, args.rate)
        with open(stem + ".TXT", "w") as f:
            f.write(f"0 {len(wav)} {text}.\n")
    total_s = args.n * 0.1 * (args.words_min + args.words_max) / 2 * 5
    print(f"wrote {args.n} utterances (~{total_s:.0f}s est.) under {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
