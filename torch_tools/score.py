#!/usr/bin/env python
"""WER/CER scoring harness of the port -- an in-repo sclite equivalent.

Counterpart of ``tools/score.py``, on :mod:`tpu_ctc_torch.decode.wer`:
trn-style files ("words... (utt_id)" per line) or plain
"utt_id<TAB>text" files are aligned with per-utterance and corpus WER/CER
plus sub/ins/del breakdowns, a bootstrap confidence interval and a paired
bootstrap against a second system.  The same options print the same lines.

Usage:
  python3 torch_tools/score.py --ref ref.trn --hyp hyp.trn [--unit char] [--per-utt]
"""
from __future__ import annotations

import argparse
import os
import sys

if __package__ in (None, ""):          # run as a script, not imported
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

from tpu_ctc_torch.decode.wer import (align_counts,  # noqa: E402,F401
                                      bootstrap_ci, format_score_line,
                                      paired_bootstrap, parse_trn,
                                      score_corpus)
from tpu_ctc_torch.decode.wer import score_corpus as score  # noqa: E402,F401


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--ref", required=True)
    p.add_argument("--hyp", required=True)
    p.add_argument("--unit", choices=["word", "char"], default="word")
    p.add_argument("--per-utt", action="store_true")
    p.add_argument("--ci", action="store_true",
                   help="bootstrap 95%% CI (2000 utterance resamples)")
    p.add_argument("--hyp2", default=None,
                   help="second system's trn: paired bootstrap of "
                        "WER(hyp) - WER(hyp2) over shared resamples")
    args = p.parse_args(argv)

    refs = parse_trn(args.ref)
    hyps = parse_trn(args.hyp)
    totals, per_utt = score_corpus(refs, hyps, args.unit)
    line = format_score_line(totals, args.unit)
    if args.ci:
        lo, hi = bootstrap_ci(refs, hyps, args.unit)
        line += f"  95% CI [{100*lo:.2f}, {100*hi:.2f}]"
    print(line)
    if args.hyp2:
        hyps2 = parse_trn(args.hyp2)
        t2, _ = score_corpus(refs, hyps2, args.unit)
        l2 = format_score_line(t2, args.unit) + " (hyp2)"
        if args.ci:
            lo, hi = bootstrap_ci(refs, hyps2, args.unit)
            l2 += f"  95% CI [{100*lo:.2f}, {100*hi:.2f}]"
        print(l2)
        d, lo, hi, p_better = paired_bootstrap(refs, hyps, hyps2, args.unit)
        print(f"paired bootstrap hyp-hyp2: {100*d:+.2f} "
              f"[{100*lo:+.2f}, {100*hi:+.2f}] "
              f"P(hyp2 better)={p_better:.3f}")
    if args.per_utt:
        for utt, r in sorted(per_utt.items(), key=lambda kv: -kv[1])[:50]:
            print(f"  {utt}\t{100*r:.1f}%")
    return 0


if __name__ == "__main__":
    sys.exit(main())
