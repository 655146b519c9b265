"""The native C++ decoder (double sums, ``tpu_ctc_torch/decode/
cpp_decoder.py``) against kernel B5 (float32) on the same posteriors and
n-gram LM, under ``PERF.md`` section 2's rule, and readings of that rule
over seeds and lengths.

The rule (:func:`compare`, :func:`holds`), with the plain search in
float32 (B5's arithmetic) and in float64 (the C++ decoder's twin) on the
card beside them:

* B5 equals the float32 plain search: hypotheses and scores.
* The C++ decoder equals the float64 plain search on every utterance:
  hypotheses, scores within ``CPP_TWIN_RTOL``.
* An utterance is precision-sensitive where the float32 and float64
  searches part: other hypotheses, or scores more than ``CPP_SCORE_RTOL``
  apart (their beams took other candidates at a boundary tie within f32
  rounding).  At most ``SENSITIVE_SHARE`` of the utterances may be.
* On every other utterance B5's hypotheses equal the C++ decoder's and
  its scores are within ``CPP_SCORE_RTOL``.

Run on a card (phase 3's posteriors and trigram of ``chip_smoke.py``,
B = 64, K = 128, alpha 1.25, beta 1.5, at each seed and length):

    python3 torch_tools/cpp_b5.py --seeds 2,3,4,5,6 --frames 800,1600

One line per reading; exits 0 only if the rule holds on each.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

# A score is a chain of ~4 f32 roundings a frame (each <= 2^-24 of the
# running score, signs random): ~6e-8 sqrt(4 T) = 3.4e-6 at T = 800; the
# limit is ~6 of those, a fifth of the worst case of all roundings one way
# (4 T 2^-24 / 2 = 1e-4).
CPP_SCORE_RTOL = 2e-5
# Against the float64 plain search, its twin: both sum in double and the
# C++ decoder returns its score rounded to float32 (2^-24 = 6e-8).
CPP_TWIN_RTOL = 1e-6
# The share of precision-sensitive utterances allowed: readings on the
# card at B = 64, K = 128 (PERF.md section 2) with headroom.
SENSITIVE_SHARE = 0.25
# The C++ decoder's slices of a batch decoded at once (the card machine's
# host has 8 cores).
THREADS = 8


def compare(lp, lens, lm, beam_width, max_len, lm_alpha, lm_beta,
            dev="cuda") -> dict:
    """B5, the plain search in float32 and float64 (on ``dev``) and the C++
    decoder (``THREADS`` slices of the batch at once) on log posteriors
    ``lp`` [B, T, A] and lengths ``lens`` [B] (CPU tensors) with the
    n-gram ``lm``.  B5 is ``beam_cuda.beam_search``: on the CPU its plain
    version, which checks the rest of the rule there.  Returns the
    counts :func:`holds` judges, the utterances that the section 2 top-2
    gap rule (1e-3) checks and how many of them agree, and the C++
    decoder's summed and wall seconds."""
    from concurrent.futures import ThreadPoolExecutor

    from tpu_ctc_torch.decode import beam, cpp_decoder
    from tpu_ctc_torch.ops import beam_cuda
    kw = dict(beam_width=beam_width, max_len=max_len, lm_alpha=lm_alpha,
              lm_beta=lm_beta)
    table = lm.tables(dev)
    lp_d, lens_d = lp.to(dev), lens.to(dev)
    hk, lk, sk = (x.cpu() for x in beam_cuda.beam_search(
        lp_d, lens_d, lm_table=table, lm_order=lm.order, **kw))
    plain = {}
    for dtype in (torch.float32, torch.float64):
        out = beam.prefix_beam_search(lp_d, lens_d, lm_table=table,
                                      lm_order=lm.order, return_beams=True,
                                      dtype=dtype, **kw)
        plain[dtype] = [x.cpu() for x in out[:4]]
    lp_np, lens_np = lp.numpy(), lens.numpy()
    cpp_decoder.build()
    chunks = [c for c in np.array_split(np.arange(lp_np.shape[0]), THREADS)
              if len(c)]

    def decode(idx):
        t0 = time.time()
        out = cpp_decoder.beam_search_batch(lp_np[idx], lens_np[idx], lm=lm,
                                            **kw)
        return out, time.time() - t0

    t0 = time.time()
    with ThreadPoolExecutor(len(chunks)) as pool:
        parts = list(pool.map(decode, chunks))
    wall = time.time() - t0
    hc, lc, sc = (np.concatenate([p[0][j] for p in parts]) for j in range(3))

    def same(h1, l1, h2, l2, i):
        n = int(l1[i])
        return n == int(l2[i]) and list(h1[i][:n]) == list(h2[i][:n])

    def rel(s1, s2, i):
        return abs(float(s1[i]) - float(s2[i])) / abs(float(s2[i]))

    n = len(lc)
    h32, l32, s32, slots = plain[torch.float32]
    h64, l64, s64, _ = plain[torch.float64]
    sensitive = [i for i in range(n) if not same(h32, l32, h64, l64, i)
                 or rel(s32, s64, i) > CPP_SCORE_RTOL]
    stable = [i for i in range(n) if i not in sensitive]
    top2 = torch.topk(slots, 2, dim=1).values
    gapped = [i for i in range(n) if float(top2[i, 0] - top2[i, 1]) > 1e-3]
    return {
        "n": n,
        "b5_equals_f32": all(same(hk, lk, h32, l32, i) for i in range(n))
        and torch.equal(sk, s32),
        "cpp_equals_f64": sum(same(h64, l64, hc, lc, i) for i in range(n)),
        "twin_rel_err": max(rel(s64, sc, i) for i in range(n)),
        "sensitive": sensitive,
        "stable": len(stable),
        "stable_agree": sum(same(hk, lk, hc, lc, i) for i in stable),
        "rel_err": max([rel(sk, sc, i) for i in stable] or [0.0]),
        "gapped": len(gapped),
        "gapped_agree": sum(same(hk, lk, hc, lc, i) for i in gapped),
        "cpp_cpu_s": sum(p[1] for p in parts),
        "cpp_wall_s": wall,
    }


def holds(r: dict) -> bool:
    """Whether a :func:`compare` result meets the rule."""
    return (r["b5_equals_f32"] and r["cpp_equals_f64"] == r["n"]
            and r["twin_rel_err"] <= CPP_TWIN_RTOL
            and len(r["sensitive"]) <= SENSITIVE_SHARE * r["n"]
            and r["stable_agree"] == r["stable"]
            and r["rel_err"] <= CPP_SCORE_RTOL)


def summary(r: dict) -> str:
    """One line of a :func:`compare` result."""
    return (f"B5 equal to the float32 plain search: {r['b5_equals_f32']}; "
            f"cpp equal to the float64 plain search on {r['cpp_equals_f64']} "
            f"of {r['n']} (score rel err max {r['twin_rel_err']:.2e}, limit "
            f"{CPP_TWIN_RTOL}); {len(r['sensitive'])} utterances "
            f"precision-sensitive {r['sensitive']} (limit "
            f"{int(SENSITIVE_SHARE * r['n'])}); on the other {r['stable']} "
            f"B5's hyps equal cpp's on {r['stable_agree']}, score rel err max "
            f"{r['rel_err']:.3e} (limit {CPP_SCORE_RTOL}); section 2's top-2 "
            f"gap rule alone: equal on {r['gapped_agree']} of {r['gapped']}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--seeds", default="2",
                   help="posterior seeds (the trigram's is 3, as phase 3's)")
    p.add_argument("--frames", default="800")
    args = p.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke
    from tpu_ctc_torch.utils.profiling import card_line
    dev = torch.device("cuda")
    print(card_line(dev), flush=True)
    lm = chip_smoke.seeded_trigram(3)
    ok = True
    for n_t in (int(v) for v in args.frames.split(",")):
        for seed in (int(v) for v in args.seeds.split(",")):
            lp, lens = chip_smoke.peaked_posteriors(seed, 64, n_t)
            r = compare(lp, lens, lm, 128, n_t * 27 // 100, 1.25, 1.5, dev)
            ok &= holds(r)
            print(f"seed {seed} B=64 T={n_t} K=128: "
                  f"{summary(r)}; rule holds: {holds(r)}", flush=True)
            print(json.dumps({"seed": seed, "frames": n_t,
                              "sensitive": len(r["sensitive"]),
                              "n": r["n"], "holds": holds(r)}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
