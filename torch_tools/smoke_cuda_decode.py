#!/usr/bin/env python
"""On-card decode smoke: kernel B5 at the product shape against the plain
search.

Counterpart of ``tools/smoke_tpu_decode.py``.  It builds and runs the fused
beam search at exactly the configuration users run -- B = 32, T = 400,
K = 64, vocab 29 (the default alphabet), frame lengths T/2..T -- through
``ops.beam_cuda.beam_search`` and holds it against the plain search
``decode.beam.prefix_beam_search`` on the same posteriors, under
``PERF.md`` section 2's rules:

  * no LM and a trigram (alpha 0.8, beta 0.5): the kernel does the plain
    search's float steps in its order, so hypotheses, lengths and scores
    are equal (a score difference of 0);
  * B5's GRU branch (a seeded GRU char LM at E = 64, H = 128; alpha 0.7,
    beta 0.3): hypotheses equal on every utterance whose top-2 beam gap in
    the plain search exceeds 1e-2, scores within 1e-2 (the GRU's products
    sum in another order on the tensor cores).

Run on a card:  python3 torch_tools/smoke_cuda_decode.py
Exit code 0 = every row built, ran and agreed; nonzero otherwise.
``--device cpu`` runs the plain search on both sides (a functional check).
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

if __package__ in (None, ""):          # run as a script, not imported
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

# PERF.md section 2: the GRU rows' gap and score tolerance
GRU_GAP = 1e-2
GRU_TOL = 1e-2


def main(batch=32, t_frames=400, vocab=29, beam=64, max_len=128,
         device=None) -> int:
    """Run the three rows; returns the number that failed."""
    import torch

    from tpu_ctc_torch import resolve_device
    from tpu_ctc_torch.bench.bench import log_softmax_np
    from tpu_ctc_torch.decode import neural_lm
    from tpu_ctc_torch.decode.beam import prefix_beam_search
    from tpu_ctc_torch.decode.lm import train_ngram_lm
    from tpu_ctc_torch.ops.beam_cuda import beam_search
    from tpu_ctc_torch.utils.profiling import card_line

    dev = resolve_device(device)
    print(f"device: {card_line(dev)}", flush=True)
    rng = np.random.RandomState(0)
    x = rng.randn(batch, t_frames, vocab).astype(np.float32) * 2
    lp = torch.as_tensor(log_softmax_np(x), device=dev)
    lens = torch.as_tensor(rng.randint(t_frames // 2, t_frames + 1,
                                       size=batch), dtype=torch.int32,
                           device=dev)
    seqs = [rng.randint(1, vocab, 40).astype(np.int32) for _ in range(50)]
    lm = train_ngram_lm(seqs, vocab, order=3)
    nlm = neural_lm.init_params(
        neural_lm.CharRNNLMConfig(vocab_size=vocab, embed_dim=64,
                                  hidden_dim=128), seed=5, device=dev)

    failures = 0
    trigram = dict(lm_table=lm.tables(dev), lm_order=3, lm_alpha=0.8,
                   lm_beta=0.5)
    for label, gap_min, tol, kw in [
        ("no-LM", None, 0.0, {}),
        ("3-gram LM", None, 0.0, trigram),
        ("GRU-LM", GRU_GAP, GRU_TOL,
         dict(nlm_params=nlm, lm_alpha=0.7, lm_beta=0.3)),
    ]:
        t0 = time.time()
        hk, lk, sk = beam_search(lp, lens, beam_width=beam, max_len=max_len,
                                 **kw)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t_kernel = time.time() - t0
        hp, lpl, sp, slots, _, _ = prefix_beam_search(
            lp, lens, beam_width=beam, max_len=max_len, return_beams=True,
            **kw)
        score_diff = float((sk - sp).abs().max())
        same = (hk == hp).all(dim=1) & (lk == lpl)
        top2 = torch.topk(slots, 2, dim=1).values
        checked = (top2[:, 0] - top2[:, 1] > gap_min if gap_min is not None
                   else torch.ones_like(same))
        hyp_match = bool(same[checked].all())
        ok = score_diff <= tol and hyp_match
        failures += 0 if ok else 1
        print(f"{label}: build+run {t_kernel:.1f}s  score_diff="
              f"{score_diff:.2e} (limit {tol:.0e})  hyps equal on "
              f"{int(same[checked].sum())} of {int(checked.sum())} checked "
              f"utterances ({int(same.sum())} of {batch} in all)  "
              f"{'OK' if ok else 'FAIL'}", flush=True)
    return failures


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda)")
    sys.exit(main(device=p.parse_args().device))
