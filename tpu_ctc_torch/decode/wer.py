"""Edit distance, CER and WER scoring.

A copy of the host functions of ``tpu_ctc.decode.wer`` (a numpy
Levenshtein with a sub/ins/del backtrace, corpus scoring, bootstrap CIs
and sclite-style trn files), and its batched edit distance as tensor code
on the batch's device (:func:`batched_edit_distance`, :func:`batched_cer`).
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

def edit_distance(ref: Sequence, hyp: Sequence) -> int:
    """Levenshtein distance (host-side, anti-diagonal-free simple DP)."""
    n, m = len(ref), len(hyp)
    if n == 0:
        return m
    if m == 0:
        return n
    hyp_arr = np.asarray(list(hyp))
    prev = np.arange(m + 1)
    for i in range(1, n + 1):
        cur = np.empty(m + 1, dtype=np.int64)
        cur[0] = i
        sub = prev[:-1] + (hyp_arr != ref[i - 1])
        # cur[j] = min(prev[j]+1, cur[j-1]+1, sub[j-1]) — resolve the
        # left-to-right dependency with a running scan.
        np.minimum(prev[1:] + 1, sub, out=cur[1:])
        for j in range(1, m + 1):       # cheap: m is utterance-length scale
            if cur[j - 1] + 1 < cur[j]:
                cur[j] = cur[j - 1] + 1
        prev = cur
    return int(prev[m])


def cer(refs: List[Sequence], hyps: List[Sequence]) -> float:
    """Character error rate over id sequences or strings."""
    errs = sum(edit_distance(list(r), list(h)) for r, h in zip(refs, hyps))
    total = sum(max(len(r), 1) for r in refs)
    return errs / max(total, 1)


def wer(refs: List[str], hyps: List[str]) -> float:
    """Word error rate over transcript strings."""
    r_words = [r.split() for r in refs]
    h_words = [h.split() for h in hyps]
    errs = sum(edit_distance(r, h) for r, h in zip(r_words, h_words))
    total = sum(max(len(r), 1) for r in r_words)
    return errs / max(total, 1)


def align_counts(ref: Sequence, hyp: Sequence) -> Tuple[int, int, int]:
    """(substitutions, insertions, deletions) from a Levenshtein backtrace.

    The sclite-style breakdown of the eval2000 scoring path (SURVEY.md
    C13); corpus scoring in :func:`score_corpus` totals these per token.
    """
    ref, hyp = list(ref), list(hyp)
    n, m = len(ref), len(hyp)
    d = np.zeros((n + 1, m + 1), np.int64)
    d[:, 0] = np.arange(n + 1)
    d[0, :] = np.arange(m + 1)
    for i in range(1, n + 1):
        d[i, 1:] = np.minimum(d[i - 1, 1:] + 1,
                              d[i - 1, :-1] + (np.asarray(hyp) != ref[i - 1]))
        for j in range(1, m + 1):
            if d[i, j - 1] + 1 < d[i, j]:
                d[i, j] = d[i, j - 1] + 1
    i, j = n, m
    sub = ins = dele = 0
    while i > 0 or j > 0:
        if i > 0 and j > 0 and d[i, j] == d[i - 1, j - 1] \
                and ref[i - 1] == hyp[j - 1]:
            i, j = i - 1, j - 1
        elif i > 0 and j > 0 and d[i, j] == d[i - 1, j - 1] + 1:
            sub += 1
            i, j = i - 1, j - 1
        elif j > 0 and d[i, j] == d[i, j - 1] + 1:
            ins += 1
            j -= 1
        else:
            dele += 1
            i -= 1
    return sub, ins, dele


def score_corpus(refs: dict, hyps: dict, unit: str = "word"):
    """Corpus WER/CER with sub/ins/del totals over {utt_id: text} dicts."""
    tok = (lambda s: s.split()) if unit == "word" else (lambda s: list(s))
    totals = {"sub": 0, "ins": 0, "del": 0, "ref_tokens": 0, "utts": 0,
              "missing_hyps": 0}
    per_utt = {}
    for utt, ref_text in sorted(refs.items()):
        hyp_text = hyps.get(utt)
        if hyp_text is None:
            totals["missing_hyps"] += 1
            hyp_text = ""
        r, h = tok(ref_text), tok(hyp_text)
        s, i, d = align_counts(r, h)
        totals["sub"] += s
        totals["ins"] += i
        totals["del"] += d
        totals["ref_tokens"] += len(r)
        totals["utts"] += 1
        per_utt[utt] = (s + i + d) / max(len(r), 1)
    errs = totals["sub"] + totals["ins"] + totals["del"]
    totals["error_rate"] = errs / max(totals["ref_tokens"], 1)
    return totals, per_utt


def _per_utt_counts(refs: dict, hyps: dict, unit: str = "word"):
    """Aligned per-utterance (errors, ref_tokens) arrays over sorted ids."""
    tok = (lambda s: s.split()) if unit == "word" else (lambda s: list(s))
    errs, toks = [], []
    for utt, ref_text in sorted(refs.items()):
        r, h = tok(ref_text), tok(hyps.get(utt) or "")
        s, i, d = align_counts(r, h)
        errs.append(s + i + d)
        toks.append(len(r))
    return np.asarray(errs, np.int64), np.asarray(toks, np.int64)


def bootstrap_ci(refs: dict, hyps: dict, unit: str = "word",
                 n_boot: int = 2000, seed: int = 0,
                 alpha: float = 0.05) -> Tuple[float, float]:
    """Percentile bootstrap CI on the corpus error rate.

    Resamples UTTERANCES with replacement (the unit of independence in a
    speech eval set; token-level resampling would understate variance),
    recomputing errors/ref_tokens per resample.  Returns the
    (alpha/2, 1 - alpha/2) percentile band of the error rate.
    """
    errs, toks = _per_utt_counts(refs, hyps, unit)
    n = len(errs)
    rng = np.random.RandomState(seed)
    idx = rng.randint(0, n, size=(n_boot, n))
    rates = errs[idx].sum(axis=1) / np.maximum(toks[idx].sum(axis=1), 1)
    lo, hi = np.percentile(rates, [100 * alpha / 2, 100 * (1 - alpha / 2)])
    return float(lo), float(hi)


def paired_bootstrap(refs: dict, hyps_a: dict, hyps_b: dict,
                     unit: str = "word", n_boot: int = 2000, seed: int = 0,
                     alpha: float = 0.05):
    """Paired bootstrap of WER(A) - WER(B) over SHARED resamples.

    The right test for "decoder A beats decoder B on this eval set": the
    same utterance draw scores both systems, so per-utterance difficulty
    cancels and the CI reflects the systems' difference, not the set's
    spread.  Returns (mean_diff, lo, hi, p_b_better) where p_b_better is
    the fraction of resamples with WER(B) < WER(A).
    """
    # coverage must be symmetric: an utterance missing from only one
    # system would be scored as all-deletions for it, silently biasing
    # the paired diff
    miss_a = {u for u in refs if not hyps_a.get(u)}
    miss_b = {u for u in refs if not hyps_b.get(u)}
    if miss_a != miss_b:
        raise ValueError(
            f"asymmetric hypothesis coverage: {len(miss_a ^ miss_b)} "
            "utterances present in only one system "
            f"(e.g. {sorted(miss_a ^ miss_b)[:3]})")
    errs_a, toks = _per_utt_counts(refs, hyps_a, unit)
    errs_b, _ = _per_utt_counts(refs, hyps_b, unit)
    n = len(toks)
    rng = np.random.RandomState(seed)
    idx = rng.randint(0, n, size=(n_boot, n))
    tt = np.maximum(toks[idx].sum(axis=1), 1)
    diff = errs_a[idx].sum(axis=1) / tt - errs_b[idx].sum(axis=1) / tt
    lo, hi = np.percentile(diff, [100 * alpha / 2, 100 * (1 - alpha / 2)])
    return (float(diff.mean()), float(lo), float(hi),
            float((diff > 0).mean()))


def parse_trn(path: str) -> dict:
    """Parse trn ("text (utt)") or tsv ("utt\\ttext") transcript files."""
    import re
    out = {}
    for line in open(path):
        line = line.rstrip("\n").strip()
        if not line:
            continue
        m = re.match(r"^(.*)\(([^()]+)\)\s*$", line)
        if m:
            out[m.group(2).strip()] = m.group(1).strip().lower()
        elif "\t" in line:
            utt, text = line.split("\t", 1)
            out[utt.strip()] = text.strip().lower()
        else:
            raise ValueError(f"unparseable line in {path}: {line!r}")
    return out


def write_trn(path: str, transcripts: dict) -> None:
    """Write {utt_id: text} as an sclite-style trn file."""
    with open(path, "w") as f:
        for utt in sorted(transcripts):
            f.write(f"{transcripts[utt]} ({utt})\n")


def format_score_line(totals: dict, unit: str = "word") -> str:
    name = "WER" if unit == "word" else "CER"
    return (f"{name} {100 * totals['error_rate']:.2f}%  "
            f"[sub {totals['sub']} ins {totals['ins']} del {totals['del']} "
            f"/ {totals['ref_tokens']} {unit}s, {totals['utts']} utts, "
            f"{totals['missing_hyps']} missing hyps]")


def batched_edit_distance(refs: torch.Tensor, ref_lens: torch.Tensor,
                          hyps: torch.Tensor,
                          hyp_lens: torch.Tensor) -> torch.Tensor:
    """Batched Levenshtein over padded id sequences, on their device.

    refs [B, N], hyps [B, M]: padded; lengths give valid extents.  Returns
    int32 distances [B].  The DP runs row by row over the ref axis; within a
    row cur[j] = min(indep[j], cur[j-1] + 1) is the (min,+) prefix scan
    cur = cummin(indep - j) + j.  Rows past an utterance's ref length keep
    the previous row."""
    b, n = refs.shape
    m = hyps.shape[1]
    dev = refs.device
    j = torch.arange(m + 1, device=dev, dtype=torch.int64)
    prev = j.expand(b, m + 1).clone()
    ref_lens = torch.as_tensor(ref_lens, device=dev)
    for i in range(n):
        sub = (hyps != refs[:, i:i + 1]).to(torch.int64)        # [B, M]
        indep = torch.minimum(prev[:, 1:] + 1,                  # deletion
                              prev[:, :-1] + sub)               # substitution
        indep = torch.cat([torch.full((b, 1), i + 1, dtype=torch.int64,
                                      device=dev), indep], dim=1)
        cur = torch.cummin(indep - j, dim=1).values + j
        prev = torch.where((i < ref_lens)[:, None], cur, prev)
    idx = torch.as_tensor(hyp_lens, device=dev).to(torch.int64)[:, None]
    return torch.gather(prev, 1, idx)[:, 0].to(torch.int32)


def batched_cer(refs, ref_lens, hyps, hyp_lens) -> torch.Tensor:
    """Corpus CER of a batch of padded id sequences (on their device): the
    summed edit distances over the summed ref lengths."""
    d = batched_edit_distance(refs, ref_lens, hyps, hyp_lens)
    ref_lens = torch.as_tensor(ref_lens, device=d.device)
    return d.sum().to(torch.float32) / torch.clamp_min(
        ref_lens.sum(), 1).to(torch.float32)
