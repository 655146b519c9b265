"""The prefix beam search with a character n-gram LM (Hannun et al.,
"First-pass large vocabulary continuous speech recognition using
bi-directional recurrent DNNs", 2014), batched on fixed [B, K] beams with
a Python loop over frames.

A frozen copy of the plain search of the port at the time this benchmark
was written (``prefix_beam_search`` there, without the GRU LM and the
per-frame char cap, which no cell uses): duplicate prefixes merged
through an invertible rolling hash, candidates laid out as (stay, then
(char, beam)), ties taken by the lowest index, survivors re-packed in that
order.  Kept here so the benchmark's yardstick cannot move with the
program.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30
_H1_MULT, _H2_MULT = 2654435761, 40503
_H1_INV, _H2_INV = 244002641, 1650947975
_H1_EMPTY, _H2_EMPTY = 0x9E3779B9, 0x85EBCA6B
_MASK32 = 0xFFFFFFFF


def _lse2(a, b):
    m = torch.maximum(a, b)
    m_safe = torch.clamp(m, min=NEG_INF / 2)
    out = m_safe + torch.log(torch.exp(a - m_safe) + torch.exp(b - m_safe)
                             + 1e-37)
    return torch.where(m > NEG_INF / 2, out, torch.full_like(out, NEG_INF))


def _mul32(h, m: int):
    lo = (h & 0xFFFF) * m
    hi = ((h >> 16) * m) & 0xFFFF
    return (lo + (hi << 16)) & _MASK32


def _stable_topk(x, k: int):
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _lm_rows(table, order: int, last, last2):
    if order == 1:
        return table.expand(*last.shape, table.shape[0])
    if order == 2:
        return table[last]
    return table[last2, last]


@torch.no_grad()
def search(log_probs: torch.Tensor, frame_lengths: torch.Tensor,
           beam_width: int, max_len: int, lm_table: torch.Tensor,
           lm_order: int, lm_alpha: float, lm_beta: float,
           prune_logp: Optional[float], blank: int = 0,
           dtype: torch.dtype = torch.float32):
    """log_probs [B, T, A], frame_lengths [B] -> (hyps [B, max_len] int32,
    lengths [B] int32, scores [B]).  ``dtype`` is that of the scores and
    their sums (float32 as the configuration states; the control's is
    bfloat16)."""
    dev = log_probs.device
    lp_all = log_probs.to(dtype)
    n_b, n_t, a = lp_all.shape
    k = beam_width
    lens = frame_lengths.to(dev).to(torch.int64)
    lm_table = lm_table.to(device=dev, dtype=dtype)
    i64 = torch.int64
    bidx = torch.arange(n_b, device=dev)[:, None]
    beam_ids = torch.arange(k, device=dev, dtype=i64)
    chars = torch.arange(a, device=dev, dtype=i64)
    buf = torch.zeros((n_b, k, max_len), dtype=torch.int32, device=dev)
    plen = torch.zeros((n_b, k), dtype=i64, device=dev)
    last = torch.zeros((n_b, k), dtype=i64, device=dev)
    last2 = torch.zeros((n_b, k), dtype=i64, device=dev)
    dead_hash = (beam_ids + 1).expand(n_b, k)
    h1 = torch.where(beam_ids == 0, _H1_EMPTY, beam_ids + 1).expand(n_b, k)
    h2 = torch.where(beam_ids == 0, _H2_EMPTY, beam_ids + 1).expand(n_b, k)
    pb = torch.where(beam_ids == 0, 0.0, NEG_INF).to(dtype).expand(
        n_b, k).clone()
    pnb = torch.full((n_b, k), NEG_INF, dtype=dtype, device=dev)
    neg = torch.tensor(NEG_INF, dtype=dtype, device=dev)
    chars_sel = torch.where(chars < blank, chars, chars + 1)[:a - 1].expand(
        n_b, a - 1)
    for t in range(n_t):
        lp = lp_all[:, t]
        total = _lse2(pb, pnb)
        lp_ext = torch.where(chars == blank, neg, lp)
        lp_sel = torch.gather(lp_ext, 1, chars_sel)
        if prune_logp is not None:
            lp_sel = torch.where(lp_sel < prune_logp, neg, lp_sel)
        lm_row = lm_alpha * _lm_rows(lm_table, lm_order, last, last2) \
            + lm_beta
        # a beam's mate: the beam holding its prefix without the last char
        ph1 = _mul32((h1 - last) & _MASK32, _H1_INV)
        ph2 = _mul32((h2 - last) & _MASK32, _H2_INV)
        has_parent = (plen > 0) & (total > NEG_INF / 2)
        match = ((ph1[:, :, None] == h1[:, None, :])
                 & (ph2[:, :, None] == h2[:, None, :])
                 & has_parent[:, :, None])
        mate = torch.argmax(match.to(torch.int32), dim=2)
        has_mate = match.any(dim=2)
        lp_last = torch.gather(lp, 1, last)
        stay_pb = total + lp[:, blank:blank + 1]
        stay_pnb = torch.where(plen > 0, pnb + lp_last, neg)
        last_m = torch.gather(last, 1, mate)
        base_mate = torch.where(last_m == last, torch.gather(pb, 1, mate),
                                torch.gather(total, 1, mate))
        ext_from_mate = base_mate + lp_last + torch.gather(
            lm_row[bidx, mate], 2, last[:, :, None])[:, :, 0]
        gate = has_mate
        if prune_logp is not None:
            gate = gate & (torch.gather(lp_ext, 1, last) >= prune_logp)
        stay_pnb = _lse2(stay_pnb, torch.where(gate, ext_from_mate, neg))
        is_last = ((chars_sel[:, None, :] == last[:, :, None])
                   & (plen > 0)[:, :, None])
        base = torch.where(is_last, pb[:, :, None], total[:, :, None])
        ext_pnb = base + lp_sel[:, None, :] + torch.gather(
            lm_row, 2, chars_sel[:, None, :].expand(n_b, k, -1))
        ext_pnb = torch.where((plen >= max_len)[:, :, None], neg, ext_pnb)
        last_oh = (last[:, :, None] == chars_sel[:, None, :]).to(
            torch.float32)
        excl = torch.bmm(match.to(torch.float32).transpose(1, 2), last_oh)
        ext_pnb = torch.where(excl > 0, neg, ext_pnb)
        ext_full = torch.full((n_b, k, a), NEG_INF, dtype=dtype, device=dev)
        ext_full.scatter_(2, chars_sel[:, None, :].expand(n_b, k, -1),
                          ext_pnb)
        stay_merged = _lse2(stay_pb, stay_pnb)
        grid = torch.where((chars == blank)[None, :, None],
                           stay_merged[:, None, :], ext_full.transpose(1, 2))
        scores = grid.reshape(n_b, a * k)
        top_score, top_idx = _stable_topk(scores, k)
        dead = top_score < NEG_INF / 2
        order = torch.argsort(torch.where(dead, a * k, top_idx), dim=1,
                              stable=True)
        top_idx = torch.gather(top_idx, 1, order)
        dead = torch.gather(dead, 1, order)
        t_parent = top_idx % k
        cidx = top_idx // k
        is_stay = cidx == blank
        t_ext = torch.where(is_stay, -1, cidx)
        n_pb = torch.where(dead | ~is_stay, neg,
                           torch.gather(stay_pb, 1, t_parent))
        n_pnb = torch.where(dead, neg, torch.where(
            is_stay, torch.gather(stay_pnb, 1, t_parent),
            torch.gather(scores, 1, top_idx)))
        n_buf = buf[bidx, t_parent]
        p_len = torch.gather(plen, 1, t_parent)
        extend = t_ext >= 0
        pos = torch.clamp(p_len, 0, max_len - 1)
        onehot = ((torch.arange(max_len, device=dev)[None, None, :]
                   == pos[:, :, None]) & extend[:, :, None])
        n_buf = torch.where(onehot, t_ext[:, :, None].to(torch.int32), n_buf)
        n_plen = p_len + extend.to(i64)
        p_last = torch.gather(last, 1, t_parent)
        n_last = torch.where(extend, t_ext, p_last)
        n_last2 = torch.where(extend, p_last, torch.gather(last2, 1, t_parent))
        ext_c = torch.clamp(t_ext, min=0)
        p_h1 = torch.gather(h1, 1, t_parent)
        p_h2 = torch.gather(h2, 1, t_parent)
        n_h1 = torch.where(extend, (_mul32(p_h1, _H1_MULT) + ext_c) & _MASK32,
                           p_h1)
        n_h2 = torch.where(extend, (_mul32(p_h2, _H2_MULT) + ext_c) & _MASK32,
                           p_h2)
        n_h1 = torch.where(dead, dead_hash, n_h1)
        n_h2 = torch.where(dead, dead_hash, n_h2)
        active = (t < lens)[:, None]
        buf = torch.where(active[:, :, None], n_buf, buf)
        plen = torch.where(active, n_plen, plen)
        last = torch.where(active, n_last, last)
        last2 = torch.where(active, n_last2, last2)
        h1 = torch.where(active, n_h1, h1)
        h2 = torch.where(active, n_h2, h2)
        pb = torch.where(active, n_pb, pb)
        pnb = torch.where(active, n_pnb, pnb)
    score = _lse2(pb, pnb)
    best = torch.argmax(score, dim=1)
    rows = torch.arange(n_b, device=dev)
    return buf[rows, best], plen[rows, best].to(torch.int32), \
        score[rows, best]
