"""CTC prefix beam search with character-LM fusion: the plain version.

Counterpart of ``tpu_ctc.decode.beam.prefix_beam_search`` (the XLA scan
search): fixed-shape beam tensors [B, K], a Python loop over frames, the
sort-free duplicate merge through an invertible rolling hash ("mate"
fold), n-gram LM rows for orders <= 3, the GRU char LM (each beam carries
its state, stepped on its char where it extends), ``prune_logp`` and
``char_topk``.  The candidate grid is laid out in the fused kernel's
enumeration order (stays on the blank row, then (char, beam)), top-K
breaks exact ties by lowest enumeration index and the survivors are
re-packed in enumeration order, dead slots last, so the per-frame beam
states equal the kernels'.

:func:`prefix_beam_search_host` is the dict-based host algorithm for one
utterance, the recompute-from-prefix oracle of the batched search.

:func:`make_beam_decoder` (the model, then :func:`make_beam_search`, its
search on log posteriors) routes CUDA batches through kernel B5 (K <= 128)
or B6 (K in (128, 256]) in ``ops.beam_cuda`` and raises on CUDA for what
they do not take; on the CPU this plain search runs, with a warning for a
configuration that the kernels would refuse.
"""
from __future__ import annotations

import logging
import math
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from tpu_ctc_torch.decode import neural_lm
from tpu_ctc_torch.decode.lm import NGramCharLM
from tpu_ctc_torch.utils import profiling

NEG_INF = -1e30

# Rolling-hash multipliers (odd => invertible mod 2^32) and their inverses:
# h_parent = (h - c) * M^-1 recovers the hash of the prefix minus its last
# char, which is what makes the sort-free duplicate merge work.
_H1_MULT = 2654435761
_H2_MULT = 40503
_H1_INV = 244002641
_H2_INV = 1650947975
_H1_EMPTY = 0x9E3779B9
_H2_EMPTY = 0x85EBCA6B
_MASK32 = 0xFFFFFFFF


def _lse2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    m = torch.maximum(a, b)
    m_safe = torch.clamp(m, min=NEG_INF / 2)
    out = m_safe + torch.log(torch.exp(a - m_safe) + torch.exp(b - m_safe)
                             + 1e-37)
    return torch.where(m > NEG_INF / 2, out, torch.full_like(out, NEG_INF))


def _mul32(h: torch.Tensor, m: int) -> torch.Tensor:
    """(h * m) mod 2^32 for int64 h in [0, 2^32) without int64 overflow."""
    lo = (h & 0xFFFF) * m
    hi = ((h >> 16) * m) & 0xFFFF
    return (lo + (hi << 16)) & _MASK32


def _np_lse(*xs):
    m = max(xs)
    if m <= NEG_INF / 2:
        return NEG_INF
    return m + math.log(sum(math.exp(x - m) for x in xs))


def prefix_beam_search_host(log_probs: np.ndarray,
                            length: Optional[int] = None,
                            beam_width: int = 64, blank: int = 0, lm=None,
                            lm_alpha: float = 1.0,
                            lm_beta: float = 0.0) -> Tuple[List[int], float]:
    """Exact dict-based prefix beam search for ONE utterance, in float64.

    log_probs: [T, A] normalized log posteriors; ``lm`` anything with
    ``score_host(prefix, c)`` (``NGramCharLM``, ``CharRNNLMHost``).
    Returns (best prefix ids, its log score).
    """
    log_probs = np.asarray(log_probs, dtype=np.float64)
    t_total, a = log_probs.shape
    if length is None:
        length = t_total
    # prefix -> [p_blank, p_non_blank]
    beams: Dict[Tuple[int, ...], List[float]] = {(): [0.0, NEG_INF]}
    for t in range(length):
        lp = log_probs[t]
        new: Dict[Tuple[int, ...], List[float]] = defaultdict(
            lambda: [NEG_INF, NEG_INF])
        for prefix, (pb, pnb) in beams.items():
            total = _np_lse(pb, pnb)
            ent = new[prefix]                 # stay: emit blank
            ent[0] = _np_lse(ent[0], total + lp[blank])
            if prefix:                        # stay: repeat the last char
                ent[1] = _np_lse(ent[1], pnb + lp[prefix[-1]])
            for c in range(a):                # extend with every char
                if c == blank:
                    continue
                contrib = (pb if (prefix and c == prefix[-1]) else total) \
                    + lp[c]
                if lm is not None:
                    contrib += lm_alpha * lm.score_host(prefix, c) + lm_beta
                ext = new[prefix + (c,)]
                ext[1] = _np_lse(ext[1], contrib)
        items = sorted(new.items(), key=lambda kv: -_np_lse(*kv[1]))
        beams = dict(items[:beam_width])
    best, (pb, pnb) = max(beams.items(), key=lambda kv: _np_lse(*kv[1]))
    return list(best), _np_lse(pb, pnb)


def _lm_scores(lm_table: torch.Tensor, order: int, last: torch.Tensor,
               last2: torch.Tensor) -> torch.Tensor:
    """Per-beam LM rows [B, K, A] of log P(c | context); context 0 = BOS."""
    if order == 1:
        return lm_table.expand(*last.shape, lm_table.shape[0])
    if order == 2:
        return lm_table[last]
    if order == 3:
        return lm_table[last2, last]
    raise ValueError(f"device decoder supports LM order<=3, got {order}")


def _stable_topk(x: torch.Tensor, k: int):
    """Top-k along the last dim, exact ties taken by lowest index first
    (as XLA's top_k); ``torch.topk`` gives no such order."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


@torch.no_grad()
def prefix_beam_search(log_probs: torch.Tensor, frame_lengths: torch.Tensor,
                       beam_width: int = 64, max_len: int = 128,
                       blank: int = 0,
                       lm_table: Optional[torch.Tensor] = None,
                       lm_order: int = 0, lm_alpha: float = 1.0,
                       lm_beta: float = 0.0, nlm_params=None,
                       char_topk: int = 0,
                       prune_logp: Optional[float] = None,
                       return_beams: bool = False,
                       dtype: torch.dtype = torch.float32):
    """Batched prefix beam search on the tensors' device.

    log_probs [B, T, A] normalized log posteriors, frame_lengths [B] ->
    (hyps [B, max_len] int32, hyp_lengths [B] int32, scores [B] f32);
    ``return_beams`` appends every slot's final score and length [B, K]
    and prefix [B, K, max_len] (valid up to its length).
    ``nlm_params`` is a GRU char LM (``neural_lm.CharRNNLM``) on the
    tensors' device; its rows ``lm_alpha * log_probs(h) + lm_beta`` are
    added to the n-gram rows (so beta counts twice when both are on, as in
    the JAX package).  ``dtype`` is that of the scores and their sums:
    float32 as the kernels and the reference; float64 gives the same
    search in double, the twin of the C++ host decoder
    (``decode/cpp_decoder.py``), which sums in double.
    """
    dev = log_probs.device
    lp_all = log_probs.to(dtype)
    n_b, n_t, a = lp_all.shape
    k = beam_width
    c_cols = a - 1 if not char_topk else min(char_topk, a - 1)
    lens = frame_lengths.to(dev).to(torch.int64)
    if lm_table is not None:
        lm_table = lm_table.to(device=dev, dtype=dtype)

    i64 = torch.int64
    bidx = torch.arange(n_b, device=dev)[:, None]            # [B, 1]
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
    hlm = None
    if nlm_params is not None:
        # per-beam GRU state over the prefix, from the BOS-stepped start
        hlm = neural_lm.init_state(nlm_params, (n_b, k))

    for t in range(n_t):
        lp = lp_all[:, t]                                      # [B, A]
        total = _lse2(pb, pnb)                                 # [B, K]

        # ---- frame-level char preselection ---------------------------
        lp_ext = torch.where(chars == blank, neg, lp)
        if c_cols < a - 1:
            lp_sel, chars_sel = _stable_topk(lp_ext, c_cols)   # [B, C]
            sel_thresh = lp_sel[:, -1:]                        # [B, 1]
        else:
            chars_sel = torch.where(chars < blank, chars,
                                    chars + 1)[:a - 1].expand(n_b, a - 1)
            lp_sel = torch.gather(lp_ext, 1, chars_sel)
            sel_thresh = torch.full((n_b, 1), 2 * NEG_INF, dtype=dtype,
                                    device=dev)
        if prune_logp is not None:
            lp_sel = torch.where(lp_sel < prune_logp, neg, lp_sel)

        # ---- per-beam LM rows --------------------------------------------
        lm_row = None
        if lm_table is not None:
            lm_row = lm_alpha * _lm_scores(lm_table, lm_order, last,
                                           last2) + lm_beta     # [B, K, A]
        if hlm is not None:
            nrow = lm_alpha * neural_lm.log_probs(nlm_params, hlm) + lm_beta
            lm_row = nrow if lm_row is None else lm_row + nrow

        # ---- mate detection (sort-free duplicate merge) -----------------
        ph1 = _mul32((h1 - last) & _MASK32, _H1_INV)
        ph2 = _mul32((h2 - last) & _MASK32, _H2_INV)
        has_parent = (plen > 0) & (total > NEG_INF / 2)
        match = ((ph1[:, :, None] == h1[:, None, :])
                 & (ph2[:, :, None] == h2[:, None, :])
                 & has_parent[:, :, None])                     # [B, j, k]
        mate = torch.argmax(match.to(torch.int32), dim=2)      # first match
        has_mate = match.any(dim=2)

        # ---- stay candidates (one per beam, same prefix) ----------------
        lp_last = torch.gather(lp, 1, last)                    # [B, K]
        stay_pb = total + lp[:, blank:blank + 1]
        stay_pnb = torch.where(plen > 0, pnb + lp_last, neg)
        last_m = torch.gather(last, 1, mate)
        base_mate = torch.where(last_m == last, torch.gather(pb, 1, mate),
                                torch.gather(total, 1, mate))
        ext_from_mate = base_mate + lp_last
        if lm_row is not None:
            mate_row = lm_row[bidx, mate]                      # [B, K, A]
            ext_from_mate = ext_from_mate + torch.gather(
                mate_row, 2, last[:, :, None])[:, :, 0]
        lp_ext_last = torch.gather(lp_ext, 1, last)
        gate = has_mate & (lp_ext_last >= sel_thresh)
        if prune_logp is not None:
            gate = gate & (lp_ext_last >= prune_logp)
        ext_from_mate = torch.where(gate, ext_from_mate, neg)
        stay_pnb = _lse2(stay_pnb, ext_from_mate)

        # ---- extension grid [B, K, C] -------------------------------------
        is_last = ((chars_sel[:, None, :] == last[:, :, None])
                   & (plen > 0)[:, :, None])
        base = torch.where(is_last, pb[:, :, None], total[:, :, None])
        ext_pnb = base + lp_sel[:, None, :]
        if lm_row is not None:
            ext_pnb = ext_pnb + torch.gather(
                lm_row, 2, chars_sel[:, None, :].expand(n_b, k, -1))
        ext_pnb = torch.where((plen >= max_len)[:, :, None], neg, ext_pnb)
        # excl[k, c]: some beam j has mate k and last_j == c
        last_oh = (last[:, :, None] == chars_sel[:, None, :]).to(
            torch.float32)                                     # [B, j, C]
        excl = torch.bmm(match.to(torch.float32).transpose(1, 2), last_oh)
        ext_pnb = torch.where(excl > 0, neg, ext_pnb)

        # ---- one top-K over the [A, K] grid in enumeration order ----------
        ext_full = torch.full((n_b, k, a), NEG_INF, dtype=dtype, device=dev)
        ext_full.scatter_(2, chars_sel[:, None, :].expand(n_b, k, -1),
                          ext_pnb)
        stay_merged = _lse2(stay_pb, stay_pnb)
        grid = torch.where((chars == blank)[None, :, None],
                           stay_merged[:, None, :],
                           ext_full.transpose(1, 2))           # [B, A, K]
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

        # ---- rebuild beam state --------------------------------------------
        n_buf = buf[bidx, t_parent]                            # [B, K, L]
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
        if hlm is not None:
            # the parent's state, stepped on the char where the slot extends
            h_par = hlm[bidx, t_parent]                        # [B, K, H]
            h_ext = neural_lm.gru_step(nlm_params, h_par, ext_c)
            n_hlm = torch.where(extend[:, :, None], h_ext, h_par)

        active = (t < lens)[:, None]                           # [B, 1]
        buf = torch.where(active[:, :, None], n_buf, buf)
        plen = torch.where(active, n_plen, plen)
        last = torch.where(active, n_last, last)
        last2 = torch.where(active, n_last2, last2)
        h1 = torch.where(active, n_h1, h1)
        h2 = torch.where(active, n_h2, h2)
        pb = torch.where(active, n_pb, pb)
        pnb = torch.where(active, n_pnb, pnb)
        if hlm is not None:
            hlm = torch.where(active[:, :, None], n_hlm, hlm)

    score = _lse2(pb, pnb)
    best = torch.argmax(score, dim=1)                          # first max
    rows = torch.arange(n_b, device=dev)
    out = (buf[rows, best], plen[rows, best].to(torch.int32),
           score[rows, best])
    if return_beams:
        return out + (score, plen.to(torch.int32), buf)
    return out


def make_beam_search(cfg, lm: Optional[NGramCharLM] = None,
                     nlm_params=None, device=None):
    """The search :func:`make_beam_decoder` runs, on log posteriors:
    (log_probs [B, T, A], frame_lengths [B], max_len, lm_alpha=None,
    lm_beta=None) -> (hyps [B, max_len] int32, lens [B] int32, scores [B]
    f32), alpha and beta defaulting to ``cfg.decode``'s.  With
    ``cfg.decode.use_fused_kernel`` set it is kernel B5 (K <= 128) or B6
    (K in (128, 256]) on CUDA and the plain search on the CPU.  A
    configuration that the kernels do not take (K > 256, vocab > 64, LM
    order > 3, GRU dims over E = 128 or H = 256) is decided from the
    configuration alone, before anything touches the device: on CUDA it
    raises ``NotImplementedError`` naming the limit (no plain search runs
    on the card in the kernels' place); on the CPU a warning names the
    configuration and the plain search runs, where LM order > 3 raises in
    its first frame, as in the reference.  ``nlm_params`` is moved to
    ``device`` (default ``cuda``)."""
    from tpu_ctc_torch import resolve_device
    from tpu_ctc_torch.ops import beam_cuda

    d = cfg.decode
    vocab = cfg.model.vocab_size
    lm_order = lm.order if lm is not None else 0
    use_kernel = d.use_fused_kernel and beam_cuda.supported(
        d.beam_width, vocab, lm_order, nlm_params)
    if d.use_fused_kernel and not use_kernel:
        if torch.device(device if device is not None else "cuda").type \
                == "cuda":                      # raises, naming the limit
            beam_cuda.check_supported(d.beam_width, vocab, lm_order,
                                      nlm_params)
        logging.getLogger("tpu_ctc_torch.decode").warning(
            "fused beam-search kernel does not support this configuration "
            "(K=%d vocab=%d lm_order=%d neural_lm=%s) — decoding on the "
            "plain search (prefix_beam_search) on the CPU; on a CUDA device "
            "this configuration raises NotImplementedError",
            d.beam_width, vocab, lm_order, nlm_params is not None)
    dev = resolve_device(device)
    lm_table = lm.tables(dev) if lm is not None else None
    if nlm_params is not None:
        nlm_params = nlm_params.to(dev)
    impl = beam_cuda.beam_search if use_kernel else prefix_beam_search

    def search(log_probs, frame_lengths, max_len, lm_alpha=None,
               lm_beta=None):
        return impl(
            log_probs, frame_lengths, beam_width=d.beam_width,
            max_len=max_len, lm_table=lm_table, lm_order=lm_order,
            lm_alpha=d.lm_alpha if lm_alpha is None else lm_alpha,
            lm_beta=d.lm_beta if lm_beta is None else lm_beta,
            nlm_params=nlm_params, char_topk=d.char_topk,
            prune_logp=d.prune_logp)

    return search


def make_beam_decoder(cfg, lm: Optional[NGramCharLM] = None,
                      nlm_params=None, device=None):
    """Build a (model, batch) -> (hyps, lens) decode function.

    ``batch`` holds ``feats`` [B, T, D], ``frame_mask`` [B, T],
    ``frame_lengths`` [B] and ``labels`` [B, L] (numpy arrays or tensors);
    ``nlm_params`` is a GRU char LM (``neural_lm.CharRNNLM``).  The model's
    log posteriors go through :func:`make_beam_search`'s search (kernel B5
    or B6 on CUDA, the plain search on the CPU; what the kernels do not
    take raises on CUDA and warns on the CPU, before anything touches the
    device), with ``max_len`` = min(2 L + 16, T).  The model runs on
    ``device`` (default ``cuda``).  ``decode(model, batch, log_probs=lp)``
    searches the batch's log posteriors ``lp`` [B, T, A] that the caller
    already has (a mesh's split eval gathers them) and does not run the
    model.  A call is the span ``decode.call`` (``utils.profiling``), with
    ``decode.h2d`` (the inputs to the device), ``decode.forward`` and
    ``decode.search`` inside it.
    """
    from tpu_ctc_torch import resolve_device
    from tpu_ctc_torch.models import birnn

    search = make_beam_search(cfg, lm, nlm_params, device)
    dev = resolve_device(device)

    def decode(model, batch, log_probs=None):
        with profiling.span("decode.call"):
            with profiling.span("decode.h2d"):
                feats = torch.as_tensor(batch["feats"], device=dev)
                lengths = torch.as_tensor(batch["frame_lengths"], device=dev)
                if log_probs is None:
                    mask = torch.as_tensor(batch["frame_mask"], device=dev)
            if log_probs is None:
                with profiling.span("decode.forward"), torch.no_grad():
                    log_probs = birnn.log_posteriors(model, cfg.model, feats,
                                                     mask)
            max_len = min(int(batch["labels"].shape[1]) * 2 + 16,
                          int(feats.shape[1]))
            with profiling.span("decode.search"):
                hyps, lens, _ = search(log_probs, lengths, max_len)
        return hyps, lens

    return decode
