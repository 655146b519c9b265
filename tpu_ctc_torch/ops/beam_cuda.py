"""Fused CTC prefix beam search: CUDA kernels B5 and B6 and their wrapper.

Counterpart of ``tpu_ctc.ops.beam_pallas.beam_search_pallas``: an n-gram LM
of order <= 3 and/or the GRU char LM, kernel B5 for beam width K <= 128 and
kernel B6 for K in (128, 256].  Both are one template in
``csrc/beam_search.cu`` (``beam_kernel<kMaxK, kNlm>``), each with its own
launch count here.  A kernel runs the whole search, one block per
utterance, and emits packed backpointers ``parent | (char + 1) << 8`` (the
parent slot <= 255 fits the 8 bits) plus each slot's final (pb, pnb,
plen); the wrapper here prepares the inputs and takes the best slot, and
a third kernel of the same source follows that slot's backpointers on the
device (:func:`reconstruct_cuda`, launch count ``RECONSTRUCT``; its plain
version is :func:`reconstruct_plain`).

The plain version of this kernel is
:func:`tpu_ctc_torch.decode.beam.prefix_beam_search`: :func:`beam_search`
runs it for CPU tensors.  For CUDA tensors it launches the kernel or
raises; nothing falls back.

``char_topk`` admits every char whose log-prob reaches the C-th largest
(a bar computed here, compared in the kernel), as the TPU kernel does; the
plain search keeps the C lowest-indexed on an exact tie at the bar.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from tpu_ctc_torch.decode import neural_lm
from tpu_ctc_torch.decode.beam import NEG_INF, _lse2, prefix_beam_search
from tpu_ctc_torch.ops._build import CudaKernel, check, ptr, stream_of

KERNEL = CudaKernel("beam_search")                          # B5
WIDE_KERNEL = CudaKernel("beam_search_wide", source="beam_search")  # B6
RECONSTRUCT = CudaKernel("beam_reconstruct", source="beam_search")  # the walk
NARROW_BEAM = 128               # B5 takes K <= 128, B6 K in (128, 256]
MAX_BEAM = 256
MAX_VOCAB = 64
MAX_ORDER = 3
MAX_EMBED, MAX_HIDDEN = 128, 256   # GRU dims, after rounding up to 8


def _round8(n: int) -> int:
    return -(-n // 8) * 8


def kernel_for(beam_width: int) -> CudaKernel:
    return KERNEL if beam_width <= NARROW_BEAM else WIDE_KERNEL


def check_supported(beam_width: int, vocab: int, lm_order: int,
                    nlm_params=None, nlm_dims=None) -> None:
    """Raise ``NotImplementedError`` for what kernels B5 and B6 do not take:
    what ``beam_pallas.supported`` refuses.  The kernels' own gate:
    :func:`prepare` calls it before every launch.  The GRU char LM's dims
    come from ``nlm_params`` or, before it is trained, ``nlm_dims`` (E, H)."""
    if nlm_params is not None:
        nlm_dims = (nlm_params.embed.shape[1], nlm_params.bz.shape[0])
    if nlm_dims is not None:
        e, h = nlm_dims
        if _round8(e) > MAX_EMBED or _round8(h) > MAX_HIDDEN:
            raise NotImplementedError(
                f"beam_search kernel: GRU char LM with embed {e} / hidden "
                f"{h} (at most {MAX_EMBED} / {MAX_HIDDEN})")
    if not 1 <= beam_width <= MAX_BEAM:
        raise NotImplementedError(
            f"beam_search kernel: beam width {beam_width} (1..{MAX_BEAM})")
    if not 2 <= vocab <= MAX_VOCAB:
        raise NotImplementedError(
            f"beam_search kernel: vocab {vocab} (2..{MAX_VOCAB})")
    if not 0 <= lm_order <= MAX_ORDER:
        raise NotImplementedError(
            f"beam_search kernel: LM order {lm_order} (0..{MAX_ORDER})")


def supported(beam_width: int, vocab: int, lm_order: int,
              nlm_params=None) -> bool:
    """Whether kernels B5 and B6 take a configuration
    (``beam_pallas.supported``): what :func:`check_supported` lets
    through."""
    try:
        check_supported(beam_width, vocab, lm_order, nlm_params)
    except NotImplementedError:
        return False
    return True


def reconstruct_plain(bp: torch.Tensor, best: torch.Tensor, max_len: int):
    """Follow the packed backpointers of slot ``best`` from the last frame
    to the first: bp [B, T, K] int32, best [B] -> hyps [B, max_len] int32
    (``beam_pallas._reconstruct``).  The plain version of
    :func:`reconstruct_cuda`: a loop over T with a gather a frame."""
    n_b, n_t, _ = bp.shape
    slot = best.to(torch.int64)[:, None]
    chars = torch.empty((n_t, n_b), dtype=torch.int64, device=bp.device)
    for t in range(n_t - 1, -1, -1):
        entry = bp[:, t].gather(1, slot).to(torch.int64)
        chars[t] = entry[:, 0] // 256 - 1                  # -1 = stay
        slot = entry % 256
    emitted = chars >= 0
    pos = torch.cumsum(emitted.to(torch.int64), dim=0) - 1
    pos = torch.where(emitted, pos, torch.full_like(pos, max_len))
    hyps = torch.zeros((n_b, max_len + 1), dtype=torch.int32, device=bp.device)
    hyps.scatter_(1, pos.T, torch.clamp(chars, min=0).T.to(torch.int32))
    return hyps[:, :max_len]


def reconstruct_cuda(bp: torch.Tensor, best: torch.Tensor,
                     max_len: int) -> torch.Tensor:
    """Launch the backpointer walk: one thread per utterance, the same
    contract as :func:`reconstruct_plain` and its bits."""
    if not (bp.is_cuda and best.is_cuda):
        raise ValueError("beam_reconstruct kernel: tensors must be on a CUDA "
                         "device")
    if bp.dim() != 3 or bp.dtype != torch.int32:
        raise ValueError(f"beam_reconstruct kernel: bp must be [B, T, K] "
                         f"int32, got {tuple(bp.shape)} {bp.dtype}")
    n_b, n_t, k = bp.shape
    if tuple(best.shape) != (n_b,) or not 1 <= k <= MAX_BEAM:
        raise ValueError(f"beam_reconstruct kernel: best "
                         f"{tuple(best.shape)} for bp {tuple(bp.shape)}")
    bp = bp.contiguous()
    best = best.to(torch.int64).contiguous()
    chars = torch.empty((n_b, n_t), dtype=torch.int32, device=bp.device)
    hyps = torch.empty((n_b, max_len), dtype=torch.int32, device=bp.device)
    fn = RECONSTRUCT.lib().beam_reconstruct_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    err = fn(ptr(bp), ptr(best), ptr(chars), ptr(hyps), n_b, n_t, k, max_len,
             stream_of(RECONSTRUCT.name, bp, best, chars, hyps))
    check(err, RECONSTRUCT.name)
    RECONSTRUCT.launches += 1
    return hyps


def admission_bar(log_probs: torch.Tensor, char_topk: int,
                  blank: int = 0) -> torch.Tensor:
    """[B, T, A] -> [B, T]: the C-th largest non-blank log-prob of each
    frame (``beam_pallas.py:1264-1269``)."""
    chars = torch.arange(log_probs.shape[-1], device=log_probs.device)
    lp_ext = torch.where(chars == blank, torch.full_like(log_probs, NEG_INF),
                         log_probs)
    return torch.topk(lp_ext, char_topk, dim=-1).values[..., -1].contiguous()


def gru_layout(nlm, vocab: int, device) -> Tuple[torch.Tensor, ...]:
    """The GRU char LM's weights as the kernels read them, f32 and
    contiguous on ``device``, with the hidden size H padded to Hp, a
    multiple of 8 (the tensor-core tiles' depth): (xw [A, 3Hp], wh
    [Hp, 3Hp], b [3Hp], wo [Hp, A], bo [A], h_bos [Hp]).  ``xw = embed @
    (Wz|Wr|Wh)[:E]`` is every char's input projection (the TPU kernel's
    ``wx @ embed^T``, taken out of the frame loop and summed in f64),
    ``wh = (Wz|Wr|Wh)[E:]`` the recurrent rows, ``b = (bz|br|bh)`` and
    ``h_bos = neural_lm.init_state``, the BOS-stepped state every beam
    starts from (``beam_pallas.py:1345-1365``).  The padded units have zero
    weights, biases and start: their state stays 0 and adds nothing to any
    other unit or to the LM rows, so no value changes."""
    if nlm.embed.shape[0] != vocab:
        raise ValueError(f"beam_search kernel: GRU char LM vocab "
                         f"{nlm.embed.shape[0]}, posteriors {vocab}")
    e, n_h = nlm.embed.shape[1], nlm.bz.shape[0]
    hp = _round8(n_h)

    def gates(w):                       # [..., 3H] -> [..., 3Hp], zero pad
        out = w.new_zeros((*w.shape[:-1], 3, hp))
        out[..., :n_h] = w.reshape(*w.shape[:-1], 3, n_h)
        return out.reshape(*w.shape[:-1], 3 * hp)

    def rows(w):                        # [H, ...] -> [Hp, ...], zero pad
        out = w.new_zeros((hp, *w.shape[1:]))
        out[:n_h] = w
        return out

    with torch.no_grad():               # on the weights' device: no syncs
        w = torch.cat([nlm.wz, nlm.wr, nlm.wh], dim=1)          # [E+H, 3H]
        xw = nlm.embed.double() @ w[:e].double()
        out = (gates(xw), rows(gates(w[e:])),
               gates(torch.cat([nlm.bz, nlm.br, nlm.bh])), rows(nlm.wo),
               nlm.bo, rows(neural_lm.init_state(nlm)))
        return tuple(t.to(device=device, dtype=torch.float32).contiguous()
                     for t in out)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest TF32 value (10 mantissa bits, ties away from
    zero), as ``cvt.rna.tf32.f32`` rounds it; finite inputs."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_tf32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in f32 as kernels B5 and B6 take the GRU's products on the
    tensor cores: each operand split as x = hi + lo with hi = tf32(x) and
    lo = tf32(x - hi), then a_lo b_hi + a_hi b_lo + a_hi b_hi, each a
    product of TF32 values (exact in f32) summed in f32.  The dropped
    a_lo b_lo and lo's rounding are <= 2^-24 of a product.  This documents and tests the
    kernels' arithmetic; nothing on the decode path calls it."""
    a, b = a.to(torch.float32), b.to(torch.float32)
    a_hi, b_hi = tf32_round(a), tf32_round(b)
    a_lo, b_lo = tf32_round(a - a_hi), tf32_round(b - b_hi)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def launch(lp: torch.Tensor, lens: torch.Tensor, beam_width: int,
           max_len: int, blank: int = 0, lm: Optional[torch.Tensor] = None,
           lm_order: int = 0, lm_alpha: float = 1.0, lm_beta: float = 0.0,
           prune_logp: Optional[float] = None,
           thr: Optional[torch.Tensor] = None,
           gru: Optional[Tuple[torch.Tensor, ...]] = None):
    """One launch of kernel B5 (K <= 128) or B6 (K in (128, 256]) on
    prepared inputs: lp [B, T, A] f32, lens [B] int32, lm the flat [A]^order
    f32 table or None, thr [B, T] f32 or None, gru the :func:`gru_layout`
    tuple or None, all contiguous on one CUDA device -> (bp [B, T, K] int32
    packed backpointers, fin [B, 3, K] f32 final pb, pnb, plen).  With a
    GRU, the per-beam states live in a [B, 2, K, Hp] f32 ping-pong buffer
    allocated here (Hp: the padded hidden size of :func:`gru_layout`)."""
    n_b, n_t, a = lp.shape
    kern = kernel_for(beam_width)
    bp = torch.empty((n_b, n_t, beam_width), dtype=torch.int32,
                     device=lp.device)
    fin = torch.empty((n_b, 3, beam_width), dtype=torch.float32,
                      device=lp.device)
    null = ctypes.c_void_p(None)
    gru_args, n_h, state = [null] * 7, 0, None
    if gru is not None:
        n_h = gru[5].shape[0]
        state = torch.empty((n_b, 2, beam_width, n_h), dtype=torch.float32,
                            device=lp.device)
        gru_args = [ptr(x) for x in (*gru, state)]
    fn = getattr(kern.lib(), kern.name + "_launch")
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                   + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_float]
                   + [ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_void_p])
    err = fn(ptr(lp), ptr(lens), ptr(thr) if thr is not None else null,
             ptr(lm) if lm is not None else null, ptr(bp), ptr(fin),
             n_b, n_t, a, beam_width, blank, max_len,
             lm_order if lm is not None else 0, float(lm_alpha),
             float(lm_beta), int(prune_logp is not None),
             float(prune_logp if prune_logp is not None else 0.0),
             *gru_args, n_h, stream_of(kern.name, lp, lens, thr, lm, bp, fin,
                                       *(gru or ()), state))
    check(err, kern.name)
    kern.launches += 1
    return bp, fin


def prepare(log_probs: torch.Tensor, frame_lengths: torch.Tensor,
            beam_width: int, blank: int = 0,
            lm_table: Optional[torch.Tensor] = None, lm_order: int = 0,
            char_topk: int = 0, nlm_params=None):
    """Check the configuration and lay the inputs out for :func:`launch`:
    -> (lp, lens, lm or None, thr or None, gru or None)."""
    if not log_probs.is_cuda:
        raise ValueError("beam_search kernel: log_probs must be on a CUDA "
                         "device")
    n_b, n_t, a = log_probs.shape
    order = lm_order if lm_table is not None else 0
    check_supported(beam_width, a, order, nlm_params)
    dev = log_probs.device
    lp = log_probs.to(torch.float32).contiguous()
    lens = frame_lengths.to(device=dev, dtype=torch.int32).contiguous()
    thr = None
    if char_topk and char_topk < a - 1:
        thr = admission_bar(lp, char_topk, blank)
    lm = None
    if order > 0:
        lm = lm_table.to(device=dev, dtype=torch.float32).contiguous()
        if lm.numel() != a ** order:
            raise ValueError(f"beam_search kernel: LM table of "
                             f"{lm.numel()} entries for order {order} and "
                             f"vocab {a}")
    gru = gru_layout(nlm_params, a, dev) if nlm_params is not None else None
    return lp, lens, lm, thr, gru


def beam_search_cuda(log_probs: torch.Tensor, frame_lengths: torch.Tensor,
                     beam_width: int, max_len: int, blank: int = 0,
                     lm_table: Optional[torch.Tensor] = None,
                     lm_order: int = 0, lm_alpha: float = 1.0,
                     lm_beta: float = 0.0, prune_logp: Optional[float] = None,
                     char_topk: int = 0, nlm_params=None):
    """Kernel B5 or B6, then the walk kernel for the best slot's
    hypothesis; same contract as :func:`beam_search`."""
    lp, lens, lm, thr, gru = prepare(log_probs, frame_lengths, beam_width,
                                     blank, lm_table, lm_order, char_topk,
                                     nlm_params)
    bp, fin = launch(lp, lens, beam_width, max_len, blank, lm, lm_order,
                     lm_alpha, lm_beta, prune_logp, thr, gru)
    score = _lse2(fin[:, 0], fin[:, 1])                        # [B, K]
    best = torch.argmax(score, dim=1)
    rows = torch.arange(lp.shape[0], device=lp.device)
    hyps = reconstruct_cuda(bp, best, max_len)
    return hyps, fin[rows, 2, best].to(torch.int32), score[rows, best]


def beam_search(log_probs: torch.Tensor, frame_lengths: torch.Tensor,
                beam_width: int, max_len: int, blank: int = 0,
                lm_table: Optional[torch.Tensor] = None, lm_order: int = 0,
                lm_alpha: float = 1.0, lm_beta: float = 0.0,
                prune_logp: Optional[float] = None, char_topk: int = 0,
                nlm_params=None):
    """Batched prefix beam search: kernel B5 (K <= 128) or B6 (K in
    (128, 256]) for CUDA tensors, the plain search for CPU tensors.

    log_probs [B, T, A] normalized log posteriors, frame_lengths [B] ->
    (hyps [B, max_len] int32, lengths [B] int32, scores [B] f32).
    """
    if log_probs.is_cuda:
        return beam_search_cuda(
            log_probs, frame_lengths, beam_width, max_len, blank, lm_table,
            lm_order, lm_alpha, lm_beta, prune_logp, char_topk, nlm_params)
    return prefix_beam_search(
        log_probs, frame_lengths, beam_width=beam_width, max_len=max_len,
        blank=blank, lm_table=lm_table, lm_order=lm_order, lm_alpha=lm_alpha,
        lm_beta=lm_beta, nlm_params=nlm_params, char_topk=char_topk,
        prune_logp=prune_logp)
