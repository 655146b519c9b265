"""CTC forward-backward DP: CUDA kernels B3 (alpha) and B4 (beta), their
plain versions, and the loss built on them.

Counterpart of ``tpu_ctc.ops.ctc_pallas``.  The kernels do only the
sequential sweeps over T on the emission lattice emit [B, T, S] f32:

  alpha[t, s] = lse(alpha[t-1, s], alpha[t-1, s-1], skip[s] ? alpha[t-1, s-2])
                + emit[t, s]       (init + emit at t = 0, frozen for t >= len)
  beta[t, s]  = final[s] at t = len-1;  NEG_INF for t >= len;  else
                lse(be[t+1, s], be[t+1, s+1], skip2[s] ? be[t+1, s+2]),
                with be = beta + emit

Everything parallel around them is plain PyTorch, as the JAX package leaves
it to XLA: the emission gather emit[b,t,s] = lp[b,t,ext[b,s]] with the
dead-state mask folded in (:class:`EmitGather`: its gradient sums each
character's lattice columns in a fixed order, not with ``torch.gather``'s
atomic scatter-add, so a training step is bit-reproducible), the
``skip``/``skip2``/``init``/``final`` masks, the final log-sum-exp, and
gamma = exp(alpha + beta + nll) in the backward.  The TPU's lane packing
(``_pack_plan``) is a layout trick for its 128 lanes and is not ported.

:func:`alpha` and :func:`beta` launch the kernels (``csrc/ctc_dp.cu``) for
CUDA tensors and run :func:`alpha_plain` / :func:`beta_plain` for CPU
tensors; for a CUDA tensor they never fall back.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from tpu_ctc_torch.losses.ctc_ref import (INFEASIBLE, NEG_INF, _LOG_FLOOR,
                                          _logaddexp3, extend_labels)
from tpu_ctc_torch.ops._build import CudaKernel, check, ptr, stream_of
from tpu_ctc_torch.ops.birnn_cuda import matmul_f32

ALPHA = CudaKernel("ctc_alpha", source="ctc_dp")
BETA = CudaKernel("ctc_beta", source="ctc_dp")
MAX_STATES = 1024                  # one thread per lattice state


def alpha_plain(emit: torch.Tensor, skip: torch.Tensor, init: torch.Tensor,
                lengths: torch.Tensor) -> torch.Tensor:
    """Plain per-frame alpha sweep: emit [B, T, S] f32, skip/init [B, S],
    lengths [B] -> alpha [B, T, S] f32 (alpha[:, T-1] is each row's final
    alpha: frames past a row's length leave it untouched)."""
    n_b, n_t, n_s = emit.shape
    dead = torch.full((n_b, n_s), NEG_INF, dtype=torch.float32,
                      device=emit.device)
    skip = skip > 0
    live = (torch.arange(n_t, device=emit.device)[None, :]
            < lengths.to(emit.device)[:, None])                 # [B, T]
    alpha = dead
    out = torch.empty_like(emit)
    for t in range(n_t):
        if t == 0:
            new = init + emit[:, 0]
        else:
            s1 = F.pad(alpha, (1, 0), value=NEG_INF)[:, :n_s]
            s2 = torch.where(skip, F.pad(alpha, (2, 0),
                                         value=NEG_INF)[:, :n_s], dead)
            new = _logaddexp3(alpha, s1, s2) + emit[:, t]
        alpha = torch.where(live[:, t, None], new, alpha)
        out[:, t] = alpha
    return out


def beta_plain(emit: torch.Tensor, skip2: torch.Tensor, final: torch.Tensor,
               lengths: torch.Tensor) -> torch.Tensor:
    """Plain per-frame beta sweep, right to left: beta[t] excludes frame
    t's emission; NEG_INF for t >= len."""
    n_b, n_t, n_s = emit.shape
    dead = torch.full((n_b, n_s), NEG_INF, dtype=torch.float32,
                      device=emit.device)
    skip2 = skip2 > 0
    last = lengths.to(emit.device)[:, None] - 1                  # [B, 1]
    be = dead
    out = torch.empty_like(emit)
    for t in range(n_t - 1, -1, -1):
        s1 = F.pad(be, (0, 1), value=NEG_INF)[:, 1:]
        s2 = torch.where(skip2, F.pad(be, (0, 2), value=NEG_INF)[:, 2:], dead)
        new = _logaddexp3(be, s1, s2)
        beta = torch.where(t == last, final,
                           torch.where(t < last, new, dead))
        out[:, t] = beta
        be = beta + emit[:, t]
    return out


def _check_lattice(emit, masks, lengths, what):
    if not (emit.is_cuda and lengths.is_cuda and all(m.is_cuda for m in masks)):
        raise ValueError(f"{what} kernel: tensors must be on a CUDA device")
    if emit.dim() != 3 or emit.dtype != torch.float32:
        raise ValueError(f"{what} kernel: emit must be [B, T, S] float32, "
                         f"got {tuple(emit.shape)} {emit.dtype}")
    n_b, n_t, n_s = emit.shape
    for m in masks:
        if tuple(m.shape) != (n_b, n_s):
            raise ValueError(f"{what} kernel: mask {tuple(m.shape)} does not "
                             f"fit [B, S] = {(n_b, n_s)}")
    if tuple(lengths.shape) != (n_b,):
        raise ValueError(f"{what} kernel: lengths {tuple(lengths.shape)}")
    if not 1 <= n_s <= MAX_STATES:
        raise NotImplementedError(
            f"{what} kernel: S={n_s} lattice states (1..{MAX_STATES}, one "
            f"thread per state; labels up to {(MAX_STATES - 1) // 2})")


def _launch(kernel: CudaKernel, fn_name: str, emit, mask_a, mask_b, lengths):
    _check_lattice(emit, (mask_a, mask_b), lengths, kernel.name)
    n_b, n_t, n_s = emit.shape
    emit = emit.contiguous()
    mask_a = mask_a.to(torch.float32).contiguous()
    mask_b = mask_b.to(torch.float32).contiguous()
    lengths = lengths.to(torch.int32).contiguous()
    out = torch.empty_like(emit)
    fn = getattr(kernel.lib(), fn_name)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    err = fn(ptr(emit), ptr(mask_a), ptr(mask_b), ptr(lengths), ptr(out),
             n_b, n_t, n_s,
             stream_of(kernel.name, emit, mask_a, mask_b, lengths, out))
    check(err, kernel.name)
    kernel.launches += 1
    return out


def alpha_cuda(emit, skip, init, lengths) -> torch.Tensor:
    """Launch kernel B3.  Same contract as :func:`alpha_plain`."""
    return _launch(ALPHA, "ctc_alpha_launch", emit, skip, init, lengths)


def beta_cuda(emit, skip2, final, lengths) -> torch.Tensor:
    """Launch kernel B4.  Same contract as :func:`beta_plain`."""
    return _launch(BETA, "ctc_beta_launch", emit, skip2, final, lengths)


def alpha(emit, skip, init, lengths):
    """Kernel B3 for CUDA tensors, the plain sweep for CPU tensors."""
    if emit.is_cuda:
        return alpha_cuda(emit, skip, init, lengths)
    return alpha_plain(emit, skip, init, lengths)


def beta(emit, skip2, final, lengths):
    """Kernel B4 for CUDA tensors, the plain sweep for CPU tensors."""
    if emit.is_cuda:
        return beta_cuda(emit, skip2, final, lengths)
    return beta_plain(emit, skip2, final, lengths)


class CtcDp(torch.autograd.Function):
    """NLL [B] of the emission lattice, with the gradient of
    ``_make_ctc_dp`` (``ctc_pallas.py:246-293``): forward B3 and the final
    log-sum-exp; backward B4, then d nll / d emit = -gamma, masked to live
    frames and feasible rows."""

    @staticmethod
    def forward(ctx, emit, skip, skip2, init, final, lengths):
        a = alpha(emit, skip, init, lengths)
        # Frozen final alpha + additive final-state mask -> log P.
        a_last = a[:, -1, :] + final
        m = a_last.max(dim=1).values
        m_safe = torch.clamp_min(m, NEG_INF / 2)
        logp = m_safe + torch.log(
            torch.exp(a_last - m_safe[:, None]).sum(dim=1) + _LOG_FLOOR)
        logp = torch.where(m > NEG_INF / 2, logp,
                           torch.full_like(logp, NEG_INF))
        nll = torch.clamp_max(-logp, INFEASIBLE)
        ctx.save_for_backward(emit, skip2, final, lengths, a, nll)
        return nll

    @staticmethod
    def backward(ctx, g):
        emit, skip2, final, lengths, a, nll = ctx.saved_tensors
        b = beta(emit, skip2, final, lengths)
        # gamma[b,t,s] = exp(alpha + beta - logP); d nll / d emit = -gamma.
        log_gamma = a + b + nll[:, None, None]
        gamma = torch.where(log_gamma > NEG_INF / 2, torch.exp(log_gamma),
                            torch.zeros_like(log_gamma))
        active = (torch.arange(emit.shape[1], device=emit.device)[None, :, None]
                  < lengths.to(emit.device)[:, None, None])
        gamma = gamma * active
        # Infeasible utterances (clamped nll) carry no gradient.
        feasible = (nll < INFEASIBLE)[:, None, None]
        demit = torch.where(feasible, -gamma * g[:, None, None],
                            torch.zeros_like(gamma))
        return demit, None, None, None, None, None


class EmitGather(torch.autograd.Function):
    """emit[b, t, s] = lp[b, t, ext[b, s]]: ``torch.gather``'s forward,
    and a backward of fixed order.  ``gather``'s backward scatter-adds with
    atomics on a card, so two runs of one step differ in the last bits
    (the blank's gradient sums several lattice columns).  Here the
    gradient is one product g [B, T, S] x onehot(ext) [B, S, A] in full
    f32 (TF32 off): each character's gradient sums its columns' values
    (the products by 0 and 1 are exact) in the GEMM's fixed order, equal
    to the scatter-add's up to the order of the f32 sums."""

    @staticmethod
    def forward(ctx, lp, ext):
        n_b, n_t, n_a = lp.shape
        ctx.save_for_backward(ext)
        ctx.n_a = n_a
        return torch.gather(lp, 2, ext[:, None, :].expand(n_b, n_t,
                                                           ext.shape[1]))

    @staticmethod
    def backward(ctx, g):
        ext, = ctx.saved_tensors
        onehot = F.one_hot(ext, ctx.n_a).to(g.dtype)           # [B, S, A]
        return matmul_f32(g.contiguous(), onehot), None


def lattice(log_probs: torch.Tensor, labels: torch.Tensor,
            logit_lengths: torch.Tensor, label_lengths: torch.Tensor,
            blank: int = 0):
    """The DP's inputs from log probs [B, T, A]: (emit [B, T, S], skip,
    skip2, init, final [B, S] f32, lengths [B] int32).

    S = 2 L + 1 for the L label columns given: nothing is read from the
    device, so a step can be captured in a CUDA graph and its lattice has
    one width per batch shape.  The host cuts the columns past the batch's
    longest label before the step (``data.bucketing.cut_labels``, to a
    multiple of 32); the states of the columns past a row's label are dead,
    so they leave the loss as it was (the gradient's one-hot product sums
    over S, so its f32 order may move with the width)."""
    n_b, n_t, _ = log_probs.shape
    dev = log_probs.device
    lab_len = label_lengths.to(device=dev, dtype=torch.int64)
    labels = labels.to(device=dev, dtype=torch.int64)
    ext, allow_skip = extend_labels(labels, blank)               # [B, S]
    n_s = ext.shape[1]
    # Finitize first: -inf log probs become the NEG_INF sentinel, which
    # the log-sum-exps already treat as dead.
    finite_lp = torch.clamp_min(log_probs.to(torch.float32), NEG_INF)
    emit = EmitGather.apply(finite_lp, ext)
    s_idx = torch.arange(n_s, device=dev)[None, :]
    zero = torch.zeros((n_b, n_s), dtype=torch.float32, device=dev)
    dead = torch.full_like(zero, NEG_INF)
    valid = s_idx < (2 * lab_len[:, None] + 1)
    emit = emit + torch.where(valid, zero, dead)[:, None, :]
    skip = allow_skip.to(torch.float32)
    # beta's s -> s+2 jump permission: allow_skip evaluated at s+2.
    skip2 = F.pad(skip, (0, 2))[:, 2:]
    init = torch.where((s_idx == 0) | ((s_idx == 1) & (lab_len[:, None] > 0)),
                       zero, dead)
    last = 2 * lab_len[:, None]
    final = torch.where((s_idx == last)
                        | ((s_idx == last - 1) & (lab_len[:, None] > 0)),
                        zero, dead)
    lengths = logit_lengths.to(device=dev, dtype=torch.int32)
    return emit, skip, skip2, init, final, lengths


def ctc_loss_from_log_probs(log_probs, labels, logit_lengths, label_lengths,
                            blank: int = 0) -> torch.Tensor:
    """Per-utterance CTC NLL [B] through B3/B4 (plain sweeps on CPU
    tensors); same contract as ``ctc_ref.ctc_loss_from_log_probs``."""
    return CtcDp.apply(*lattice(log_probs, labels, logit_lengths,
                                label_lengths, blank))
