"""Log-space CTC forward loss, plain PyTorch: the always-correct oracle.

Counterpart of ``tpu_ctc.losses.ctc_ref``: a batched log-space alpha
recursion over the blank-augmented lattice (S = 2L+1 states), one Python
step per frame, with the gradient from autograd through the loop.  The
kernel path (:mod:`tpu_ctc_torch.ops.ctc_cuda`) is held against it.

Conventions as in the JAX package: blank id 0; logits [B, T, A]; labels
[B, L] zero-padded; per-utterance lengths give the valid extents.  Dead
states carry the finite sentinel ``NEG_INF`` (true ``-inf`` turns the
gradients of the log-sum-exp chains into NaN), and ``_LOG_FLOOR`` inside
each log keeps a sum of underflowed terms finite.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

# Finite "minus infinity": never wins a max, and exp(NEG_INF - x)
# underflows to 0 without the NaN gradients of true -inf.
NEG_INF = -1e30

# Floor inside log(): keeps a log-sum-exp finite (and its gradient zero,
# not NaN) when every incoming path is dead.
_LOG_FLOOR = 1e-37

# Loss of an utterance that no alignment fits (T too short).
INFEASIBLE = 1e9


def _logaddexp3(a: torch.Tensor, b: torch.Tensor,
                c: torch.Tensor) -> torch.Tensor:
    """log(e^a + e^b + e^c) with the finite sentinels."""
    m = torch.maximum(torch.maximum(a, b), c)
    m_safe = torch.clamp_min(m, NEG_INF / 2)
    out = m_safe + torch.log(torch.exp(a - m_safe) + torch.exp(b - m_safe)
                             + torch.exp(c - m_safe) + _LOG_FLOOR)
    return torch.where(m > NEG_INF / 2, out, torch.full_like(out, NEG_INF))


def extend_labels(labels: torch.Tensor,
                  blank: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """labels [B, L] -> (ext [B, 2L+1] with ext[2i] = blank and ext[2i+1] =
    labels[i], allow_skip [B, 2L+1] bool: where the alpha recursion may take
    the s-2 transition, l'[s] != blank and l'[s] != l'[s-2])."""
    b, l = labels.shape
    s = 2 * l + 1
    ext = torch.full((b, s), blank, dtype=labels.dtype, device=labels.device)
    ext[:, 1::2] = labels
    idx = torch.arange(s, device=labels.device)[None, :]
    prev2 = F.pad(ext, (2, 0), value=blank)[:, :s]
    allow_skip = (idx % 2 == 1) & (ext != prev2) & (idx >= 2)
    return ext, allow_skip


def ctc_loss(logits: torch.Tensor, labels: torch.Tensor,
             logit_lengths: torch.Tensor, label_lengths: torch.Tensor,
             blank: int = 0) -> torch.Tensor:
    """Per-utterance CTC NLL [B] f32 from logits [B, T, A]; an utterance no
    alignment fits gets the finite loss 1e9."""
    log_probs = torch.log_softmax(logits.to(torch.float32), dim=-1)
    return ctc_loss_from_log_probs(log_probs, labels, logit_lengths,
                                   label_lengths, blank)


def ctc_loss_from_log_probs(log_probs: torch.Tensor, labels: torch.Tensor,
                            logit_lengths: torch.Tensor,
                            label_lengths: torch.Tensor,
                            blank: int = 0) -> torch.Tensor:
    """CTC NLL [B] from normalised per-frame log-probabilities [B, T, A]."""
    b, t, _ = log_probs.shape
    dev = log_probs.device
    ext, allow_skip = extend_labels(labels.to(device=dev, dtype=torch.int64),
                                    blank)
    s = ext.shape[1]
    lab_len = label_lengths.to(device=dev, dtype=torch.int64)
    frames = logit_lengths.to(device=dev, dtype=torch.int64)
    s_idx = torch.arange(s, device=dev)[None, :]
    # States beyond the true 2*label_len+1 lattice are dead.
    valid = s_idx < (2 * lab_len[:, None] + 1)
    dead = torch.full((b, s), NEG_INF, dtype=torch.float32, device=dev)

    # alpha_0: state 0 (blank) and state 1 (first label) only.
    emit0 = torch.gather(log_probs[:, 0, :], 1, ext)
    init = torch.where(s_idx == 0, emit0, dead)
    init = torch.where((s_idx == 1) & (lab_len[:, None] > 0), emit0, init)
    alpha = torch.where(valid, init, dead)
    for ti in range(1, t):
        emit = torch.gather(log_probs[:, ti, :], 1, ext)
        shift1 = F.pad(alpha, (1, 0), value=NEG_INF)[:, :s]
        shift2 = F.pad(alpha, (2, 0), value=NEG_INF)[:, :s]
        shift2 = torch.where(allow_skip, shift2, dead)
        new = _logaddexp3(alpha, shift1, shift2) + emit
        new = torch.where(valid, new, dead)
        # Frames past the utterance end leave alpha untouched.
        alpha = torch.where((ti < frames)[:, None], new, alpha)

    # NLL = -log(alpha[S-1] + alpha[S-2]) at the true final states.
    last = 2 * lab_len
    a_last = torch.gather(alpha, 1, last[:, None])[:, 0]
    a_prev = torch.gather(alpha, 1, torch.clamp_min(last - 1, 0)[:, None])[:, 0]
    a_prev = torch.where(lab_len > 0, a_prev, torch.full_like(a_prev, NEG_INF))
    m = torch.maximum(a_last, a_prev)
    m_safe = torch.clamp_min(m, NEG_INF / 2)
    total = m_safe + torch.log(torch.exp(a_last - m_safe)
                               + torch.exp(a_prev - m_safe) + _LOG_FLOOR)
    total = torch.where(m > NEG_INF / 2, total, torch.full_like(total, NEG_INF))
    # Infeasible alignments give NEG_INF: clamp to a large finite loss so
    # gradients stay finite.
    return torch.clamp_max(-total, INFEASIBLE)


def ctc_alignment_posteriors(log_probs: torch.Tensor, labels: torch.Tensor,
                             logit_lengths: torch.Tensor,
                             label_lengths: torch.Tensor,
                             blank: int = 0) -> torch.Tensor:
    """Per-frame lattice occupancy [B, T, A]: d(-NLL)/d(log_probs)."""
    lp = log_probs.detach().to(torch.float32).requires_grad_(True)
    with torch.enable_grad():
        total = -torch.sum(ctc_loss_from_log_probs(
            lp, labels, logit_lengths, label_lengths, blank))
        (grad,) = torch.autograd.grad(total, lp)
    return grad


def ctc_loss_mean(logits, labels, logit_lengths, label_lengths,
                  blank: int = 0) -> torch.Tensor:
    """Batch-mean CTC loss (per utterance)."""
    return torch.mean(ctc_loss(logits, labels, logit_lengths, label_lengths,
                               blank))
