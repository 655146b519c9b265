"""CTC loss dispatcher: the plain oracle or the kernel DP.

Counterpart of ``tpu_ctc.losses.ctc``.  ``impl="jnp"`` runs the oracle
(:mod:`tpu_ctc_torch.losses.ctc_ref`, autograd through a loop over T);
``"auto"`` and ``"pallas"`` run :class:`tpu_ctc_torch.ops.ctc_cuda.CtcDp`,
which launches kernels B3/B4 for CUDA tensors and their plain sweeps for
CPU tensors, so the CPU exercises the same forward and gradient glue.
"""
from __future__ import annotations

import torch

from tpu_ctc_torch.losses import ctc_ref


def ctc_loss(logits, labels, logit_lengths, label_lengths, blank: int = 0,
             impl: str = "auto", from_log_probs: bool = False):
    """Per-utterance CTC NLL [B]; see :func:`ctc_ref.ctc_loss`.  With
    ``from_log_probs`` the first argument is already log-softmaxed."""
    if impl in ("auto", "pallas"):
        from tpu_ctc_torch.ops import ctc_cuda
        log_probs = (logits if from_log_probs
                     else torch.log_softmax(logits.to(torch.float32), dim=-1))
        return ctc_cuda.ctc_loss_from_log_probs(
            log_probs, labels, logit_lengths, label_lengths, blank)
    if impl != "jnp":
        raise ValueError(f"unknown ctc impl {impl!r}")
    if from_log_probs:
        return ctc_ref.ctc_loss_from_log_probs(
            logits, labels, logit_lengths, label_lengths, blank)
    return ctc_ref.ctc_loss(logits, labels, logit_lengths, label_lengths,
                            blank)
