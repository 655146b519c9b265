"""The training step on one card: forward, CTC loss, backward, update.

Counterpart of ``tpu_ctc.train.step`` for one device: ``TrainState``,
``create_train_state``, ``loss_fn`` (the weighted-mean NLL and its
metrics), ``train_step`` (with ``grad_norm`` of the unclipped gradients)
and the body of ``make_eval_step`` (forward, greedy collapse, NLL from the
log probs).  On a card the step runs kernels B1 (forward recurrence), B3
(CTC alpha), B4 (CTC beta) and B2 (delta sweep); the metrics stay on the
device until the caller reads them.  The mesh, shard_map and sharding
functions of the JAX module are not ported (one card).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from tpu_ctc_torch import resolve_device
from tpu_ctc_torch.config import Config
from tpu_ctc_torch.decode.greedy import collapse_ids
from tpu_ctc_torch.losses import ctc
from tpu_ctc_torch.models import birnn
from tpu_ctc_torch.train import optim

BATCH_KEYS = ("feats", "frame_mask", "frame_lengths", "labels",
              "label_lengths", "weights")


@dataclasses.dataclass
class TrainState:
    step: int                       # updates made so far (host-side)
    model: birnn.BiRNN              # the parameters
    opt_state: optim.OptState


def create_train_state(cfg: Config, device=None) -> TrainState:
    """Seeded random weights (``cfg.seed``) on ``device`` (default
    ``cuda``) and a zero optimizer state."""
    model = birnn.init_params(cfg.model, seed=cfg.seed,
                              device=resolve_device(device))
    return TrainState(0, model, optim.init_opt_state(
        dict(model.named_parameters())))


def batch_to_tensors(batch: Dict[str, np.ndarray],
                     device) -> Dict[str, torch.Tensor]:
    """A batch dict of host arrays (``loop.batch_to_device_dict``) as
    tensors on ``device``."""
    return {k: torch.as_tensor(np.asarray(batch[k]), device=device)
            for k in BATCH_KEYS}


def loss_fn(model: birnn.BiRNN, cfg: Config,
            batch: Dict[str, torch.Tensor]):
    """Weighted-mean per-utterance CTC NLL plus metrics (weights are 0 on
    the repeated rows that pad a tail batch)."""
    logits = birnn.forward(model, cfg.model, batch["feats"],
                           batch["frame_mask"])
    nll = ctc.ctc_loss(logits, batch["labels"], batch["frame_lengths"],
                       batch["label_lengths"], impl=cfg.ctc_impl)
    w = batch["weights"].to(torch.float32)
    num = torch.sum(nll * w)
    utts = torch.sum(w)
    frames = torch.clamp_min(
        torch.sum(batch["frame_lengths"].to(torch.float32) * w), 1.0)
    loss = num / torch.clamp_min(utts, 1.0)
    metrics = {"loss": loss, "loss_per_frame": num / frames,
               "num_utts": utts, "num_frames": frames}
    return loss, metrics


def _check_finite(step: int, loss: torch.Tensor,
                  g_norm: torch.Tensor) -> None:
    """``train.debug_nans``: raise ``FloatingPointError`` (what
    ``jax_debug_nans`` raises) when the loss or the gradient norm is not
    finite.  One host sync a step."""
    loss_v, norm_v = float(loss), float(g_norm)
    if not (np.isfinite(loss_v) and np.isfinite(norm_v)):
        raise FloatingPointError(
            f"train.debug_nans: step {step} has loss {loss_v} and grad_norm "
            f"{norm_v}; no update was applied")


def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
               cfg: Config) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One update: value and gradient of :func:`loss_fn`, then the
    optimizer chain in place on the parameters.  With
    ``cfg.train.debug_nans`` a non-finite loss or gradient norm raises
    ``FloatingPointError`` before the update, leaving the parameters and
    the optimizer state as they were."""
    params = dict(state.model.named_parameters())
    with torch.enable_grad():
        loss, metrics = loss_fn(state.model, cfg, batch)
        grads = torch.autograd.grad(loss, list(params.values()))
    grads = dict(zip(params, grads))
    g_norm = optim.global_norm(list(grads.values()))
    if cfg.train.debug_nans:
        _check_finite(state.step, loss, g_norm)
    opt_state = optim.apply_updates(params, grads, state.opt_state,
                                    cfg.optim, g_norm=g_norm)
    metrics = {k: v.detach() for k, v in metrics.items()}
    metrics["grad_norm"] = g_norm
    return TrainState(state.step + 1, state.model, opt_state), metrics


@torch.no_grad()
def eval_step(model: birnn.BiRNN, cfg: Config,
              batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Forward, greedy best path and per-utterance NLL: {"hyp" [B, T],
    "hyp_len" [B], "nll" [B]}."""
    logits = birnn.forward(model, cfg.model, batch["feats"],
                           batch["frame_mask"])
    log_probs = torch.log_softmax(logits.to(torch.float32), dim=-1)
    ids = torch.argmax(log_probs, dim=-1).to(torch.int32)
    hyp, hyp_len = collapse_ids(ids, batch["frame_mask"])
    nll = ctc.ctc_loss(log_probs, batch["labels"], batch["frame_lengths"],
                       batch["label_lengths"], impl=cfg.ctc_impl,
                       from_log_probs=True)
    return {"hyp": hyp, "hyp_len": hyp_len, "nll": nll}
