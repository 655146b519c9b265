"""The training step from its definition: the weighted mean of the
utterances' CTC NLL, its gradient by autograd, the global-norm clip,
weight decay, the (Nesterov) momentum trace and the learning-rate step,
as the configuration's ``optim`` section states them (optax's chain:
clip_by_global_norm, add_decayed_weights, trace, scale)."""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional

import torch

from ctcbench.reference import ctc
from ctcbench.reference.model import log_posteriors
from ctcbench.reference.quant import exact


def momentum_at(o: dict, count: int) -> float:
    if o["momentum_ramp_steps"] <= 0:
        return o["momentum"]
    frac = 1.0 - min(max(count, 0), o["momentum_ramp_steps"]) \
        / o["momentum_ramp_steps"]
    return (o["momentum_start"] - o["momentum"]) * frac + o["momentum"]


def lr_at(o: dict, count: int) -> float:
    if o["lr_decay"] not in (0.0, 1.0) and o["lr_decay_steps"] > 0:
        return o["learning_rate"] * o["lr_decay"] ** math.floor(
            count / o["lr_decay_steps"])
    return o["learning_rate"]


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.detach().double()))
            for k, v in tensors.items()}


def run_steps(params0: Dict[str, torch.Tensor], cfg_file: dict,
              batches: List[Dict[str, torch.Tensor]], q: Callable = exact,
              rows: Optional[List[torch.Tensor]] = None) -> dict:
    """Take one step per batch from ``params0`` (left as it is).  Returns
    each step's loss, the per-leaf norms of the first step's gradient as
    the optimizer takes it (clipped), and the per-leaf norms of the
    parameters' change after the last step.  ``rows`` (a 0/1 weight per
    row of each batch) keeps only those rows' terms of the loss's
    numerator: the gradient one rank would have without the sum over
    ranks."""
    model, o = cfg_file["port"]["model"], cfg_file["port"]["optim"]
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in params0.items()}
    trace = {k: torch.zeros_like(v) for k, v in params0.items()}
    losses, first = [], None
    for count, b in enumerate(batches):
        lp = log_posteriors(params, model, b["feats"], b["frame_mask"], q)
        nll = ctc.nll(lp, b["labels"], b["frame_lengths"],
                      b["label_lengths"])
        w = b["weights"].to(torch.float32)
        utts = torch.clamp_min(w.sum(), 1.0)
        loss = (nll * w).sum() / utts
        target = loss if rows is None else \
            (nll * w * rows[count]).sum() / utts
        grads = dict(zip(params, torch.autograd.grad(
            target, list(params.values()))))
        losses.append(float(loss.detach()))
        del lp, nll
        with torch.no_grad():
            g_norm = torch.sqrt(sum(torch.sum(g ** 2)
                                    for g in grads.values()))
            clip = o["grad_clip_norm"]
            if clip > 0 and float(g_norm) >= clip:
                grads = {k: g / g_norm * clip for k, g in grads.items()}
            if o["weight_decay"] > 0:
                grads = {k: g + o["weight_decay"] * params[k]
                         for k, g in grads.items()}
            if first is None:
                first = leaf_norms(grads)
            m, lr = momentum_at(o, count), lr_at(o, count)
            for k, g in grads.items():
                trace[k].mul_(m).add_(g)
                u = g + m * trace[k] if o["nesterov"] else trace[k]
                params[k].add_(-lr * u)
    with torch.no_grad():
        change = leaf_norms({k: params[k] - params0[k] for k in params})
    return {"losses": losses, "grad": first, "change": change}
