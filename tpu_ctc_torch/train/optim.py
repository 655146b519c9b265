"""SGD with Nesterov momentum, momentum ramp and gradient clipping.

Counterpart of ``tpu_ctc.train.optim``, whose optax chain is written out
here as one plain function on the parameter tensors, in the chain's order:

  1. ``clip_by_global_norm``: g * max / |g| when |g| >= max (optax's rule,
     not ``torch.nn.utils.clip_grad_norm_``, which scales by
     max / (|g| + 1e-6) whenever it is called);
  2. ``add_decayed_weights``: g + wd * p;
  3. ``trace(nesterov=True)``: trace = g + m * trace, u = g + m * trace,
     with m the momentum ramp evaluated at the step count, as
     ``inject_hyperparams`` does;
  4. ``scale(-lr)``, or the staircase ``exponential_decay`` of lr.

The update is applied in place to the parameters and the trace (no copy of
either is kept), under ``torch.no_grad()``.  m and -lr enter as an f32
device tensor (:func:`step_scalars`), which the compiled step
(``train.graphs``) rewrites before each replay.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Sequence

import numpy as np
import torch

from tpu_ctc_torch import resolve_device
from tpu_ctc_torch.config import OptimConfig


@dataclasses.dataclass
class OptState:
    """The optimizer's state: the momentum trace per parameter name and the
    number of updates made (the step count of every schedule)."""
    trace: Dict[str, torch.Tensor]
    count: int = 0


def init_opt_state(params: Dict[str, torch.Tensor]) -> OptState:
    """A zero trace shaped like ``params`` and a count of 0."""
    return OptState({k: torch.zeros_like(p, dtype=torch.float32)
                     for k, p in params.items()})


def opt_state_from_jax(trace: Dict[str, np.ndarray], count: int,
                       device=None) -> OptState:
    """The optimizer state of a JAX optax ``make_optimizer`` state: its
    Nesterov trace as numpy arrays keyed by parameter path ('/'- or
    '.'-joined, ``pre/0/w``) and the ``inject_hyperparams`` step count.
    The trace is f32 on ``device`` (default ``cuda``), beside
    ``checkpoint.params_from_jax``'s parameters."""
    dev = resolve_device(device)
    return OptState({key.replace("/", "."): torch.tensor(
        np.asarray(val), dtype=torch.float32, device=dev)
        for key, val in trace.items()}, int(count))


def momentum_at(cfg: OptimConfig, count: int) -> float:
    """Momentum ramp: momentum_start -> momentum over momentum_ramp_steps
    (``optax.linear_schedule``), constant without a ramp."""
    if cfg.momentum_ramp_steps <= 0:
        return cfg.momentum
    frac = 1.0 - min(max(count, 0), cfg.momentum_ramp_steps) \
        / cfg.momentum_ramp_steps
    return (cfg.momentum_start - cfg.momentum) * frac + cfg.momentum


def learning_rate_at(cfg: OptimConfig, count: int) -> float:
    """Constant lr, or lr * decay^floor(count / steps) (staircase)."""
    if cfg.lr_decay != 1.0 and cfg.lr_decay_steps > 0 and cfg.lr_decay != 0:
        if count <= 0:
            return cfg.learning_rate
        return cfg.learning_rate * cfg.lr_decay ** math.floor(
            count / cfg.lr_decay_steps)
    return cfg.learning_rate


def step_scalars(cfg: OptimConfig, count: int, out: torch.Tensor = None,
                 device=None) -> torch.Tensor:
    """The update's two per-step scalars at step ``count``, [m, -lr] f32
    (:func:`momentum_at`, :func:`learning_rate_at`; each Python double
    rounded to f32 once, as an f32 tensor op rounds a Python scalar).
    Written into ``out`` (a CUDA graph's input) when given, else a new
    tensor on ``device`` (default the CPU).  On a card the values go
    through a new pinned block of the caching host allocator each call,
    which keeps a block until the copy that reads it has run, so no write
    lands in a buffer that an earlier copy may still read."""
    dev = torch.device(device or (out.device if out is not None else "cpu"))
    host = torch.tensor([momentum_at(cfg, count),
                         -learning_rate_at(cfg, count)], dtype=torch.float32,
                        pin_memory=dev.type == "cuda")
    if out is None:
        return host.to(dev, non_blocking=True) if dev.type == "cuda" \
            else host
    return out.copy_(host, non_blocking=True)


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, an f32 scalar."""
    return torch.sqrt(sum(torch.sum(t.to(torch.float32) ** 2)
                          for t in tensors))


@torch.no_grad()
def apply_updates(params: Dict[str, torch.Tensor],
                  grads: Dict[str, torch.Tensor], state: OptState,
                  cfg: OptimConfig, g_norm: torch.Tensor = None,
                  scalars: torch.Tensor = None) -> OptState:
    """One step of the chain on ``params`` in place; returns the new state
    (its trace tensors are updated in place too).  ``g_norm`` is the
    global norm of ``grads`` when the caller has it already.  ``scalars``
    is :func:`step_scalars` at ``state.count`` on the parameters' device
    (made here when not given): device tensors, so that a CUDA graph of
    the step reads each step's momentum and learning rate instead of
    baking in the first ones."""
    names = list(params)
    updates = [grads[k].to(torch.float32) for k in names]
    if cfg.grad_clip_norm > 0:
        if g_norm is None:
            g_norm = global_norm(updates)
        keep = g_norm < cfg.grad_clip_norm            # stays on the device
        updates = [torch.where(keep, u, (u / g_norm) * cfg.grad_clip_norm)
                   for u in updates]
    if cfg.weight_decay > 0:
        updates = [u + cfg.weight_decay * params[k]
                   for u, k in zip(updates, names)]
    if scalars is None:
        scalars = step_scalars(cfg, state.count,
                               device=params[names[0]].device)
    m, step = scalars[0], scalars[1]
    for k, u in zip(names, updates):
        trace = state.trace[k]
        trace.mul_(m).add_(u)                         # g + m * trace
        u = u + m * trace if cfg.nesterov else trace
        params[k].add_((step * u).to(params[k].dtype))
    return OptState(state.trace, state.count + 1)
