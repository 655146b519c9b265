"""The acoustic model from its equations: dense clipped-ReLU layers, the
bidirectional clipped-ReLU recurrence as a loop over frames, the output
projection and the log-softmax (Hannun et al. 2014; Maas et al.)."""
from __future__ import annotations

from typing import Callable, Dict

import torch

from ctcbench.reference.quant import exact


def no_tf32():
    """Float32 products in float32: TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def log_posteriors(params: Dict[str, torch.Tensor], model: dict,
                   feats: torch.Tensor, mask: torch.Tensor,
                   q: Callable = exact) -> torch.Tensor:
    """feats [B, T, D], mask [B, T] (1 on live frames) -> log posteriors
    [B, T, vocab], every product's operands through ``q`` (a weight once
    a call, as a lower-precision copy of it would be kept)."""
    clip = float(model["relu_clip"])
    x = feats.to(torch.float32).transpose(0, 1)              # [T, B, D]
    live = mask.to(torch.bool).transpose(0, 1)[:, :, None]    # [T, B, 1]

    def dense(x, name, act=True):
        y = q(x) @ q(params[name + ".w"]) + params[name + ".b"]
        return torch.clamp(y, 0.0, clip) if act else y

    def sweep(z, w, reverse):
        n_t = z.shape[0]
        w = q(w)
        h = torch.zeros_like(z[0])
        out = [None] * n_t
        for s in range(n_t):
            t = n_t - 1 - s if reverse else s
            a = torch.clamp(z[t] + q(h) @ w, 0.0, clip)
            h = torch.where(live[t], a, torch.zeros_like(a))
            out[t] = h
        return torch.stack(out)

    for i in range(model["num_pre_layers"]):
        x = dense(x, f"pre.{i}")
    for i in range(model["num_bi_layers"]):
        z = dense(x, f"bi.{i}", act=False)
        x = sweep(z, params[f"bi.{i}.wf"], False)
        if model.get("bidirectional", True):
            x = x + sweep(z, params[f"bi.{i}.wb"], True)
    for i in range(model["num_post_layers"]):
        x = dense(x, f"post.{i}")
    logits = dense(x, "out", act=False)
    return torch.log_softmax(logits, dim=-1).transpose(0, 1)
