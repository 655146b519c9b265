"""The model's weights, made by the benchmark from the seed on the device.

Both sides get the same tensors: the port copies them into its
parameters, and the reference takes them as they are.  The names and
layouts are the port's (``pre.0.w`` is [fan_in, fan_out]), which are the
JAX package's.  One ``torch.randn`` call on a generator on the card
draws every matrix; biases are zero.  A matrix's standard deviation is the
configuration file's ``weights.std`` where it gives one (the preset's
``init_scale``), else ``weights.gain[kind] / sqrt(fan_in)`` for the
kinds ``dense``, ``recurrent`` and ``out``; ``weights.blank_bias``, where
given, is the output bias of the blank (class 0), so that most frames'
posteriors put the blank first, as a trained CTC model's do.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

SEED_STREAMS = {"pool": 0, "weights": 1, "sample": 2}


def stream_seed(seed: int, stream: str) -> int:
    """The seed of one of a run's random streams."""
    return (int(seed) * 1_000_003 + SEED_STREAMS[stream]) % (1 << 63)


def layout(model: dict) -> List[Tuple[str, tuple, str]]:
    """(name, shape, kind) of every parameter of the port's BiRNN, in its
    ``named_parameters`` order; kind is dense, recurrent, out or bias."""
    h, d = model["hidden_dim"], model["input_dim"]
    out = []
    for i in range(model["num_pre_layers"]):
        out += [(f"pre.{i}.w", (d, h), "dense"), (f"pre.{i}.b", (h,), "bias")]
        d = h
    for i in range(model["num_bi_layers"]):
        out += [(f"bi.{i}.w", (d, h), "dense"), (f"bi.{i}.b", (h,), "bias"),
                (f"bi.{i}.wf", (h, h), "recurrent"),
                (f"bi.{i}.wb", (h, h), "recurrent")]
        d = h
    for i in range(model["num_post_layers"]):
        out += [(f"post.{i}.w", (d, h), "dense"),
                (f"post.{i}.b", (h,), "bias")]
        d = h
    out += [("out.w", (d, model["vocab_size"]), "out"),
            ("out.b", (model["vocab_size"],), "bias")]
    return out


def make_weights(model: dict, spec: dict, seed: int,
                 device) -> Dict[str, torch.Tensor]:
    """{name: float32 tensor on ``device``} from ``seed``."""
    params = layout(model)
    mats = [(n, s, k) for n, s, k in params if k != "bias"]
    total = sum(math.prod(s) for _, s, _ in mats)
    gen = torch.Generator(device=device).manual_seed(
        stream_seed(seed, "weights"))
    flat = torch.randn(total, generator=gen, device=device,
                       dtype=torch.float32)
    out, start = {}, 0
    for name, shape, kind in params:
        if kind == "bias":
            out[name] = torch.zeros(shape, device=device, dtype=torch.float32)
            continue
        n = math.prod(shape)
        std = spec["std"] if "std" in spec else \
            spec["gain"][kind] / math.sqrt(shape[0])
        out[name] = flat[start:start + n].view(shape).mul_(std)
        start += n
    if "blank_bias" in spec:
        out["out.b"][0] = spec["blank_bias"]
    return out
