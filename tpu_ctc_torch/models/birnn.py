"""Deep bidirectional clipped-ReLU RNN acoustic model.

Counterpart of ``tpu_ctc.models.birnn``: dense clipped-ReLU pre-layers, a
stack of bidirectional recurrent layers (shared input projection
z_t = W x_t + b, then f_t = act(z_t + Wf f_{t-1}) and b_t = act(z_t + Wb
b_{t+1}), summed), dense post-layers and a projection to the vocabulary.
The stack runs time-major [T, B, H]; :func:`forward` takes and returns
batch-major tensors as the JAX function does.

Parameters keep the JAX tree's names and layouts (``pre.0.w`` is
[fan_in, fan_out]), so ``train.checkpoint`` maps the JAX npz export one
to one.  Dense matmuls take ``compute_dtype`` inputs and return f32
(``ops.birnn_cuda.dot_f32``).

The model trains: parameters require gradients, the dense layers
differentiate through ``ops.birnn_cuda.DotF32`` (the cotangent is rounded
to ``compute_dtype`` where JAX rounds it, at the transpose of each
``astype(compute_dtype)``) and the recurrence through
``ops.birnn_cuda.BiRecurrence`` (kernel B2 on a card).  Inference callers
run under ``torch.no_grad()``.  With ``cfg.remat`` each layer's
bidirectional recurrence (not its dense projection, as in the reference)
runs under ``torch.utils.checkpoint``: the backward keeps the layer's
projection z instead of the recurrence's states and runs the forward
sweeps (kernel B1 on a card) again to get them, so B1 launches twice per
layer and step.  B1 is deterministic, so the loss and the gradients are
bit-equal with and without it.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional

import torch
import torch.utils.checkpoint
from torch import nn

from tpu_ctc_torch import resolve_device
from tpu_ctc_torch.config import ModelConfig
from tpu_ctc_torch.ops import birnn_cuda
from tpu_ctc_torch.parallel.mesh import AXIS_MODEL

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def clipped_relu(x: torch.Tensor, clip: float) -> torch.Tensor:
    """min(max(x, 0), clip)."""
    return torch.clamp(x, 0.0, clip)


class Dense(nn.Module):
    """Affine layer with the JAX layout: w [fan_in, fan_out], b [fan_out]."""

    def __init__(self, fan_in: int, fan_out: int, dtype, device=None):
        super().__init__()
        self.w = nn.Parameter(torch.zeros((fan_in, fan_out), dtype=dtype,
                                          device=device))
        self.b = nn.Parameter(torch.zeros((fan_out,), dtype=dtype,
                                          device=device))


class BiLayer(Dense):
    """Recurrent layer: the shared projection (w, b) plus wf, wb [H, H]."""

    def __init__(self, fan_in: int, hidden: int, dtype, device=None):
        super().__init__(fan_in, hidden, dtype, device)
        self.wf = nn.Parameter(torch.zeros((hidden, hidden), dtype=dtype,
                                           device=device))
        self.wb = nn.Parameter(torch.zeros((hidden, hidden), dtype=dtype,
                                           device=device))


class BiRNN(nn.Module):
    """Parameter container of the model (``pre``, ``bi``, ``post``,
    ``out``) on ``device`` (default ``cuda``); ``forward(feats,
    frame_mask)`` gives logits [B, T, vocab]."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        device = resolve_device(device)
        dtype = torch_dtype(cfg.param_dtype)
        h = cfg.hidden_dim
        d = cfg.input_dim
        self.pre = nn.ModuleList()
        for _ in range(cfg.num_pre_layers):
            self.pre.append(Dense(d, h, dtype, device))
            d = h
        self.bi = nn.ModuleList()
        for _ in range(cfg.num_bi_layers):
            self.bi.append(BiLayer(d, h, dtype, device))
            d = h
        self.post = nn.ModuleList()
        for _ in range(cfg.num_post_layers):
            self.post.append(Dense(d, h, dtype, device))
            d = h
        self.out = Dense(d, cfg.vocab_size, dtype, device)

    def forward(self, feats, frame_mask=None):
        return forward(self, self.cfg, feats, frame_mask)


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> BiRNN:
    """Scaled-gaussian init (``init_scale``) from a seeded CPU
    ``torch.Generator``, so the weights do not depend on ``device`` (default
    ``cuda``); biases zero.  The numbers differ from JAX's ``init_params``
    for the same seed: parity goes through the npz bridge."""
    device = resolve_device(device)
    model = BiRNN(cfg, device="cpu")
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if not name.endswith(".b"):
                p.copy_(cfg.init_scale * torch.randn(
                    p.shape, generator=gen, dtype=torch.float32))
    return model.to(device)


def _dense(x: torch.Tensor, layer: Dense, cfg: ModelConfig,
           activate: bool = True) -> torch.Tensor:
    y = birnn_cuda.dot_f32(x, layer.w, torch_dtype(cfg.compute_dtype)) \
        + layer.b.to(torch.float32)
    return clipped_relu(y, cfg.relu_clip) if activate else y


def resolve_birnn_impl(cfg: ModelConfig) -> str:
    """'scan' is the plain loop on any device; 'auto' (and the JAX
    package's 'pallas') run kernel B1 on CUDA tensors and the plain loop on
    CPU tensors."""
    if cfg.birnn_impl == "scan":
        return "scan"
    if cfg.birnn_impl in ("auto", "pallas"):
        return "kernel"
    raise ValueError(f"unknown birnn impl {cfg.birnn_impl!r}")


def _io_dtype(cfg: ModelConfig) -> torch.dtype:
    """The recurrence's io dtype: ``birnn_io_dtype``, else the compute
    dtype."""
    return (torch_dtype(cfg.birnn_io_dtype) if cfg.birnn_io_dtype
            else torch_dtype(cfg.compute_dtype))


def _recurrence_with_carry(z: torch.Tensor, w: torch.Tensor,
                           mask: torch.Tensor, reverse: bool,
                           h0: torch.Tensor, *, cfg: ModelConfig):
    """One direction swept from carry h0, batch-major as the JAX
    function: z [B, T, H] f32, mask [B, T], h0 [B, H] -> (hs [B, T, H] f32,
    h_last [B, H]), h_last the state at the chunk's boundary (the last
    frame forward, the first reversed): the carry that a sequence-parallel
    neighbour chunk resumes from.  Kernel B1 from h0 on a card, the plain
    sweep on the CPU (and for ``birnn_impl="scan"``)."""
    hs = birnn_cuda.carry_recurrence(
        z, w, h0, mask, reverse=reverse, clip=cfg.relu_clip,
        compute_dtype=torch_dtype(cfg.compute_dtype), io_dtype=_io_dtype(cfg),
        plain=resolve_birnn_impl(cfg) == "scan")
    return hs, (hs[:, 0] if reverse else hs[:, -1])


def bi_recur_tm(z: torch.Tensor, wf: torch.Tensor, wb: torch.Tensor,
                mask: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Recurrence from a projection z [T, B, H] f32 and mask [B, T]
    (trailing padding) -> f + b [T, B, H] f32."""
    lengths = mask.to(torch.float32).sum(dim=1).to(torch.int32)
    rec = functools.partial(
        birnn_cuda.bi_recurrence, clip=cfg.relu_clip,
        compute_dtype=torch_dtype(cfg.compute_dtype), io_dtype=_io_dtype(cfg),
        bidirectional=cfg.bidirectional,
        plain=resolve_birnn_impl(cfg) == "scan")
    if cfg.remat:
        # no random op to replay, so no RNG state to save (whose read a
        # CUDA graph capture refuses)
        return torch.utils.checkpoint.checkpoint(rec, z, wf, wb, lengths,
                                                 use_reentrant=False,
                                                 preserve_rng_state=False)
    return rec(z, wf, wb, lengths)


def forward(model: BiRNN, cfg: ModelConfig, feats: torch.Tensor,
            frame_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B, T, input_dim] -> logits [B, T, vocab] (time-major inside)."""
    if frame_mask is None:
        frame_mask = torch.ones(feats.shape[:2], dtype=torch.float32,
                                device=feats.device)
    x = feats.to(torch.float32).transpose(0, 1)            # [T, B, D]
    for layer in model.pre:
        x = _dense(x, layer, cfg)
    for layer in model.bi:
        z = _dense(x, layer, cfg, activate=False)
        x = bi_recur_tm(z, layer.wf, layer.wb, frame_mask, cfg)
    for layer in model.post:
        x = _dense(x, layer, cfg)
    logits = _dense(x, model.out, cfg, activate=False)
    return logits.transpose(0, 1)                          # [B, T, vocab]


def log_posteriors(model: BiRNN, cfg: ModelConfig, feats, frame_mask=None):
    """Log-softmax over the vocabulary of :func:`forward`."""
    return torch.log_softmax(forward(model, cfg, feats, frame_mask), dim=-1)


def param_partition_specs(cfg: ModelConfig) -> Dict[str, tuple]:
    """For each parameter name, the mesh axis each of its dimensions is
    split over (``AXIS_MODEL``) or None, as the JAX function's
    ``PartitionSpec`` tree (``tpu_ctc.models.birnn.param_partition_specs``):
    the layout of tensor parallelism (``parallel.tensor_parallel``), which
    keeps the activations split over H between layers.

      * ``pre.0``: column-parallel, w [D, H/n] and b [H/n];
      * the other dense layers: row-parallel, w [H/n, H] and b [H/n];
      * ``bi.l.w``: row-parallel, its partials reduce-scattered over the
        batch, so b is whole, and ``wf``/``wb`` are whole (replicated): the
        recurrence runs on a rank's rows at full H;
      * ``out.w``: row-parallel, ``out.b`` replicated.
    """
    col = {"w": (None, AXIS_MODEL), "b": (AXIS_MODEL,)}
    row = {"w": (AXIS_MODEL, None), "b": (AXIS_MODEL,)}
    specs: Dict[str, tuple] = {}
    for i in range(cfg.num_pre_layers):
        for k, v in (col if i == 0 else row).items():
            specs[f"pre.{i}.{k}"] = v
    for i in range(cfg.num_bi_layers):
        specs.update({f"bi.{i}.w": (AXIS_MODEL, None), f"bi.{i}.b": (None,),
                      f"bi.{i}.wf": (None, None), f"bi.{i}.wb": (None, None)})
    for i in range(cfg.num_post_layers):
        for k, v in row.items():
            specs[f"post.{i}.{k}"] = v
    specs.update({"out.w": (AXIS_MODEL, None), "out.b": (None,)})
    return specs


def count_params(model: BiRNN) -> int:
    return sum(p.numel() for p in model.parameters())
