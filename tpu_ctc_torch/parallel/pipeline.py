"""Pipeline parallelism: GPipe staging of the BiRNN stack over 'model'.

Counterpart of ``tpu_ctc.parallel.pipeline``.  With ``mesh.pipeline`` the
'model' axis carries S pipeline stages instead of tensor shards:

  * the bidirectional layers are stacked into leading-axis-[num_bi]
    parameters (``bi.w``, ``bi.b``, ``bi.wf``, ``bi.wb``: the JAX state's
    stacked tree, so its npz export loads by name) and split over 'model'
    on that axis: stage s holds layers [s L/S, (s + 1) L/S);
  * the dense layers are replicated; every stage computes the pre-layers,
    stage 0 alone feeds them to the pipeline, and the last stage alone
    runs the post-layers and the output projection;
  * the schedule: the rank's batch splits into M microbatches, and over
    S + M - 1 ticks stage s runs microbatch tick - s and hands its output
    to stage s + 1;
  * the last stage's logits are shared with every stage (the JAX psum over
    'model'), and the CTC loss (kernels B3/B4 on a card) runs on every
    stage; its sums are summed over 'data'.

Autograd.  The schedule is one ``torch.autograd.Function`` a step
(:class:`PipelineSchedule`): its forward runs the ticks, keeping each
microbatch's graph of the stage's layers (kernels B1 on a card), and its
backward runs the ticks in reverse on every stage: the last stage starts
from the logits' cotangent, each stage differentiates its microbatch's
graph (``torch.autograd.grad``: kernels B2 on a card) and hands the
input's cotangent to stage s - 1.  Every rank runs every tick's exchange,
in the same order, forward and backward, so no rank waits on a collective
another never reaches (``parallel.seq_parallel`` explains the hang that
this avoids).  Only the last stage's cotangent enters the pipeline, so the
loss counts once; ``train.step`` then sums the stacked layers' gradients
over 'data' and the replicated layers' over every rank (pre-layers are
nonzero on stage 0 only, the head on the last stage only).

An exchange is a send to the next stage and a receive from the previous
one (the reverse in the backward), ``mesh.shift``: NCCL's
``batch_isend_irecv`` between cards, an all-reduce of a buffer with a row
a stage on gloo.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from tpu_ctc_torch.config import Config, ModelConfig
from tpu_ctc_torch.models import birnn
from tpu_ctc_torch.parallel.mesh import (AXIS_DATA, AXIS_MODEL, Mesh,
                                        all_reduce_sum, shift)

BI_KEYS = ("w", "b", "wf", "wb")


class _Layer:
    """A bidirectional layer's tensors, as ``birnn._dense`` and
    ``birnn.bi_recur_tm`` read a ``BiLayer``'s."""

    def __init__(self, w, b, wf, wb):
        self.w, self.b, self.wf, self.wb = w, b, wf, wb


class StackedBi(nn.Module):
    """The bidirectional layers stacked on a leading axis: w [L, D, H],
    b [L, H], wf and wb [L, H, H]; iterating it gives each layer."""

    def __init__(self, layers):
        super().__init__()
        for k in BI_KEYS:
            setattr(self, k, nn.Parameter(torch.stack(
                [getattr(layer, k).detach() for layer in layers])))

    def __len__(self):
        return self.w.shape[0]

    def __iter__(self):
        return iter([_Layer(*(getattr(self, k)[i] for k in BI_KEYS))
                     for i in range(len(self))])


def stack_model(model: birnn.BiRNN) -> birnn.BiRNN:
    """Replace ``model.bi`` by its :class:`StackedBi` (in place)."""
    if not len(model.bi):
        raise ValueError("pipeline requires at least one bi layer")
    model.bi = StackedBi(list(model.bi))
    return model


def stack_bi_params(params: Dict[str, object]) -> Dict[str, object]:
    """A flat parameter dict ('.' or '/' joined names: a state dict, an
    npz) with the per-layer ``bi.l.k`` entries stacked into ``bi.k``
    (numpy arrays or tensors)."""
    sep = "/" if any("/" in k for k in params) else "."
    layers = sorted({int(k.split(sep)[1]) for k in params
                     if k.startswith("bi" + sep)})
    if not layers:
        raise ValueError("pipeline requires at least one bi layer")
    out = {k: v for k, v in params.items() if not k.startswith("bi" + sep)}
    for k in BI_KEYS:
        parts = [params[sep.join(("bi", str(i), k))] for i in layers]
        out[sep.join(("bi", k))] = (torch.stack(parts) if torch.is_tensor(
            parts[0]) else np.stack(parts))
    return out


def unstack_bi_params(params: Dict[str, object],
                      num_bi: int) -> Dict[str, object]:
    """The inverse of :func:`stack_bi_params`."""
    sep = "/" if any("/" in k for k in params) else "."
    out = {k: v for k, v in params.items() if not k.startswith("bi" + sep)}
    for k in BI_KEYS:
        stacked = params[sep.join(("bi", k))]
        for i in range(num_bi):
            out[sep.join(("bi", str(i), k))] = stacked[i]
    return out


def pp_param_specs(cfg: ModelConfig) -> Dict[str, tuple]:
    """Specs of the stacked model (``jax PartitionSpec`` tuples): the
    stacked layers split over 'model' on the layer axis, everything else
    replicated."""
    specs = {f"{part}.{i}.{k}": () for part, n in (
        ("pre", cfg.num_pre_layers), ("post", cfg.num_post_layers))
        for i in range(n) for k in ("w", "b")}
    specs.update({f"bi.{k}": (AXIS_MODEL,) for k in BI_KEYS})
    specs.update({"out.w": (), "out.b": ()})
    return specs


# ---- the schedule ------------------------------------------------------------

def _span(x, layers: List[_Layer], mask, cfg: ModelConfig):
    """This stage's bidirectional layers on time-major x [T, b, D]."""
    for layer in layers:
        z = birnn._dense(x, layer, cfg, activate=False)
        x = birnn.bi_recur_tm(z, layer.wf, layer.wb, mask, cfg)
    return x


def _head(x, post, out, cfg: ModelConfig):
    for layer in post:
        x = birnn._dense(x, layer, cfg)
    return birnn._dense(x, out, cfg, activate=False)


class PipelineSchedule(torch.autograd.Function):
    """The GPipe schedule of one step on this stage: x0 [T, B, H] the
    pre-layers' output (used on stage 0), mask [B, T], then this stage's
    stacked layer tensors (w, b, wf, wb) and the head's (each post layer's
    w, b, then out's) -> the rank's logits [B, T, V] on every stage."""

    @staticmethod
    def forward(ctx, x0, mask, run, *params):
        mesh, cfg, n_micro = run
        s_n, s = mesh.axis_size(AXIS_MODEL), mesh.axis_index(AXIS_MODEL)
        span_p, head_p = params[:4], params[4:]
        post = [_Layer(head_p[2 * j], head_p[2 * j + 1], None, None)
                for j in range(len(head_p) // 2 - 1)]
        out_l = _Layer(head_p[-2], head_p[-1], None, None)
        n_t, n_b, n_h = x0.shape
        bm = n_b // n_micro
        recv = x0.new_zeros((n_t, bm, n_h))
        logits = x0.new_zeros((n_t, n_b, cfg.model.vocab_size))
        track = ctx is not None         # None: the eval's forward alone
        graphs = {}
        for tick in range(s_n + n_micro - 1):
            mb = tick - s
            send = torch.zeros_like(recv)
            if 0 <= mb < n_micro:
                rows = slice(mb * bm, (mb + 1) * bm)
                inp = (x0[:, rows] if s == 0 else recv).detach()
                with torch.set_grad_enabled(track):
                    inp.requires_grad_(track)
                    # the layers indexed where the graph is recorded
                    layers = [_Layer(*(p[j] for p in span_p))
                              for j in range(span_p[0].shape[0])]
                    y = _span(inp, layers, mask[rows], cfg.model)
                    if s == s_n - 1:
                        y = _head(y, post, out_l, cfg.model)
                        logits[:, rows] = y.detach()
                if track:
                    graphs[mb] = (inp, y)
                if s < s_n - 1:
                    send = y.detach()
            if s_n > 1:
                recv = shift(send, mesh, AXIS_MODEL, forward=True)
        # the last stage's logits, shared over 'model' (zeros elsewhere)
        if s_n > 1:
            dist.all_reduce(logits, group=mesh.group(AXIS_MODEL))
        if track:
            ctx.run, ctx.graphs, ctx.params = run, graphs, params
            ctx.x0_shape = x0.shape
        return logits.transpose(0, 1).contiguous()

    @staticmethod
    def backward(ctx, g):
        mesh, cfg, n_micro = ctx.run
        s_n, s = mesh.axis_size(AXIS_MODEL), mesh.axis_index(AXIS_MODEL)
        params = ctx.params
        span_p = params[:4]
        head_p = params[4:] if s == s_n - 1 else ()
        g = g.transpose(0, 1)                       # [T, B, V]
        n_t, n_b, n_h = ctx.x0_shape
        bm = n_b // n_micro
        grads = [torch.zeros_like(p) for p in params]
        g_x0 = g.new_zeros(ctx.x0_shape)
        recv = g.new_zeros((n_t, bm, n_h))
        for tick in reversed(range(s_n + n_micro - 1)):
            mb = tick - s
            send = torch.zeros_like(recv)
            if 0 <= mb < n_micro:
                rows = slice(mb * bm, (mb + 1) * bm)
                inp, y = ctx.graphs.pop(mb)
                g_y = g[:, rows] if s == s_n - 1 else recv
                got = torch.autograd.grad(y, [inp, *span_p, *head_p], g_y)
                for j, gp in enumerate(got[1:]):
                    grads[j] = grads[j] + gp
                if s == 0:
                    g_x0[:, rows] = got[0]
                else:
                    send = got[0]
            if s_n > 1:
                recv = shift(send, mesh, AXIS_MODEL, forward=False)
        return (g_x0, None, None, *grads)


def _stage_params(model):
    head = [t for layer in model.post for t in (layer.w, layer.b)]
    return ([getattr(model.bi, k) for k in BI_KEYS]
            + head + [model.out.w, model.out.b])


def _pre(model, cfg: ModelConfig, feats):
    x = feats.to(torch.float32).transpose(0, 1)            # [T, B, D]
    for layer in model.pre:
        x = birnn._dense(x, layer, cfg)
    return x


def _check_micro(n_b: int, n_micro: int) -> None:
    if n_b % n_micro:
        raise ValueError(f"local batch {n_b} not divisible by "
                         f"{n_micro} microbatches")


def pp_logits(model, cfg: Config, feats, frame_mask, mesh: Mesh):
    """The rank's logits [B, T, V] through the pipeline, on every stage,
    without gradients (the eval under PP)."""
    n_micro = cfg.mesh.pipeline_microbatches
    _check_micro(feats.shape[0], n_micro)
    with torch.no_grad():
        x0 = _pre(model, cfg.model, feats)
        return PipelineSchedule.forward(None, x0, frame_mask,
                                        (mesh, cfg, n_micro),
                                        *_stage_params(model))


def make_pp_loss_fn(cfg: Config, mesh: Mesh):
    """(loss_fn(model, batch), batch specs, param specs) of the pipeline
    on this rank's block of the batch (rows over 'data') and this stage's
    layers."""
    from tpu_ctc_torch.losses import ctc

    s = mesh.shape[AXIS_MODEL]
    n_micro = cfg.mesh.pipeline_microbatches
    mcfg = cfg.model
    if mcfg.num_bi_layers % s:
        raise ValueError(f"num_bi_layers {mcfg.num_bi_layers} not divisible "
                         f"by {s} pipeline stages")
    batch_specs = {k: (AXIS_DATA,) for k in (
        "feats", "frame_mask", "frame_lengths", "labels", "label_lengths",
        "weights")}
    data = mesh.group(AXIS_DATA)

    def psum(x):
        return x if data is None else all_reduce_sum(x, data)

    def pp_loss(model, batch):
        _check_micro(batch["feats"].shape[0], n_micro)
        x0 = _pre(model, mcfg, batch["feats"])
        logits = PipelineSchedule.apply(x0, batch["frame_mask"],
                                        (mesh, cfg, n_micro),
                                        *_stage_params(model))
        nll = ctc.ctc_loss(logits, batch["labels"], batch["frame_lengths"],
                           batch["label_lengths"], impl=cfg.ctc_impl)
        w = batch["weights"].to(torch.float32)
        s_nll = psum(torch.sum(nll * w))
        s_w = psum(torch.sum(w))
        s_frames = psum(torch.sum(batch["frame_lengths"].to(torch.float32)
                                  * w))
        frames = torch.clamp_min(s_frames, 1.0)
        loss = s_nll / torch.clamp_min(s_w, 1.0)
        metrics = {"loss": loss, "loss_per_frame": s_nll / frames,
                   "num_utts": s_w, "num_frames": frames}
        return loss, metrics

    return pp_loss, batch_specs, pp_param_specs(mcfg)
