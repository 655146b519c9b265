"""Sequence parallelism: the time axis of the BiRNN split over 'seq'.

Counterpart of ``tpu_ctc.parallel.seq_parallel``.  Each rank of a 'seq'
line holds one time chunk of its rows; everything batched over T (the
dense layers and their projections) runs on the local chunk, while the
recurrences hand their boundary state to the neighbouring rank: the
forward direction rings left to right and the backward direction right to
left in the same rounds.  Over n wavefront rounds rank i sweeps its chunk
forward in round i and backward in round n-1-i, from the carry its
neighbour handed over (kernel B1 from h0 on a card), and the hop runs on
every rank every round.

The CTC loss also recurses over T, but its input (the logits, 29 wide) is
small: the logits are gathered over 'seq' and the loss runs on the full T
on every rank of the line, as in the JAX module.

Autograd.  ``torch.distributed`` has no differentiable send/recv, and
autograd runs a Function's backward only on ranks whose graph reaches it,
in an order that each rank's own graph sets; a hop whose collective only
some ranks reach in their backward hangs.  So a layer's whole ring is one
Function (:class:`SpRecurrence`): its forward runs the n rounds of sweeps
and carry hops, its backward the n rounds of delta sweeps (kernel B2) in
the opposite order, handing each chunk's dh0 back along the reversed ring.
Every rank holds each layer's node, so every rank runs the same hops in
the same order.  A hop is one all-reduce over the 'seq' group of an
[n, 2, B, H] f32 buffer in which each rank fills its own row (an
all-gather of both directions' carries built from the one collective that
NCCL, gloo on the CPU and gloo on CUDA tensors all take; a sum with zeros
is exact): it cannot deadlock, and a carry is B H floats (467 KB at preset
3), so the n-fold buffer is a few MB.  The gathered logits' backward is
this rank's slice of their cotangent (every rank of the line computes the
same loss), the metric sums' backward is the identity (every rank of the
'data' line computes the same loss), and ``train.step`` sums the
parameter gradients over all ranks: their sum is the gradient of the one
global loss.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.distributed as dist

from tpu_ctc_torch.config import Config, ModelConfig
from tpu_ctc_torch.models import birnn
from tpu_ctc_torch.ops import birnn_cuda
from tpu_ctc_torch.parallel.mesh import (AXIS_DATA, AXIS_SEQ, Mesh,
                                        all_reduce_sum, gather_blocks)


def ring_shift(mesh: Mesh, to_right: torch.Tensor, to_left: torch.Tensor):
    """One carry hop along this rank's 'seq' line, on every rank of it:
    returns (what the left neighbour sent right, what the right neighbour
    sent left) as f32, zeros at the line's ends."""
    n, i = mesh.axis_size(AXIS_SEQ), mesh.axis_index(AXIS_SEQ)
    buf = torch.zeros((n, 2) + tuple(to_right.shape), dtype=torch.float32,
                      device=to_right.device)
    buf[i, 0] = to_right
    buf[i, 1] = to_left
    dist.all_reduce(buf, group=mesh.group(AXIS_SEQ))
    zeros = torch.zeros_like(buf[0, 0])
    return (buf[i - 1, 0] if i > 0 else zeros,
            buf[i + 1, 1] if i < n - 1 else zeros)


class GatherSeq(torch.autograd.Function):
    """[B, T_loc, ...] chunks -> [B, T, ...] over the 'seq' line (an
    all-reduce of the zero-padded whole); the backward is this rank's
    chunk of the cotangent."""

    @staticmethod
    def forward(ctx, x, mesh):
        t = x.shape[1]
        ctx.chunk = (mesh.axis_index(AXIS_SEQ) * t, t)
        return gather_blocks(mesh, x.detach(), AXIS_SEQ, 1)

    @staticmethod
    def backward(ctx, g):
        start, t = ctx.chunk
        return g[:, start:start + t], None


class SpRecurrence(torch.autograd.Function):
    """A bidirectional layer's recurrence over the 'seq' ring: time-major
    z [T_loc, B, H] f32, wf, wb [H, H], local lengths [B] -> f + b
    [T_loc, B, H] f32 (f alone when not ``bidirectional``)."""

    @staticmethod
    def forward(ctx, z, wf, wb, lengths, mesh, clip, cdt, io, bidirectional,
                plain):
        n, i = mesh.axis_size(AXIS_SEQ), mesh.axis_index(AXIS_SEQ)
        plan = birnn_cuda.PLAIN if plain else None
        z_io = z.to(io)
        zeros = torch.zeros(z.shape[1:], dtype=io, device=z.device)
        h_in_f = h_in_b = zeros
        hs_f = hs_b = h0_f = h0_b = None
        for r in range(n):              # n wavefront rounds
            if i == r:
                h0_f = h_in_f
                hs_f, = birnn_cuda.fwd_recurrence(
                    z_io, (wf.to(cdt),), lengths, reverse=False, clip=clip,
                    h0=h0_f, plan=plan)
            if bidirectional and i == n - 1 - r:
                h0_b = h_in_b
                hs_b, = birnn_cuda.fwd_recurrence(
                    z_io, (wb.to(cdt),), lengths, reverse=True, clip=clip,
                    h0=h0_b, plan=plan)
            if r < n - 1:
                h_in_f, h_in_b = (h.to(io) for h in ring_shift(
                    mesh, hs_f[-1] if i == r else zeros,
                    hs_b[0] if bidirectional and i == n - 1 - r else zeros))
        out = hs_f.to(torch.float32)
        if bidirectional:
            out = out + hs_b.to(torch.float32)
        ctx.save_for_backward(hs_f, hs_b, h0_f, h0_b, wf, wb)
        ctx.opts = (mesh, clip, cdt, bidirectional, plain)
        return out

    @staticmethod
    def backward(ctx, g):
        hs_f, hs_b, h0_f, h0_b, wf, wb = ctx.saved_tensors
        mesh, clip, cdt, bidirectional, plain = ctx.opts
        n, i = mesh.axis_size(AXIS_SEQ), mesh.axis_index(AXIS_SEQ)
        g = g.to(torch.float32)
        zeros = torch.zeros_like(g[0])
        d_in_f = d_in_b = zeros
        dz = dwf = None                 # every rank sweeps its chunk once
        dwb = torch.zeros_like(wb, dtype=torch.float32)
        for k in range(n):      # the forward ring's chunks right to left
            send_f = send_b = zeros
            if i == n - 1 - k:  # h_last = hs_f[-1] took d_in_f
                gf = torch.cat([g[:-1], (g[-1] + d_in_f)[None]])
                dz_f, dwf, send_f = birnn_cuda.carry_sweep_grad(
                    gf, hs_f, h0_f, wf, reverse=False, clip=clip, cdt=cdt,
                    plain=plain)
                dz = dz_f if dz is None else dz + dz_f
            if bidirectional and i == k:    # h_last = hs_b[0] took d_in_b
                gb = torch.cat([(g[0] + d_in_b)[None], g[1:]])
                dz_b, dwb, send_b = birnn_cuda.carry_sweep_grad(
                    gb, hs_b, h0_b, wb, reverse=True, clip=clip, cdt=cdt,
                    plain=plain)
                dz = dz_b if dz is None else dz + dz_b
            if k < n - 1:       # dh0 goes back against each ring
                d_in_b, d_in_f = ring_shift(mesh, send_b, send_f)
        return (dz, dwf.to(wf.dtype), dwb.to(wb.dtype), None, None, None,
                None, None, None, None)


def _sp_bi_layer(x, layer, mask, cfg: ModelConfig, mesh: Mesh):
    """One bidirectional layer on a local time chunk: x [T_loc, B, D]
    time-major, mask [B, T_loc] -> [T_loc, B, H]."""
    z = birnn._dense(x, layer, cfg, activate=False)
    lengths = mask.to(torch.float32).sum(dim=1).to(torch.int32)
    return SpRecurrence.apply(
        z, layer.wf, layer.wb, lengths, mesh, float(cfg.relu_clip),
        birnn.torch_dtype(cfg.compute_dtype), birnn._io_dtype(cfg),
        bool(cfg.bidirectional), birnn.resolve_birnn_impl(cfg) == "scan")


def forward_sp(model, cfg: ModelConfig, feats, frame_mask, mesh: Mesh):
    """The acoustic model on a local time chunk: feats [B_loc, T_loc, D],
    frame_mask [B_loc, T_loc] -> local logits [B_loc, T_loc, A]."""
    x = feats.to(torch.float32).transpose(0, 1)            # [T_loc, B, D]
    for layer in model.pre:
        x = birnn._dense(x, layer, cfg)
    for layer in model.bi:
        x = _sp_bi_layer(x, layer, frame_mask, cfg, mesh)
    for layer in model.post:
        x = birnn._dense(x, layer, cfg)
    return birnn._dense(x, model.out, cfg, activate=False).transpose(0, 1)


def make_sp_loss_fn(cfg: Config, mesh: Mesh):
    """(loss_fn(model, batch), batch specs): the loss of
    ``train.step.loss_fn`` on this rank's block of the batch, feats and
    frame_mask split over 'data' and 'seq', the rest over 'data'."""
    from tpu_ctc_torch.losses import ctc

    batch_specs = {
        "feats": (AXIS_DATA, AXIS_SEQ, None),
        "frame_mask": (AXIS_DATA, AXIS_SEQ),
        "frame_lengths": (AXIS_DATA,),
        "labels": (AXIS_DATA,),
        "label_lengths": (AXIS_DATA,),
        "weights": (AXIS_DATA,),
    }
    data = mesh.group(AXIS_DATA)

    def psum(x):
        return x if data is None else all_reduce_sum(x, data)

    def sp_loss(model, batch: Dict[str, torch.Tensor]):
        logits_loc = forward_sp(model, cfg.model, batch["feats"],
                                batch["frame_mask"], mesh)
        logits = GatherSeq.apply(logits_loc, mesh)         # [B_loc, T, A]
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

    return sp_loss, batch_specs
