"""Tensor parallelism over the 'model' axis that keeps the fused recurrence
whole on each rank.

Counterpart of ``tpu_ctc.parallel.tensor_parallel``.  Each rank of a
'model' line holds its shard of the sharded parameters
(``models.birnn.param_partition_specs``) and runs the loss on its block of
the batch (rows over 'data'), with explicit collectives over the line:

  layout invariant: activations between layers are split over H,
  [T, B_local, H/n] (B_local = B / n_data).

  * ``pre.0``: column-parallel [D, H/n]: the whole features in, H-split
    out, no collective;
  * the other dense layers: row-parallel [H/n, H]: the partial [T, B, H]
    products are reduce-scattered over H, back to H-split;
  * a bidirectional layer: row-parallel input projection whose partials
    are reduce-scattered over the BATCH, so each rank gets [T, B/n, H]:
    the whole hidden width for a slice of utterances, on which it runs the
    recurrence (kernels B1/B2 on a card, at the full H: preset 5's
    H = 4096 takes their wide instance) with wf/wb whole; an all-to-all
    (batch-split to H-split) restores the invariant;
  * ``out``: row-parallel, its partials reduce-scattered over the batch:
    logits [T, B/n, V], and the CTC loss (B3/B4) runs split over the rows
    of both axes.

Autograd.  A reduce-scatter's backward is an all-gather and an
all-to-all's backward is the inverse all-to-all; both are
``torch.autograd.Function`` s (:class:`ReduceScatter`, :class:`AllToAll`).
Every rank of a line runs the same layers, so every rank's backward meets
the same collectives in the same order.  The loss's sums are summed over
all ranks with an identity backward (``mesh.all_reduce_sum``), as under
DP; then ``train.step`` sums the gradients of a sharded parameter over
'data' and those of a replicated one over 'data' and 'model' (what
shard_map's transpose does in JAX), and the clip's global norm sums the
sharded squares over 'model' (each parameter counted once).

Collectives are picked from the group's backend (``dist.get_backend``):
NCCL's reduce-scatter, all-gather and all-to-all between cards; on gloo
(the CPU, or ranks sharing one card) each is built from ``all_reduce``,
the one collective that gloo takes on CPU and CUDA tensors alike (a sum
with zeros is exact), as ``parallel.seq_parallel`` builds its carry hops.

Requirements (validated, with the JAX package's words): hidden_dim %
model == 0, (batch / data) % model == 0, num_pre_layers >= 1.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.distributed as dist

from tpu_ctc_torch.config import Config, ModelConfig
from tpu_ctc_torch.models import birnn
from tpu_ctc_torch.ops import birnn_cuda
from tpu_ctc_torch.parallel.mesh import (AXIS_DATA, AXIS_MODEL, Mesh,
                                        all_reduce_sum, gather_blocks)


def validate_tp(cfg: Config, mesh: Mesh) -> None:
    n = mesh.shape.get(AXIS_MODEL, 1)
    nd = mesh.shape.get(AXIS_DATA, 1)
    if cfg.model.hidden_dim % n:
        raise ValueError(
            f"tensor parallelism requires hidden_dim % model axis == 0 "
            f"(hidden_dim={cfg.model.hidden_dim}, model={n})")
    local_b = cfg.data.batch_size // max(nd, 1)
    if cfg.data.batch_size % max(nd, 1) or local_b % n:
        raise ValueError(
            f"tensor parallelism requires (batch_size / data axis) divisible "
            f"by the model axis (batch={cfg.data.batch_size}, data={nd}, "
            f"model={n})")
    if cfg.model.num_pre_layers < 1:
        raise ValueError(
            "the shard_map TP path needs num_pre_layers >= 1 (the first "
            "dense layer is the column-parallel entry; a recurrent first "
            "layer would shard the feature dim instead)")


# ---- collectives over this rank's 'model' line ------------------------------

def _nccl(group) -> bool:
    return dist.get_backend(group) == "nccl"


def reduce_scatter(x: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    """The sum of ``x`` over the 'model' line, this rank's block of it
    along ``dim`` (blocks in axis order)."""
    n, i = mesh.axis_size(AXIS_MODEL), mesh.axis_index(AXIS_MODEL)
    group = mesh.group(AXIS_MODEL)
    if _nccl(group):
        xt = x.movedim(dim, 0).contiguous()
        out = xt.new_empty((xt.shape[0] // n,) + tuple(xt.shape[1:]))
        dist.reduce_scatter_tensor(out, xt, group=group)
        return out.movedim(0, dim)
    y = x.contiguous().clone()
    dist.all_reduce(y, group=group)
    per = x.shape[dim] // n
    return y.narrow(dim, i * per, per).contiguous()


def all_gather(x: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    """The blocks of ``x`` from every rank of the 'model' line,
    concatenated along ``dim`` in axis order."""
    group = mesh.group(AXIS_MODEL)
    if not _nccl(group):
        return gather_blocks(mesh, x, AXIS_MODEL, dim)
    xt = x.movedim(dim, 0).contiguous()
    out = xt.new_empty((mesh.axis_size(AXIS_MODEL) * xt.shape[0],)
                       + tuple(xt.shape[1:]))
    dist.all_gather_into_tensor(out, xt, group=group)
    return out.movedim(0, dim)


def all_to_all(x: torch.Tensor, split: int, concat: int,
               mesh: Mesh) -> torch.Tensor:
    """``x`` cut into n blocks along ``split``, block j sent to rank j of
    the 'model' line; the blocks received, concatenated along ``concat``
    in axis order (``jax.lax.all_to_all(tiled=True)``)."""
    n, i = mesh.axis_size(AXIS_MODEL), mesh.axis_index(AXIS_MODEL)
    group = mesh.group(AXIS_MODEL)
    blocks = torch.stack(x.chunk(n, split), 0).contiguous()   # [n, ...]
    if _nccl(group):
        got = torch.empty_like(blocks)
        dist.all_to_all_single(got, blocks, group=group)
    else:
        buf = blocks.new_zeros((n,) + tuple(blocks.shape))
        buf[i] = blocks
        dist.all_reduce(buf, group=group)
        got = buf[:, i]
    return torch.cat(list(got.unbind(0)), concat)


class ReduceScatter(torch.autograd.Function):
    """:func:`reduce_scatter`; its backward all-gathers the cotangent."""

    @staticmethod
    def forward(ctx, x, dim, mesh):
        ctx.dim, ctx.mesh = dim, mesh
        return reduce_scatter(x, dim, mesh)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g.contiguous(), ctx.dim, ctx.mesh), None, None


class AllToAll(torch.autograd.Function):
    """:func:`all_to_all`; its backward is the inverse all-to-all."""

    @staticmethod
    def forward(ctx, x, split, concat, mesh):
        ctx.dims, ctx.mesh = (split, concat), mesh
        return all_to_all(x, split, concat, mesh)

    @staticmethod
    def backward(ctx, g):
        split, concat = ctx.dims
        return all_to_all(g.contiguous(), concat, split, ctx.mesh), None, \
            None, None


# ---- the forward and the loss ----------------------------------------------

def _dense_row(x, layer, cfg: ModelConfig, mesh: Mesh, scatter_dim: int,
               activate=True):
    """Row-parallel dense: H-split x, a [H/n, H] shard.  The partial
    [T, B, H] products are reduce-scattered over 'model' along
    ``scatter_dim`` (2: back to H-split, 1: batch-split at full H); the
    bias is H-split for 2 and whole for 1, as the specs hold it."""
    partial = birnn_cuda.dot_f32(x, layer.w,
                                 birnn.torch_dtype(cfg.compute_dtype))
    y = ReduceScatter.apply(partial, scatter_dim, mesh)
    y = y + layer.b.to(torch.float32)
    return birnn.clipped_relu(y, cfg.relu_clip) if activate else y


def tp_forward(model, cfg: ModelConfig, feats, frame_mask, mesh: Mesh):
    """The model on this rank's block of the batch, feats [B, T, D] and
    frame_mask [B, T], with this rank's shards -> (logits [B/n, T, V] of
    the rows [start, start + rows) of the block, start, rows)."""
    n = mesh.axis_size(AXIS_MODEL)
    mi = mesh.axis_index(AXIS_MODEL)
    rows = feats.shape[0] // n
    x = feats.to(torch.float32).transpose(0, 1)            # [T, B, D]
    for i, layer in enumerate(model.pre):   # pre.0 column-parallel: local
        x = (birnn._dense(x, layer, cfg) if i == 0
             else _dense_row(x, layer, cfg, mesh, 2))
    mask_rows = frame_mask[mi * rows:(mi + 1) * rows]
    for layer in model.bi:
        # z's partials reduce-scatter over the batch: [T, B/n, H]
        z = _dense_row(x, layer, cfg, mesh, 1, activate=False)
        hs = birnn.bi_recur_tm(z, layer.wf, layer.wb, mask_rows, cfg)
        # batch-split -> H-split: [T, B/n, H] -> [T, B, H/n]
        x = AllToAll.apply(hs, 2, 1, mesh)
    for layer in model.post:
        x = _dense_row(x, layer, cfg, mesh, 2)
    logits = _dense_row(x, model.out, cfg, mesh, 1, activate=False)
    return logits.transpose(0, 1), mi * rows, rows


def make_tp_loss_fn(cfg: Config, mesh: Mesh):
    """loss_fn(model, batch) -> (loss, metrics) on this rank's block of the
    batch (rows over 'data') and its shards of the parameters."""
    from tpu_ctc_torch.losses import ctc

    validate_tp(cfg, mesh)

    def tp_loss(model, batch: Dict[str, torch.Tensor]):
        logits, start, rows = tp_forward(model, cfg.model, batch["feats"],
                                         batch["frame_mask"], mesh)
        mine = slice(start, start + rows)
        fl = batch["frame_lengths"][mine]
        nll = ctc.ctc_loss(logits, batch["labels"][mine], fl,
                           batch["label_lengths"][mine], impl=cfg.ctc_impl)
        w = batch["weights"][mine].to(torch.float32)

        def reduce(x):              # over 'data' and 'model': every rank
            return all_reduce_sum(x, None)

        num = reduce(torch.sum(nll * w))
        utts = reduce(torch.sum(w))
        frames = torch.clamp_min(reduce(torch.sum(fl.to(torch.float32) * w)),
                                 1.0)
        loss = num / torch.clamp_min(utts, 1.0)
        metrics = {"loss": loss, "loss_per_frame": num / frames,
                   "num_utts": utts, "num_frames": frames}
        return loss, metrics

    return tp_loss
