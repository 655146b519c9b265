"""The training step: forward, CTC loss, backward, update, on one card or
on a mesh of ranks.

Counterpart of ``tpu_ctc.train.step``: ``TrainState``,
``create_train_state``, ``loss_fn`` (the weighted-mean NLL and its
metrics), ``train_step`` (with ``grad_norm`` of the unclipped gradients)
and the eval step (forward, greedy collapse, NLL from the log probs).  On
a card the step runs kernels B1 (forward recurrence), B3 (CTC alpha), B4
(CTC beta) and B2 (delta sweep); the metrics stay on the device until the
caller reads them.

The mesh half (``make_train_step``, ``make_eval_step`` and the sharding
functions) runs the step on a ``parallel.mesh.Mesh`` of ranks: data
parallelism (DP) splits the batch's rows over 'data' and sums the loss's
sums over it; sequence parallelism (SP, ``parallel.seq_parallel``) also
splits the frames over 'seq'; tensor parallelism (TP,
``parallel.tensor_parallel``) splits the parameters over 'model' as
``birnn.param_partition_specs`` says, and pipeline parallelism (PP,
``parallel.pipeline``, ``mesh.pipeline``) the stacked bidirectional layers
over 'model' as stages.  Each rank takes its block of the global batch
(:func:`batch_shardings`, :func:`local_batch`).  The state is broadcast
from rank 0 and each rank keeps its shard of a parameter split over
'model' and of its trace (:func:`state_shardings`); the rest is
replicated.  Before ``grad_norm`` and the clip the gradients are summed:
a replicated parameter's over all ranks, a split one's over 'data' only,
and the global norm counts each parameter once (a split one's squares
summed over 'model'), so the clip sees the global gradient as in JAX and
every rank applies the same update to what it holds.  On a card the step
of a one-rank mesh and of every mesh of NCCL ranks is captured once per
batch shape in a CUDA graph (``train.graphs``), collectives included, as
the JAX package jits its step on every mesh; :func:`eager_reason` names
what stays eager.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from tpu_ctc_torch import resolve_device
from tpu_ctc_torch.config import Config
from tpu_ctc_torch.data.bucketing import cut_labels
from tpu_ctc_torch.decode.greedy import collapse_ids
from tpu_ctc_torch.losses import ctc
from tpu_ctc_torch.models import birnn
from tpu_ctc_torch.parallel import mesh as mesh_lib
from tpu_ctc_torch.parallel.mesh import AXIS_DATA, AXIS_MODEL, AXIS_SEQ
from tpu_ctc_torch.train import optim

BATCH_KEYS = ("feats", "frame_mask", "frame_lengths", "labels",
              "label_lengths", "weights")


@dataclasses.dataclass
class TrainState:
    step: int                       # updates made so far (host-side)
    model: birnn.BiRNN              # the parameters
    opt_state: optim.OptState
    # On a mesh that splits parameters over 'model' (TP, PP): each
    # parameter's spec (:func:`state_shardings`) and the mesh; the model
    # and the trace then hold this rank's shards.
    specs: Optional[Dict[str, tuple]] = None
    mesh: Optional[mesh_lib.Mesh] = None


def create_train_state(cfg: Config, device=None) -> TrainState:
    """Seeded random weights (``cfg.seed``) on ``device`` (default
    ``cuda``) and a zero optimizer state; with ``mesh.pipeline`` the
    bidirectional layers are stacked (``pipeline.stack_model``), as the
    JAX function stacks them."""
    model = birnn.init_params(cfg.model, seed=cfg.seed,
                              device=resolve_device(device))
    if cfg.mesh.pipeline:
        from tpu_ctc_torch.parallel.pipeline import stack_model
        stack_model(model)
    return TrainState(0, model, optim.init_opt_state(
        dict(model.named_parameters())))


def batch_to_tensors(batch: Dict[str, np.ndarray], device,
                     mesh: Optional[mesh_lib.Mesh] = None
                     ) -> Dict[str, torch.Tensor]:
    """A batch dict of host arrays (``loop.batch_to_device_dict``) as
    tensors on ``device``, its labels cut on the host to the batch's
    longest label rounded up to a multiple of 32
    (``data.bucketing.cut_labels``); with ``mesh``, this rank's block of
    the global batch (:func:`local_batch`), cut first, so every rank of
    the mesh gets the global batch's label width (one graph key on every
    rank, ``train.graphs.shape_key``)."""
    batch = cut_labels({k: np.asarray(batch[k]) for k in BATCH_KEYS})
    if mesh is not None:
        batch = local_batch(batch, mesh)
    return {k: torch.as_tensor(batch[k], device=device) for k in BATCH_KEYS}


def loss_fn(model: birnn.BiRNN, cfg: Config,
            batch: Dict[str, torch.Tensor], reduce=lambda x: x):
    """Weighted-mean per-utterance CTC NLL plus metrics (weights are 0 on
    the repeated rows that pad a tail batch).  ``reduce`` turns this
    rank's sums into global ones: the identity on one card, a sum over
    'data' under DP (:func:`make_dp_loss_fn`)."""
    logits = birnn.forward(model, cfg.model, batch["feats"],
                           batch["frame_mask"])
    nll = ctc.ctc_loss(logits, batch["labels"], batch["frame_lengths"],
                       batch["label_lengths"], impl=cfg.ctc_impl)
    w = batch["weights"].to(torch.float32)
    num = reduce(torch.sum(nll * w))
    utts = reduce(torch.sum(w))
    frames = torch.clamp_min(reduce(
        torch.sum(batch["frame_lengths"].to(torch.float32) * w)), 1.0)
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
               cfg: Config, loss_closure: Optional[Callable] = None,
               reduce_grads: Optional[Callable] = None,
               norm_fn: Optional[Callable] = None,
               scalars: Optional[torch.Tensor] = None
               ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One update: value and gradient of :func:`loss_fn` (or of
    ``loss_closure(model, batch)``), the gradients passed through
    ``reduce_grads`` (a sum over ranks) when given, their global norm
    (``norm_fn``, default ``optim.global_norm``), then the optimizer
    chain in place on the parameters, with the momentum and learning rate
    of ``scalars`` (``optim.step_scalars`` at the state's count; made
    here when not given).  With ``cfg.train.debug_nans`` a
    non-finite loss or gradient norm raises ``FloatingPointError`` before
    the update, leaving the parameters and the optimizer state as they
    were."""
    params = dict(state.model.named_parameters())
    with torch.enable_grad():
        if loss_closure is None:
            loss, metrics = loss_fn(state.model, cfg, batch)
        else:
            loss, metrics = loss_closure(state.model, batch)
        grads = torch.autograd.grad(loss, list(params.values()))
    if reduce_grads is not None:
        grads = reduce_grads(list(grads))
    grads = dict(zip(params, grads))
    g_norm = (norm_fn or optim.global_norm)(list(grads.values()))
    if cfg.train.debug_nans:
        _check_finite(state.step, loss, g_norm)
    opt_state = optim.apply_updates(params, grads, state.opt_state,
                                    cfg.optim, g_norm=g_norm, scalars=scalars)
    metrics = {k: v.detach() for k, v in metrics.items()}
    metrics["grad_norm"] = g_norm
    return dataclasses.replace(state, step=state.step + 1,
                               opt_state=opt_state), metrics


@torch.no_grad()
def eval_step(model: birnn.BiRNN, cfg: Config,
              batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Forward, greedy best path and per-utterance NLL: {"hyp" [B, T],
    "hyp_len" [B], "nll" [B]}."""
    return eval_outputs(cfg, birnn.forward(model, cfg.model, batch["feats"],
                                           batch["frame_mask"]), batch)


@torch.no_grad()
def eval_outputs(cfg: Config, logits: torch.Tensor,
                 batch: Dict[str, torch.Tensor],
                 keep_log_probs: bool = False) -> Dict[str, torch.Tensor]:
    """:func:`eval_step`'s outputs from the batch's logits [B, T, V], and
    with ``keep_log_probs`` the log posteriors too (``"log_probs"``)."""
    log_probs = torch.log_softmax(logits.to(torch.float32), dim=-1)
    ids = torch.argmax(log_probs, dim=-1).to(torch.int32)
    hyp, hyp_len = collapse_ids(ids, batch["frame_mask"])
    nll = ctc.ctc_loss(log_probs, batch["labels"], batch["frame_lengths"],
                       batch["label_lengths"], impl=cfg.ctc_impl,
                       from_log_probs=True)
    out = {"hyp": hyp, "hyp_len": hyp_len, "nll": nll}
    if keep_log_probs:
        out["log_probs"] = log_probs
    return out


# ---------------------------------------------------------------------------
# The mesh half: DP, SP, TP and PP over torch.distributed
# ---------------------------------------------------------------------------

def _uses_sp(mesh: mesh_lib.Mesh) -> bool:
    return mesh.shape.get(AXIS_SEQ, 1) > 1


def make_dp_loss_fn(cfg: Config, mesh: mesh_lib.Mesh):
    """Pure-DP loss: :func:`loss_fn` on this rank's rows, its sums summed
    over 'data' (the sum's backward is the identity: every rank of the
    line computes the same loss, and the step sums the gradients)."""
    group = mesh.group(AXIS_DATA)

    def local_loss(model, batch):
        return loss_fn(model, cfg, batch,
                       reduce=lambda x: mesh_lib.all_reduce_sum(x, group))
    return local_loss


def batch_shardings(mesh: mesh_lib.Mesh) -> Dict[str, tuple]:
    """Input specs: for each batch array, the mesh axis each dimension is
    split over.  The batch's rows go over 'data'; with SP the frames of
    feats and frame_mask go over 'seq' too."""
    out = {k: (AXIS_DATA,) for k in BATCH_KEYS}
    if _uses_sp(mesh):
        out["feats"] = (AXIS_DATA, AXIS_SEQ, None)
        out["frame_mask"] = (AXIS_DATA, AXIS_SEQ)
    return out


def local_batch(arrays: Dict[str, np.ndarray],
                mesh: mesh_lib.Mesh) -> Dict[str, np.ndarray]:
    """This rank's block of a global batch's host arrays."""
    return mesh_lib.shard_batch(mesh, arrays, batch_shardings(mesh))


def local_rows(mesh: mesh_lib.Mesh, batch_size: int) -> Optional[np.ndarray]:
    """The rows of a global batch of ``batch_size`` that :func:`local_batch`
    keeps on this rank (its block over 'data', every frame of them under
    SP): the rows its train step reads.  None where the rank keeps every
    row."""
    if mesh.axis_size(AXIS_DATA) == 1:
        return None
    return local_batch({"weights": np.arange(batch_size)}, mesh)["weights"]


def eval_rows(cfg: Config, mesh: mesh_lib.Mesh) -> Optional[np.ndarray]:
    """The rows of a global eval batch that :func:`make_eval_step`'s step
    reads on this rank: its :func:`local_rows` under pure DP, TP and PP
    (each rank evaluates its block and the outputs are gathered); every
    row (None) where every rank evaluates the whole batch."""
    if (cfg.mesh.pipeline or mesh.axis_size(AXIS_MODEL) > 1
            or _pure_dp(mesh, cfg)):
        return local_rows(mesh, cfg.data.batch_size)
    return None


def reading_sets(mesh: mesh_lib.Mesh,
                 read: Optional[np.ndarray]) -> List[Tuple[int, ...]]:
    """Every set of ranks whose steps read the same rows ``read`` (this
    rank's :func:`local_rows` or :func:`eval_rows`) of a global batch, in
    rank order: the whole mesh where every rank reads every row (``read``
    None), else the ranks of each 'data' index (the 'model' line under TP
    and PP, the 'seq' line under SP, the rank alone under pure DP)."""
    grid = np.arange(mesh.size).reshape(
        [mesh.axis_size(a) for a in mesh_lib.MESH_AXES])
    if read is None:
        return [tuple(range(mesh.size))]
    return [tuple(int(r) for r in block.ravel()) for block in grid]


def feature_rows(mesh: mesh_lib.Mesh, batch_size: int,
                 read: Optional[np.ndarray]
                 ) -> Tuple[Tuple[int, ...], List[np.ndarray]]:
    """This rank's set of :func:`reading_sets` and the rows of a global
    batch of ``batch_size`` that each rank of the set featurizes: the rows
    ``read`` (None: every row) dealt in turn, the j-th to the set's
    (j mod n)-th rank, so each row goes to exactly one rank of the set and
    a length-sorted batch is shared evenly.  A function of the mesh and
    the batch size alone; ``BucketedLoader(rows=, exchange=)`` featurizes
    the rank's share and fills in the others' (``train.loop.rank_loader``)."""
    ranks = next(s for s in reading_sets(mesh, read) if mesh.rank in s)
    rows = np.arange(batch_size) if read is None else np.asarray(read)
    return ranks, [rows[k::len(ranks)] for k in range(len(ranks))]


def state_shardings(mesh: mesh_lib.Mesh, cfg: Config, state: TrainState):
    """Specs of the train state: for each parameter and its trace, the
    mesh axis each dimension is split over.  Under TP (``model > 1``) the
    parameters follow ``birnn.param_partition_specs``, under PP
    ``pipeline.pp_param_specs`` (the stacked layers over 'model'), and each
    trace its parameter, as JAX's ``state_shardings``; otherwise every
    tensor is replicated (``()``)."""
    if cfg.mesh.pipeline:
        from tpu_ctc_torch.parallel.pipeline import pp_param_specs
        specs = pp_param_specs(cfg.model)
    elif mesh.shape.get(AXIS_MODEL, 1) > 1:
        specs = birnn.param_partition_specs(cfg.model)
    else:
        specs = {}
    names = [k for k, _ in state.model.named_parameters()]
    params = {k: specs.get(k, ()) for k in names}
    return {"params": params,
            "trace": {k: params[k] for k in state.opt_state.trace}}


def sharded_dim(spec: tuple) -> Optional[int]:
    """The dimension of a spec that is split over 'model', or None."""
    return spec.index(AXIS_MODEL) if AXIS_MODEL in spec else None


def _set_param(model: torch.nn.Module, name: str, value: torch.Tensor):
    """Replace the parameter ``name`` ("pre.0.w") of ``model`` by a new
    parameter holding ``value``."""
    *path, leaf = name.split(".")
    module = model
    for part in path:
        module = getattr(module, part)
    setattr(module, leaf, torch.nn.Parameter(value))


def _place_state(state: TrainState, specs, mesh: mesh_lib.Mesh) -> None:
    """Lay the state out by its :func:`state_shardings`: every tensor is
    broadcast from rank 0 in place, so every rank starts from the same
    bits; then a tensor split over 'model' is replaced by this rank's
    block of it (the parameter, and its trace)."""
    n, i = mesh.axis_size(AXIS_MODEL), mesh.axis_index(AXIS_MODEL)
    with torch.no_grad():
        for k, p in list(state.model.named_parameters()):
            dist.broadcast(p, src=0)
            d = sharded_dim(specs["params"][k])
            if d is not None:
                per = p.shape[d] // n
                _set_param(state.model, k,
                           p.narrow(d, i * per, per).contiguous())
        for k, t in list(state.opt_state.trace.items()):
            dist.broadcast(t, src=0)
            d = sharded_dim(specs["trace"][k])
            if d is not None:
                per = t.shape[d] // n
                state.opt_state.trace[k] = t.narrow(d, i * per,
                                                    per).contiguous()


def _flat_all_reduce(grads: List[torch.Tensor], group) -> List[torch.Tensor]:
    """Each gradient summed over ``group`` (None: all ranks): one
    all-reduce of the flattened gradients, counted on
    ``parallel.mesh.GRAD_SUM``."""
    if not grads:
        return []
    flat = torch.cat([g.reshape(-1) for g in grads])
    mesh_lib.GRAD_SUM.launches += 1
    dist.all_reduce(flat, group=group)
    return [t.view_as(g) for t, g in
            zip(flat.split([g.numel() for g in grads]), grads)]


def _all_reduce_grads(grads: List[torch.Tensor]) -> List[torch.Tensor]:
    """Each gradient summed over all ranks (parameters replicated)."""
    return _flat_all_reduce(grads, None)


def _split_grad_reduction(mesh: mesh_lib.Mesh, sharded: List[bool]):
    """(reduce_grads, norm_fn) of a mesh whose parameters are split over
    'model' (``sharded[j]`` for the j-th parameter): a sharded parameter's
    gradient sums over 'data' only and a replicated one's over every rank,
    as shard_map's transpose sums the cotangents in JAX; the global norm
    sums the sharded squares over 'model' and counts each replicated
    parameter once."""
    data, model = mesh.group(AXIS_DATA), mesh.group(AXIS_MODEL)

    def reduce_grads(grads):
        out = list(grads)
        shard = [j for j, s in enumerate(sharded) if s]
        repl = [j for j, s in enumerate(sharded) if not s]
        if data is not None:
            for j, g in zip(shard, _flat_all_reduce(
                    [grads[j] for j in shard], data)):
                out[j] = g
        for j, g in zip(repl, _flat_all_reduce([grads[j] for j in repl],
                                               None)):
            out[j] = g
        return out

    def norm_fn(grads):
        sq = [torch.sum(g.to(torch.float32) ** 2) for g in grads]
        zero = torch.zeros((), dtype=torch.float32, device=grads[0].device)
        sq_shard = sum((q for q, s in zip(sq, sharded) if s), zero)
        sq_repl = sum((q for q, s in zip(sq, sharded) if not s), zero)
        sq_shard = sq_shard.reshape(1).clone()
        dist.all_reduce(sq_shard, group=model)
        return torch.sqrt(sq_shard[0] + sq_repl)

    return reduce_grads, norm_fn


def full_state(state: TrainState) -> TrainState:
    """The whole state on every rank: a state split over 'model' has its
    shards gathered (a collective: every rank calls it) into a new model
    and trace on the CPU; any other state is returned as it is.  A
    checkpoint of it is the one-card file."""
    if not state.specs:
        return state
    mesh = state.mesh
    whole = {}
    with torch.no_grad():
        for kind, tensors in (("params", dict(state.model.named_parameters())),
                              ("trace", state.opt_state.trace)):
            for k, t in tensors.items():
                d = sharded_dim(state.specs[k])
                t = t.detach()
                if d is not None:
                    t = mesh_lib.gather_blocks(mesh, t.contiguous(),
                                               AXIS_MODEL, d)
                whole[kind, k] = t.to("cpu", copy=True)
    model = birnn.BiRNN(state.model.cfg, device="cpu")
    if not isinstance(state.model.bi, torch.nn.ModuleList):   # PP: stacked
        from tpu_ctc_torch.parallel.pipeline import stack_model
        stack_model(model)
    for k, _ in list(model.named_parameters()):
        _set_param(model, k, whole["params", k])
    trace = {k: whole["trace", k] for k in state.opt_state.trace}
    return TrainState(state.step, model,
                      optim.OptState(trace, state.opt_state.count))


def eager_reason(cfg: Config, mesh: mesh_lib.Mesh, device,
                 train: bool = True) -> Optional[str]:
    """Why the train step (``train``) or the eval step of ``mesh`` on
    ``device`` stays eager, or None where :func:`make_train_step` and
    :func:`make_eval_step` capture it in CUDA graphs (``train.graphs``):
    on a card with one rank, or with several whose process groups are all
    NCCL's (DP, SP, TP, PP, DP x SP, DP x TP).  Eager on purpose: the CPU
    (no graphs: the tests' path); the train step with
    ``train.debug_nans``, whose check is a host read before the update;
    gloo groups (the CPU's backend, and that of ranks sharing one card),
    whose collectives run through the host and cannot be captured.
    Decided from the backends (``dist.get_backend``), never from a
    capture that failed."""
    if mesh.size > 1:
        backends = {dist.get_backend(g)
                    for g in (None, *mesh.groups.values())}
        if backends != {"nccl"}:
            return (f"{'/'.join(sorted(backends))} process groups (their "
                    f"collectives run through the host and cannot be "
                    f"captured)")
    if resolve_device(device).type != "cuda":
        return "the CPU (no CUDA graphs)"
    if train and cfg.train.debug_nans:
        return "train.debug_nans (a host read before the update)"
    return None


def make_train_step(cfg: Config, mesh: mesh_lib.Mesh, state: TrainState):
    """The train step of ``mesh``, with the JAX function's dispatch and
    checks: returns (step_fn, state), step_fn(state, batch) taking this
    rank's block of the batch as tensors (:func:`local_batch`, its labels
    cut on the global batch: ``batch_to_tensors(..., mesh=)``).  On a card
    with one rank or with NCCL ranks, step_fn is the compiled step
    (``train.graphs.CompiledTrainStep``: one CUDA graph per batch shape
    of the eager mesh step, collectives included, as the JAX function
    returns its step jitted on every mesh); it stays the eager
    :func:`train_step` where :func:`eager_reason` says why (the CPU,
    ``train.debug_nans``, gloo groups); the compiled step keeps the eager
    one as ``step_fn.eager``.  The state is replicated from rank 0, then
    split over 'model' where its specs say so (:func:`state_shardings`):
    TP (``model > 1``) runs ``parallel.tensor_parallel``'s loss, PP
    (``mesh.pipeline``) ``parallel.pipeline``'s, SP
    ``parallel.seq_parallel``'s, DP :func:`make_dp_loss_fn`."""
    shape = mesh.shape
    tp = shape.get(AXIS_MODEL, 1) > 1 and not cfg.mesh.pipeline
    loss_closure = None
    if cfg.mesh.pipeline:
        if shape.get(AXIS_SEQ, 1) > 1:
            # Config validation, not a missing feature (PARITY.md
            # "Parallelism composition"): the JAX package's words.
            raise ValueError(
                "mesh config invalid: pipeline=True with seq>1 is "
                "unsupported (PP microbatch schedule and SP carry rings "
                "serialize each other; use DPxPP or DPxSP — see "
                "PARITY.md)")
        if shape.get(AXIS_MODEL, 1) < 2:
            raise ValueError("mesh.pipeline requires model axis >= 2 stages")
        from tpu_ctc_torch.parallel.pipeline import make_pp_loss_fn
        loss_closure, _, _ = make_pp_loss_fn(cfg, mesh)
    elif _uses_sp(mesh):
        if shape.get(AXIS_MODEL, 1) > 1:
            raise ValueError(
                "mesh config invalid: seq>1 with model>1 is unsupported "
                "(SP carry rings and TP reduce-scatters compose into a "
                "per-chunk collective chain; use DPxTP or DPxSP — see "
                "PARITY.md)")
        from tpu_ctc_torch.parallel.seq_parallel import make_sp_loss_fn
        loss_closure, _ = make_sp_loss_fn(cfg, mesh)
    elif tp:
        from tpu_ctc_torch.parallel.tensor_parallel import make_tp_loss_fn
        loss_closure = make_tp_loss_fn(cfg, mesh)
    elif shape.get(AXIS_DATA, 1) > 1:
        loss_closure = make_dp_loss_fn(cfg, mesh)
    reduce_grads = norm_fn = None
    if mesh.size > 1:
        specs = state_shardings(mesh, cfg, state)
        _place_state(state, specs, mesh)
        sharded = [sharded_dim(specs["params"][k]) is not None
                   for k, _ in state.model.named_parameters()]
        if any(sharded):
            state.specs = specs["params"]    # a trace shares its name
            state.mesh = mesh
            reduce_grads, norm_fn = _split_grad_reduction(mesh, sharded)
        else:
            reduce_grads = _all_reduce_grads
    eager = functools.partial(train_step, cfg=cfg, loss_closure=loss_closure,
                              reduce_grads=reduce_grads, norm_fn=norm_fn)
    device = next(state.model.parameters()).device
    if eager_reason(cfg, mesh, device) is not None:
        return eager, state
    from tpu_ctc_torch.train.graphs import CompiledTrainStep
    return CompiledTrainStep(cfg, state, eager), state


def _pure_dp(mesh: mesh_lib.Mesh, cfg: Config) -> bool:
    """Pure data parallelism: the eval step splits the batch's rows."""
    shape = mesh.shape
    return (shape.get(AXIS_DATA, 1) > 1 and shape.get(AXIS_MODEL, 1) == 1
            and not _uses_sp(mesh) and not cfg.mesh.pipeline)


def make_eval_step(cfg: Config, mesh: mesh_lib.Mesh, device=None):
    """eval_fn(model, batch) on the global batch's tensors -> the whole
    batch's {"hyp", "hyp_len", "nll"} on every rank.  Under pure DP each
    rank evaluates its rows and the outputs are gathered over 'data';
    under TP and PP each rank runs the split forward on its block (rows
    over 'data') with its shards, the logits are gathered over 'model'
    and 'data', and every rank decodes the whole batch.  Both also return
    the whole batch's log posteriors (``"log_probs"``: ``loop.evaluate``'s
    beam search decodes them, since the rank's loader featurized only its
    rows, :func:`eval_rows`, and under TP and PP the rank's model is not
    the whole model); otherwise every rank evaluates the whole batch
    (:func:`eval_step`).  On a card (``device``, default ``cuda``) with
    one rank or with NCCL ranks eval_fn is compiled
    (``train.graphs.CompiledEvalStep``: one CUDA graph per batch shape,
    gathers included, as the JAX eval step is jitted on every mesh); it
    stays eager on the CPU and on gloo groups (:func:`eager_reason`).  The
    compiled step keeps the eager one as ``eval_fn.eager``."""
    fn = _eval_fn(cfg, mesh)
    if eager_reason(cfg, mesh, device, train=False):
        return fn
    from tpu_ctc_torch.train.graphs import CompiledEvalStep
    return CompiledEvalStep(cfg, resolve_device(device), fn)


def _eval_fn(cfg: Config, mesh: mesh_lib.Mesh):
    """:func:`make_eval_step`'s eager function."""
    specs = batch_shardings(mesh)
    if cfg.mesh.pipeline or mesh.shape.get(AXIS_MODEL, 1) > 1:
        if cfg.mesh.pipeline:
            from tpu_ctc_torch.parallel.pipeline import pp_logits
        else:
            pp_logits = None

        @torch.no_grad()
        def split_eval(model, batch):
            local = mesh_lib.shard_batch(mesh, batch, specs)
            if pp_logits is not None:
                logits = pp_logits(model, cfg, local["feats"],
                                   local["frame_mask"], mesh)
            else:
                from tpu_ctc_torch.parallel.tensor_parallel import tp_forward
                logits, _, _ = tp_forward(model, cfg.model, local["feats"],
                                          local["frame_mask"], mesh)
                logits = mesh_lib.gather_blocks(mesh, logits.contiguous(),
                                                AXIS_MODEL, 0)
            logits = mesh_lib.gather_blocks(mesh, logits, AXIS_DATA, 0)
            return eval_outputs(cfg, logits, batch, keep_log_probs=True)
        return split_eval
    if not _pure_dp(mesh, cfg):
        return lambda model, batch: eval_step(model, cfg, batch)

    @torch.no_grad()
    def dp_eval(model, batch):
        local = mesh_lib.shard_batch(mesh, batch, specs)
        logits = birnn.forward(model, cfg.model, local["feats"],
                               local["frame_mask"])
        out = eval_outputs(cfg, logits, local, keep_log_probs=True)
        return {k: mesh_lib.gather_blocks(mesh, v, AXIS_DATA, 0)
                for k, v in out.items()}
    return dp_eval
