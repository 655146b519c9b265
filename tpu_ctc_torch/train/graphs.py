"""The compiled step: one CUDA graph per batch shape for the train and eval
steps, on one card and on every mesh of NCCL ranks.

Counterpart of the JAX package's jitted step: its ``make_train_step``
returns ``jax.jit(train_step, donate_argnums=(0,))``, its eval step is
jitted the same way (``tpu_ctc/train/step.py``), and its loop runs "one
jit-compiled step per bucket shape (compiled once, cached)"
(``tpu_ctc/train/loop.py``).  Here the eager ``train.step.train_step`` and
``train.step.eval_step`` are captured into a ``torch.cuda.CUDAGraph`` the
first time a batch shape is seen and replayed after that: a step is one
graph launch instead of the eager step's few hundred launches from Python.
On a mesh the graph holds the eager mesh step whole: its loss closure
(DP, SP, TP, PP), the gradient sums and the global norm
(``train.step.make_train_step``), collectives included, as the JAX
package jits its step on every mesh.  The eager functions stay as they
are: the CPU tests hold them against the JAX package, and the card tests
hold the graphs against them.

A batch's shape (:func:`shape_key`) is the shape and dtype of each of its
arrays: (B, T bucket, label width) once the host has cut the labels
(``data.bucketing.cut_labels``), so nothing in the step reads the device
and the graph's lattice width is the batch's.  For each shape a step
object keeps

* static inputs, allocated outside every graph's pool; each call copies
  the batch into them on the current stream (a prefetched batch's copy is
  already ordered before it by ``prefetch_to_device``);
* the graph, captured after a warm-up on a side stream (the eager step on
  the static inputs, which builds the kernels and primes the libraries'
  handles; the train step's warm-up then restores the parameters and the
  trace from a copy in place, so the state is bit-identical to before);
* its outputs, which each call clones after the replay.

The train step reads the momentum and learning rate of each step from a
device tensor (``optim.step_scalars``), written before every replay from
the host formulas; it updates the parameters and the trace in place and
advances ``step`` and ``count`` on the host, as the eager step does (JAX
donates the state).  A step refuses (``RuntimeError``) a state whose
parameters or trace are not the tensors it captured, at the addresses it
captured (a ``_set_param``, a ``load_state_dict`` into new tensors): a
replay would write to stale memory.  A checkpoint restored in place
(``train.checkpoint.restore``) keeps them.

Spans (``utils.profiling``, recorded under a profiler, never inside a
capture): a train step's call is ``step.call``; inside it
``step.scalars`` writes the step's scalars, and a replay
(:meth:`Graph.run`, the eval step's too) is ``step.copy_in``,
``step.replay`` and ``step.clone``.

Memory: the graphs of one step object share one pool.  A replay may write
any memory that another graph's capture freed, and shapes replay in any
order, so no tensor that outlives a replay may live in the pool unless it
is copied out first: the static inputs, the parameters, the trace and the
scalars are allocated outside it, and the outputs are cloned before the
call returns.

Launch counts: a replay does not pass through the kernels' Python
wrappers, nor call the mesh's collectives from Python, so each graph
records, per entry of ``ops.kernels()``, the launches its capture made
(``ops._build.CudaKernel.launches``; a collective's
``parallel.mesh.Collective.launches``) and adds them at every replay; the
warm-up and the capture count as none.  N replays count what N eager steps
count.

Meshes.  NCCL's collectives are captured as graph nodes on the process
group's stream, forked from and joined to the capturing stream; the
capture runs in ``thread_local`` mode, so the process group's watchdog
may query its own events meanwhile.  Three rules keep the ranks together:

* every rank keys on the same shape at every step: this rank's block of
  the batch, its labels cut on the global batch (``data.prefetch``,
  ``train.step.batch_to_tensors(..., mesh=)``), so all ranks warm up and
  capture at the same steps and replay the same graphs;
* the warm-up runs the whole eager mesh step on every rank, its
  collectives executed, before any capture: that creates every
  communicator the step uses (each mesh line's group, NCCL's p2p
  communicators of ``batch_isend_irecv``), since one made lazily inside a
  capture breaks it;
* a replay issues its collectives in the eager step's order, between the
  loop's eager ones on the same communicators (NCCL's graph mixing).

A graph that holds NCCL operations keeps its communicator alive: release
the step (:meth:`_Compiled.release`, or drop it) before destroying the
process group.

Stays eager (``train.step.eager_reason``): the CPU (no graphs; the
tests' path); ``train.debug_nans``, whose check is a host read that must
come before the update; gloo groups (the CPU's backend, and that of
ranks sharing one card), whose collectives run through the host and
cannot be captured.  A capture that fails raises with the error of the
operation that broke it: no step quietly runs eager instead.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from tpu_ctc_torch.config import Config
from tpu_ctc_torch.ops import kernels
from tpu_ctc_torch.train import optim
from tpu_ctc_torch.train.step import BATCH_KEYS, TrainState
from tpu_ctc_torch.utils import profiling


def shape_key(batch) -> Tuple:
    """A batch's graph key: (name, shape, dtype name) of each array of
    ``train.step.BATCH_KEYS``, from their ``shape`` and ``dtype`` alone, so
    the host arrays (numpy) and the tensors made from them give one key."""
    return tuple((k, tuple(int(n) for n in batch[k].shape),
                  str(batch[k].dtype).replace("torch.", ""))
                 for k in BATCH_KEYS)


def _counts() -> List[int]:
    return [k.launches for k in kernels()]


def _set_counts(counts: Sequence[int]) -> None:
    for k, n in zip(kernels(), counts):
        k.launches = n


@dataclasses.dataclass
class Graph:
    """One captured shape: the graph, its static inputs and outputs, the
    launches a replay makes (per kernel of ``ops.kernels()``) and the
    seconds its warm-up and capture took."""
    graph: torch.cuda.CUDAGraph
    inputs: Dict[str, torch.Tensor]
    outputs: Dict[str, torch.Tensor]
    launches: List[int]
    capture_s: float

    def run(self, batch) -> Dict[str, torch.Tensor]:
        """Copy ``batch`` in, replay, count the launches, and return a
        clone of the outputs (the spans ``step.copy_in``, ``step.replay``
        and ``step.clone``)."""
        with profiling.span("step.copy_in"):
            for k in BATCH_KEYS:
                self.inputs[k].copy_(batch[k])
        with profiling.span("step.replay"):
            self.graph.replay()
        for kern, n in zip(kernels(), self.launches):
            kern.launches += n
        with profiling.span("step.clone"):
            return {k: v.clone() for k, v in self.outputs.items()}


class _Compiled:
    """The graphs of one step function, keyed by :func:`shape_key`, in one
    pool; bound to the tensors (parameters, trace) they update or read."""

    what = "step"

    def __init__(self, cfg: Config, device: torch.device):
        self.cfg = cfg
        self.device = torch.device(device)
        self.graphs: Dict[Tuple, Graph] = {}
        self.pool = torch.cuda.graph_pool_handle()
        self._bound: Optional[List[torch.Tensor]] = None
        self._ptrs: List[int] = []

    def _bind(self, tensors: List[torch.Tensor]) -> None:
        if self._bound is None:
            self._bound = list(tensors)
            self._ptrs = [t.data_ptr() for t in tensors]
            return
        if len(tensors) != len(self._bound) or any(
                a is not b or a.data_ptr() != p
                for a, b, p in zip(tensors, self._bound, self._ptrs)):
            raise RuntimeError(
                f"compiled {self.what}: a parameter or trace tensor is not "
                f"the one its CUDA graphs were captured with (replaced after "
                f"the step was made, e.g. by a new nn.Parameter or a load "
                f"into new tensors); a replay would write to its old memory. "
                f"Make the step again (make_train_step / make_eval_step) "
                f"after replacing tensors, or copy into them in place")

    def _capture(self, key: Tuple, batch, warm: Callable,
                 body: Callable) -> Graph:
        """Static inputs holding ``batch``, ``warm(inputs)`` on a side
        stream, then the capture of ``body(inputs)`` (its dict of output
        tensors); the launch counts are left as they were."""
        t0 = time.perf_counter()
        counts = _counts()
        current = torch.cuda.current_stream(self.device)
        inputs = {k: torch.empty_like(batch[k], device=self.device)
                  for k in BATCH_KEYS}
        for k in BATCH_KEYS:
            inputs[k].copy_(batch[k])
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            warm(inputs)
        current.wait_stream(side)
        before = _counts()
        graph = torch.cuda.CUDAGraph()
        try:
            # thread_local: the prefetch thread pins and copies the next
            # batch while this thread captures
            with torch.cuda.graph(graph, pool=self.pool,
                                  capture_error_mode="thread_local"):
                outputs = body(inputs)
        except Exception as e:
            _set_counts(counts)
            shapes = {k: (tuple(s), d) for k, s, d in key}
            raise RuntimeError(
                f"compiled {self.what}: CUDA graph capture failed for the "
                f"batch shape {shapes}: {type(e).__name__}: {e}") from e
        launches = [a - b for a, b in zip(_counts(), before)]
        _set_counts(counts)
        g = Graph(graph, inputs, outputs, launches,
                  time.perf_counter() - t0)
        self.graphs[key] = g
        return g

    def release(self) -> None:
        """Drop every graph once the card has run them.  On a mesh call it
        (or drop the step) before ``dist.destroy_process_group``: NCCL's
        communicator teardown waits until no CUDA graph holds operations of
        that communicator."""
        torch.cuda.synchronize(self.device)
        self.graphs.clear()

    def stats(self) -> Dict[str, object]:
        """Shapes captured and each one's warm-up + capture seconds."""
        return {"shapes": len(self.graphs),
                "capture_s": [g.capture_s for g in self.graphs.values()]}


class CompiledTrainStep(_Compiled):
    """``step_fn(state, batch) -> (state, metrics)``: the eager step's
    arithmetic, one CUDA graph per batch shape.  ``eager`` is the step it
    captures, called as ``eager(state, batch, scalars=...)``: the mesh's
    ``train_step`` with its loss closure, gradient sums and norm (on one
    card ``train_step`` alone).  Made by ``train.step.make_train_step``
    on a card for one rank or a mesh of NCCL ranks."""

    what = "train step"

    def __init__(self, cfg: Config, state: TrainState, eager: Callable):
        device = next(state.model.parameters()).device
        super().__init__(cfg, device)
        self.eager = eager
        self.scalars = torch.zeros(2, dtype=torch.float32, device=device)
        self._bind(self._tensors(state))

    @staticmethod
    def _tensors(state: TrainState) -> List[torch.Tensor]:
        trace = state.opt_state.trace
        return list(state.model.parameters()) + [trace[k] for k in
                                                 sorted(trace)]

    def _warm(self, state: TrainState):
        def warm(inputs):
            saved = [t.detach().clone() for t in self._bound]
            self.eager(state, inputs, scalars=self.scalars)
            with torch.no_grad():
                for t, s in zip(self._bound, saved):
                    t.copy_(s)
        return warm

    def _body(self, state: TrainState):
        def body(inputs):
            return self.eager(state, inputs, scalars=self.scalars)[1]
        return body

    def capture(self, state: TrainState, batch: Dict[str, torch.Tensor]
                ) -> Graph:
        """The graph of ``batch``'s shape, captured now if the shape is
        new; the state is left bit-identical and no step is taken."""
        self._bind(self._tensors(state))
        key = shape_key(batch)
        if key not in self.graphs:
            optim.step_scalars(self.cfg.optim, state.opt_state.count,
                               out=self.scalars)
            self._capture(key, batch, self._warm(state), self._body(state))
        return self.graphs[key]

    def __call__(self, state: TrainState, batch: Dict[str, torch.Tensor]
                 ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        with profiling.span("step.call"):
            graph = self.capture(state, batch)
            with profiling.span("step.scalars"):
                optim.step_scalars(self.cfg.optim, state.opt_state.count,
                                   out=self.scalars)
            metrics = graph.run(batch)
        return dataclasses.replace(state, step=state.step + 1,
                                   opt_state=optim.OptState(
                                       state.opt_state.trace,
                                       state.opt_state.count + 1)), metrics


class CompiledEvalStep(_Compiled):
    """``eval_fn(model, batch) -> {"hyp", "hyp_len", "nll", ...}``: the
    eager ``eager(model, batch)``, one CUDA graph per batch shape:
    ``eval_step`` (forward, log-softmax, argmax, ``collapse_ids`` and the
    NLL), on a DP, TP or PP mesh ``make_eval_step``'s DP or split eval
    (the gathers included).  Bound to the first model it is called with.
    Made by ``train.step.make_eval_step`` on a card for one rank or a
    mesh of NCCL ranks."""

    what = "eval step"

    def __init__(self, cfg: Config, device: torch.device, eager: Callable):
        super().__init__(cfg, device)
        self.eager = eager

    def __call__(self, model, batch: Dict[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
        self._bind(list(model.parameters()))
        key = shape_key(batch)
        graph = self.graphs.get(key)
        if graph is None:
            def run(inputs):
                return self.eager(model, inputs)
            graph = self._capture(key, batch, run, run)
        return graph.run(batch)

