"""Tracing: the port's spans and counters, the profiler's trace, FLOPs.

Counterpart of ``tpu_ctc.utils.profiling``:

  * :func:`span` and :func:`count` -- the port's own spans and counters,
    kept in memory while a ``torch.profiler`` session records in the
    process, and read back by window (:func:`spans`, :func:`totals`,
    :func:`counters`); see :class:`Recorder`;
  * :func:`trace` -- a ``torch.profiler`` trace of any code region (CPU
    and, with a card, CUDA activity), written as a Chrome trace with the
    port's spans of the region on the kernels' timeline;
  * :func:`flops_estimate` and :func:`mfu` -- the analytic FLOP count of a
    BiRNN train step and the model FLOP/s utilization it gives against a
    card's peak (by default the H100 SXM's dense bf16 tensor rate);
  * :func:`card_line` -- the card's name and power limit, which every
    measurement on a card is printed beside.

The spans, each named ``layer.what``: ``loader.make_batch`` (a batch's
wait for its utterances and its padding, ``data.bucketing``);
``prefetch.stage`` (the prefetch thread's pin, copy and event of a
batch) and ``prefetch.get_wait`` (the consumer's wait on the queue),
with the counters ``prefetch.gets`` and ``prefetch.empty`` (the queue
was empty at the get), ``data.prefetch``; ``step.call`` around the
compiled train step's call, with ``step.scalars``, ``step.copy_in``,
``step.replay`` and ``step.clone`` inside it (``train.graphs``);
``decode.call`` around ``decode.beam.make_beam_decoder``'s decode, with
``decode.h2d``, ``decode.forward`` and ``decode.search`` inside it.
None sits inside a captured CUDA graph or a kernel's launch wrapper.

Beside these, and recorded whether or not a profiler runs, the launch
counters of ``ops.kernels()``: each kernel's launches, and the mesh
step's collectives as counted objects of ``parallel.mesh``:
``nccl_grad_sum`` (each flat all-reduce of the gradients, one a DP step)
and ``nccl_loss_sum`` (each all-reduce of the loss's sums, three a DP
step).  They are counted where the collective is called, a graph's
replay adding what its capture called (``train.graphs``); they do no
work on the device, and a one-rank step counts neither.
"""
from __future__ import annotations

import contextlib
import json
import os
import subprocess
import threading
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
from torch.autograd import profiler as _autograd_profiler

from tpu_ctc_torch.config import Config

# The spans kept for reading by window; the totals count every span.
MAX_SPANS = 1 << 18


class Span(NamedTuple):
    """A recorded span: its start and end on ``time.time_ns``'s clock (the
    profiler's), the OS id of the thread it ran on, and the name of the
    span that enclosed it on that thread (None at the top)."""
    name: str
    start_ns: int
    end_ns: int
    thread: int
    parent: Optional[str]


class _Open:
    """A span being recorded (the on path)."""

    __slots__ = ("rec", "name", "parent", "t0")

    def __init__(self, rec: "Recorder", name: str):
        self.rec = rec
        self.name = name

    def __enter__(self):
        stack = self.rec._stack()
        self.parent = stack[-1] if stack else None
        stack.append(self.name)
        self.t0 = time.time_ns()

    def __exit__(self, *exc):
        t1 = time.time_ns()
        self.rec._stack().pop()
        self.rec._add((self.name, self.t0, t1, threading.get_native_id(),
                       self.parent))
        return False


_OFF = contextlib.nullcontext()


class Recorder:
    """Spans and counters, on exactly while a ``torch.profiler`` session
    records in the process (the profiler's own flag, which
    ``record_function`` reads too), so a run without a profiler pays one
    attribute test a span: it gets one shared no-op context, and no
    allocation, clock read or lock.  On, a span records its name, start,
    end, thread and enclosing span into a list of at most ``MAX_SPANS``
    spans (later ones are counted in ``dropped``), with per-name totals of
    every span beside it; a counter is an int by name.  Safe across
    threads."""

    def __init__(self):
        self._lock = threading.Lock()
        self._local = threading.local()
        self.reset()

    def reset(self) -> None:
        """Forget every span and counter."""
        with self._lock:
            self._spans: List[tuple] = []
            self._totals: Dict[str, List] = {}
            self._counters: Dict[str, int] = {}
            self.dropped = 0

    def span(self, name: str):
        """A context that records the code it encloses as span ``name``."""
        if not _autograd_profiler._is_profiler_enabled:
            return _OFF
        return _Open(self, name)

    def count(self, name: str, n: int = 1) -> None:
        """Add ``n`` to counter ``name``."""
        if not _autograd_profiler._is_profiler_enabled:
            return
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def _stack(self) -> List[str]:
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def _add(self, s: tuple) -> None:
        """Keep ``s``, the fields of a :class:`Span` (made when read)."""
        with self._lock:
            tot = self._totals.setdefault(s[0], [0, 0.0])
            tot[0] += 1
            tot[1] += (s[2] - s[1]) / 1e9
            if len(self._spans) < MAX_SPANS:
                self._spans.append(s)
            else:
                self.dropped += 1

    def spans(self, t0_ns: Optional[int] = None,
              t1_ns: Optional[int] = None) -> List[Span]:
        """The kept spans that started at or after ``t0_ns`` and ended at
        or before ``t1_ns`` (either bound may be left out), in the order
        they ended."""
        with self._lock:
            kept = list(self._spans)
        return [Span._make(s) for s in kept
                if (t0_ns is None or s[1] >= t0_ns)
                and (t1_ns is None or s[2] <= t1_ns)]

    def totals(self, t0_ns: Optional[int] = None,
               t1_ns: Optional[int] = None) -> Dict[str, Tuple[int, float]]:
        """name -> (count, seconds): of every span recorded, or, with a
        bound, of the kept spans in the window (:meth:`spans`)."""
        if t0_ns is None and t1_ns is None:
            with self._lock:
                return {k: (n, s) for k, (n, s) in self._totals.items()}
        out: Dict[str, Tuple[int, float]] = {}
        for s in self.spans(t0_ns, t1_ns):
            n, sec = out.get(s.name, (0, 0.0))
            out[s.name] = (n + 1, sec + (s.end_ns - s.start_ns) / 1e9)
        return out

    def counters(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counters)


RECORDER = Recorder()
span = RECORDER.span
count = RECORDER.count
spans = RECORDER.spans
totals = RECORDER.totals
counters = RECORDER.counters
reset = RECORDER.reset

# Dense bf16 tensor-core peak of one H100 SXM (NVIDIA data sheet, without
# sparsity, at the 700 W power limit).
H100_SXM_BF16_DENSE_FLOPS = 989e12


def card_line(device) -> str:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` of
    a CUDA device (a card may be set below its 700 W maximum, and then runs
    slower); ``"cpu"`` for a CPU device."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev.type
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         "-i", str(index)], capture_output=True, text=True, check=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0]


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` around a region; the trace is written to
    ``log_dir/trace.json`` (chrome://tracing, Perfetto), with the port's
    spans of the region as events of category ``port_span`` on their
    threads' rows, on the profiler's time base."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    t0 = time.time_ns()
    with profile(activities=activities) as prof:
        yield prof
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    _add_spans(path, spans(t0, time.time_ns()))


def _add_spans(path: str, found: List[Span]) -> None:
    """Append ``found`` to the Chrome trace at ``path`` as complete events
    in microseconds from its ``baseTimeNanoseconds`` (the profiler writes
    its events' times from that base)."""
    with open(path) as f:
        doc = json.load(f)
    base = doc.get("baseTimeNanoseconds", 0)
    pid = os.getpid()
    doc["traceEvents"].extend(
        {"ph": "X", "cat": "port_span", "name": s.name, "pid": pid,
         "tid": s.thread, "ts": (s.start_ns - base) / 1e3,
         "dur": (s.end_ns - s.start_ns) / 1e3, "args": {"parent": s.parent}}
        for s in found)
    with open(path, "w") as f:
        json.dump(doc, f)


def flops_estimate(cfg: Config, batch: int, frames: int) -> float:
    """Analytic train-step FLOPs for the BiRNN stack (fwd ~ 1x, bwd ~ 2x).

    Per bidirectional layer: one shared input projection (2*B*T*D*H) plus
    two recurrent matmul chains (2 * 2*B*T*H*H).
    """
    m = cfg.model
    d = m.input_dim
    h = m.hidden_dim
    fwd = 0.0
    for _ in range(m.num_pre_layers):
        fwd += 2.0 * batch * frames * d * h
        d = h
    for _ in range(m.num_bi_layers):
        fwd += 2.0 * batch * frames * d * h      # shared projection
        fwd += 2 * 2.0 * batch * frames * h * h  # two directions
        d = h
    for _ in range(m.num_post_layers):
        fwd += 2.0 * batch * frames * h * h
    fwd += 2.0 * batch * frames * h * m.vocab_size
    return 3.0 * fwd                              # fwd + ~2x bwd


def mfu(cfg: Config, batch: int, frames: int, step_time_s: float,
        peak: float = H100_SXM_BF16_DENSE_FLOPS) -> float:
    """Model FLOP/s utilization of one card for a measured step time."""
    return flops_estimate(cfg, batch, frames) / step_time_s / peak
