"""Device time of a function on the card, from a ``torch.profiler`` trace.

Counterpart of ``tpu_ctc.utils.devtime``.  The port keeps the module for
another reason than the JAX package's: a card's CUDA events time the
stream, which includes the host's launch gaps between kernels, so a
function made of many small launches (the plain CTC loop, a wrapper
around a kernel) reads slower on the clock than on the device.  The
profiler's device events give the time the card spent executing the
function's kernels, without the launch overhead between them.
"""
from __future__ import annotations

import re
import types
from typing import Optional

import torch


def _device_exec_ms(events, kernel: Optional[str] = None) -> float:
    """Sum of the device-side event durations (ms) in a profiler's
    events: kernels, memcpys and memsets, each with ``device_type`` CUDA
    and a ``time_range``; host-side events are skipped.  With ``kernel``
    (a regular expression) only the device events whose name it matches
    count."""
    from torch.autograd import DeviceType
    total_us = 0.0
    for e in events:
        if e.device_type == DeviceType.CUDA and (
                kernel is None or re.search(kernel, e.name)):
            total_us += e.time_range.elapsed_us()
    return total_us / 1e3


def _device_events(prof) -> list:
    """The device events of a finished ``torch.profiler`` trace, each with
    the ``device_type``, ``name`` and ``time_range`` (us) that
    ``prof.events()`` would give it, read from the profiler's own records
    (``kineto_results``): ``prof.events()`` builds an object a host and a
    device event, seconds for a trace of a loop's 10^5 launches."""
    from torch.autograd import DeviceType
    from torch.autograd.profiler_util import Interval
    return [types.SimpleNamespace(
        device_type=e.device_type(), name=e.name(),
        time_range=Interval(e.start_ns() / 1e3, e.end_ns() / 1e3))
        for e in prof.profiler.kineto_results.events()
        if e.device_type() == DeviceType.CUDA]


def device_time_ms(fn, *args, iters: int = 10,
                   kernel: Optional[str] = None) -> float:
    """Average device execution time of ``fn(*args)`` in milliseconds.

    One warm-up call (which also builds the kernels), then ``iters`` calls
    under ``torch.profiler`` with CUDA activity; the device events of those
    calls (with ``kernel``, those whose name matches it: one kernel of the
    call) are summed and divided by ``iters``.  Raises without a card: the
    CPU has no device time, and its host time is not one.
    """
    if not torch.cuda.is_available():
        raise RuntimeError("device_time_ms needs a CUDA card: there is no "
                           "device time to read on the CPU")
    from torch.profiler import ProfilerActivity, profile
    fn(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn(*args)
        torch.cuda.synchronize()
    ms = _device_exec_ms(_device_events(prof), kernel)
    if ms <= 0.0:
        raise RuntimeError(f"device_time_ms: the profiler recorded no device "
                           f"time{'' if kernel is None else ' for ' + kernel}")
    return ms / iters


def event_ms(fn, *args) -> float:
    """Time a launch of ``fn(*args)`` with CUDA events in milliseconds: the
    median of 5 runs of 10 back-to-back calls, per call, after one
    warm-up call.  Within a run the card stays busy while the host
    prepares the next launch, so the events time the device's work; an
    event pair around a single call after a sync also times the
    wrapper's host work.  Raises without a card, as
    :func:`device_time_ms` does."""
    if not torch.cuda.is_available():
        raise RuntimeError("event_ms needs a CUDA card")
    fn(*args)
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(10):
            fn(*args)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / 10)
    return sorted(times)[len(times) // 2]
