"""The traced window: ``torch.profiler`` on the card's activity, read in
memory and summarised (no trace file is written).

The summary holds the device's busy seconds (the union of the intervals
of kernels, copies and sets inside the window), each device operation's
count and seconds by name, and the longest idle gaps, each named by the
harness span the host was in at the gap's middle.  The harness's spans
(``Spans``) are kept on the same clock as the profiler's events
(``time.time_ns``).
"""
from __future__ import annotations

import bisect
import contextlib
import re
import time
from typing import Dict, List, Tuple

TOP = 10


class Spans:
    """Host spans of the harness: name -> [count, seconds], and with
    ``keep`` each interval (ns) for naming idle gaps."""

    def __init__(self, keep: bool = False):
        self.totals: Dict[str, List[float]] = {}
        self.keep = keep
        self.intervals: List[Tuple[int, int, str]] = []

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.time_ns()
        try:
            yield
        finally:
            t1 = time.time_ns()
            tot = self.totals.setdefault(name, [0, 0.0])
            tot[0] += 1
            tot[1] += (t1 - t0) / 1e9
            if self.keep:
                self.intervals.append((t0, t1, name))


def profiler():
    """A profiler of the card's activity, not started (of the host's where
    there is no card: the tests' path, which reads no device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CUDA
                               if torch.cuda.is_available()
                               else ProfilerActivity.CPU])


def _device_events(prof):
    """(start, end, name) of the operations that ran on the card, from the
    profiler's own records (``kineto_results``, as the port's
    ``utils.devtime`` reads them)."""
    from torch.autograd import DeviceType
    return [(e.start_ns(), e.end_ns(), e.name())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", lambda: False)()]


def short_name(name: str) -> str:
    """A kernel's name without its argument list and anonymous
    namespaces: ``void (anonymous namespace)::f<true>(...)`` ->
    ``f<true>``."""
    name = re.sub(r"^void ", "", name.replace("(anonymous namespace)::", ""))
    depth, cut = 0, len(name)
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            cut = i
            break
    return name[:cut][:120]


def summarise(prof, t0_ns: int, t1_ns: int, spans: Spans) -> dict:
    """{"busy_s", "window_s", "ops": {name: [count, seconds]},
    "breakdown": {"device_ops", "idle_gaps"}} of the window [t0, t1]."""
    events = [(max(s, t0_ns), min(e, t1_ns), n)
              for s, e, n in _device_events(prof) if e > t0_ns and s < t1_ns]
    ops: Dict[str, List[float]] = {}
    for s, e, n in events:
        rec = ops.setdefault(short_name(n), [0, 0.0])
        rec[0] += 1
        rec[1] += (e - s) / 1e9
    merged: List[List[int]] = []
    for s, e, _ in sorted(events):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    busy = sum(e - s for s, e in merged) / 1e9
    edges = [t0_ns] + [x for iv in merged for x in iv] + [t1_ns]
    gaps = [(edges[i + 1] - edges[i], edges[i])
            for i in range(0, len(edges) - 1, 2) if edges[i + 1] > edges[i]]
    gaps.sort(reverse=True)
    starts = sorted(spans.intervals)
    keys = [iv[0] for iv in starts]

    def host_at(t: int) -> str:
        i = bisect.bisect_right(keys, t) - 1
        if i >= 0 and starts[i][1] >= t:
            return starts[i][2]
        return "host_other"

    device_ops = sorted(([n, r[1]] for n, r in ops.items()),
                        key=lambda x: -x[1])[:TOP]
    idle = [[host_at(start + length // 2), length / 1e9]
            for length, start in gaps[:TOP]]
    return {"busy_s": busy, "window_s": (t1_ns - t0_ns) / 1e9, "ops": ops,
            "breakdown": {"device_ops": device_ops, "idle_gaps": idle}}
