"""The metric arithmetic: a rate over the whole window, the p95 over all
calls, the idle share and the idle gaps from the device's intervals."""
import types

import numpy as np
import pytest

from ctcbench import spec, trace


class _Event:
    def __init__(self, start, end, name, cuda=True):
        from torch.autograd import DeviceType
        self._s, self._e, self._n = start, end, name
        self._d = DeviceType.CUDA if cuda else DeviceType.CPU

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def name(self):
        return self._n

    def device_type(self):
        return self._d


def _prof(events):
    results = types.SimpleNamespace(events=lambda: events)
    return types.SimpleNamespace(
        profiler=types.SimpleNamespace(kineto_results=results))


def test_busy_is_the_union_of_device_intervals():
    spans = trace.Spans(keep=True)
    spans.intervals = [(0, 50, "input_wait"), (50, 100, "step_call")]
    prof = _prof([_Event(10, 30, "void k1<true>(int)"),
                  _Event(20, 40, "k2"),            # overlaps k1
                  _Event(60, 70, "k1<true>"),
                  _Event(0, 100, "cudaLaunchKernel", cuda=False)])
    s = trace.summarise(prof, 0, 100, spans)
    assert s["busy_s"] == pytest.approx(40e-9)       # [10,40] and [60,70]
    assert s["window_s"] == pytest.approx(100e-9)
    assert s["ops"]["k1<true>"] == [2, pytest.approx(30e-9)]
    gaps = s["breakdown"]["idle_gaps"]
    # gaps [0,10] input_wait, [40,60] at 50: step_call, [70,100] step_call
    assert gaps[0] == ["step_call", pytest.approx(30e-9)]
    assert sorted(g[1] for g in gaps) == pytest.approx([10e-9, 20e-9, 30e-9])


def _rec(kind, **kw):
    return dict(kind=kind, spans={}, trace=None, **kw)


def test_rate_counts_all_work_over_the_whole_window():
    read = spec.reader("train_audio_s_per_s")
    rec = _rec("train", audio_s=300.0, window_s=10.0)
    assert read(rec, None) == pytest.approx(30.0)
    assert spec.reader("decode_audio_s_per_s")(rec, None) is None


def test_p95_is_over_every_call():
    ms = list(np.arange(1, 201, dtype=float))      # 200 calls, 1..200 ms
    rec = _rec("decode", steps=[{"ms": m} for m in ms])
    got = spec.reader("decode_batch_ms_p95")(rec, None)
    assert got == pytest.approx(np.percentile(ms, 95)) == pytest.approx(190.05)


def test_idle_share_and_a_silent_reader():
    rec = _rec("train", steps=[{}], window_s=1.0)
    rec["trace"] = {"busy_s": 0.75, "window_s": 1.0, "ops": {}}
    assert spec.reader("idle_share.train")(rec, None) == pytest.approx(25.0)
    # no B1/B2 device time: the roofline reader finds nothing and says so
    assert spec.reader("birnn_roofline.train")(rec, None) is None


def test_every_metric_has_a_reader_and_the_cells_report_what_they_move():
    bench = spec.benchmark()
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(spec.reader(m["name"]))
    for m in bench["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m.get("workloads", cells):
            assert cell in moved.get("workloads", cells)
