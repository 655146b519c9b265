"""The port's spans and counters (``tpu_ctc_torch.utils.profiling``), on
the CPU.

* Without a profiler a span is one shared no-op context and nothing is
  recorded or allocated; under a CPU ``torch.profiler`` (as a context or
  by ``start``/``stop``) spans and counters are recorded, each child with
  its parent's name, on the profiler's clock (an ``aten::mm`` falls inside
  the span around the ``@``); the kept list is bounded and the recorder
  holds its totals under many threads.
* Where the port records them: the prefetch thread's ``prefetch.stage``
  and the loader's ``loader.make_batch`` on the worker's thread, the
  consumer's ``prefetch.get_wait`` and counters; the compiled train
  step's ``step.call`` around ``step.scalars``, ``step.copy_in``,
  ``step.replay`` and ``step.clone`` (a stub graph whose replay does
  nothing); ``make_beam_decoder``'s ``decode.call`` around
  ``decode.h2d``, ``decode.forward`` and ``decode.search``.
* ``trace`` writes the spans into its Chrome trace on the profiler's
  time base; the benchmark's readers of the spans read only their window.
"""
import json
import os
import sys
import threading
import time
import tracemalloc

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ctcbench import spec
from tpu_ctc_torch import config
from tpu_ctc_torch.data.bucketing import BucketedLoader
from tpu_ctc_torch.data.prefetch import prefetch_to_device
from tpu_ctc_torch.data.synthetic import SyntheticCorpus
from tpu_ctc_torch.utils import profiling

SMALL = {"model.hidden_dim": 32, "model.num_bi_layers": 2,
         "model.compute_dtype": "float32", "model.init_scale": 0.2,
         "data.batch_size": 4, "data.bucket_boundaries": (48,),
         "data.sortagrad": False}


@pytest.fixture(autouse=True)
def fresh():
    profiling.reset()
    yield
    profiling.reset()


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _by_name():
    out = {}
    for s in profiling.spans():
        out.setdefault(s.name, []).append(s)
    return out


def _work():
    with profiling.span("outer"):
        with profiling.span("inner"):
            profiling.count("things", 2)


@pytest.mark.parametrize("on", [False, True])
def test_a_span_allocates_only_under_a_profiler(on):
    """Off, every span is the one shared no-op context: no line of the
    recorder allocates and nothing is kept.  On, the same spans allocate
    and are kept."""
    if not on:
        assert profiling.span("a") is profiling.span("b")
    prof = _cpu_profile()
    if on:
        prof.start()
    _work()                            # the thread's stack, made once
    profiling.reset()
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        for _ in range(200):
            _work()
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
        if on:
            prof.stop()
    where = [tracemalloc.Filter(True, profiling.__file__)]
    grown = sum(d.size_diff for d in after.filter_traces(where).compare_to(
        before.filter_traces(where), "filename") if d.size_diff > 0)
    if on:
        assert grown > 0
        assert {k: n for k, (n, _) in profiling.totals().items()} == {
            "outer": 200, "inner": 200}
        assert profiling.counters() == {"things": 400}
    else:
        assert grown == 0
        assert profiling.spans() == [] and profiling.totals() == {}
        assert profiling.counters() == {}


@pytest.mark.parametrize("how", ["context", "start_stop"])
def test_spans_and_counters_under_a_cpu_profiler(how):
    if how == "context":
        with _cpu_profile():
            _work()
    else:
        prof = _cpu_profile()
        prof.start()
        _work()
        prof.stop()
    _work()                             # after the profiler: not recorded
    found = _by_name()
    assert sorted(found) == ["inner", "outer"]
    (outer,), (inner,) = found["outer"], found["inner"]
    assert outer.parent is None and inner.parent == "outer"
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns
    assert inner.thread == outer.thread == threading.get_native_id()
    assert profiling.counters() == {"things": 2}
    n, sec = profiling.totals()["outer"]
    assert n == 1 and sec == pytest.approx(
        (outer.end_ns - outer.start_ns) / 1e9)


def test_kept_spans_are_bounded_and_the_totals_count_all(monkeypatch):
    monkeypatch.setattr(profiling, "MAX_SPANS", 3)
    rec = profiling.Recorder()
    with _cpu_profile():
        for _ in range(5):
            with rec.span("s"):
                pass
    assert len(rec.spans()) == 3 and rec.dropped == 2
    assert rec.totals()["s"][0] == 5
    assert rec.totals(0, time.time_ns())["s"][0] == 3


def test_recorder_holds_its_totals_under_many_threads():
    """More threads than cores, a short switch interval: no span or count
    is lost."""
    rec = profiling.Recorder()
    n_threads, each = 2 * len(os.sched_getaffinity(0)) + 2, 200
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with _cpu_profile():
            threads = [threading.Thread(target=_many, args=(rec, each))
                       for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert rec.totals()["t"][0] == n_threads * each
    assert rec.counters() == {"n": n_threads * each}
    assert len({s.thread for s in rec.spans()}) == n_threads


def _many(rec, n):
    for _ in range(n):
        with rec.span("t"):
            rec.count("n")


def test_prefetch_spans_carry_their_threads():
    """The prefetch thread's ``prefetch.stage`` and the loader's
    ``loader.make_batch`` carry the worker's thread; the consumer's
    ``prefetch.get_wait`` the caller's, with one ``prefetch.gets`` a get
    and ``prefetch.empty`` at most as many."""
    cfg = config.get_config("2", **SMALL)
    data = SyntheticCorpus(12, feature_dim=cfg.model.input_dim, min_chars=2,
                           max_chars=5, seed=1).all_utterances()
    worker = []

    def batches():
        for item in BucketedLoader(data, cfg.data).epoch(0):
            worker.append(threading.get_native_id())
            yield item

    with _cpu_profile():
        got = list(prefetch_to_device(batches(), "cpu"))
    found = _by_name()
    me = threading.get_native_id()
    assert len(got) == 3 and set(worker) != {me} and len(set(worker)) == 1
    for name in ("prefetch.stage", "loader.make_batch"):
        assert len(found[name]) == 3
        assert {s.thread for s in found[name]} == set(worker)
        assert {s.parent for s in found[name]} == {None}
    assert {s.thread for s in found["prefetch.get_wait"]} == {me}
    counts = profiling.counters()
    assert counts["prefetch.gets"] == len(found["prefetch.get_wait"]) == 4
    assert 0 <= counts.get("prefetch.empty", 0) <= 4


def test_recorder_shares_the_profilers_clock():
    a, b = torch.randn(64, 64), torch.randn(64, 64)
    a @ b
    with _cpu_profile() as prof:
        with profiling.span("matmul"):
            a @ b
    (s,) = profiling.spans()
    mm = [e for e in prof.profiler.kineto_results.events()
          if e.name() == "aten::mm"]
    assert len(mm) == 1
    assert s.start_ns <= mm[0].start_ns() <= mm[0].end_ns() <= s.end_ns


class _StubGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def test_compiled_train_step_call_records_its_spans():
    """``step.call`` around ``step.scalars`` and a replay's
    ``step.copy_in``, ``step.replay`` and ``step.clone``: a
    ``CompiledTrainStep`` with a ready stub graph for the batch's shape
    (no card: its graph replays nothing)."""
    from tpu_ctc_torch.ops import kernels
    from tpu_ctc_torch.train import graphs, step
    from tpu_ctc_torch.train.loop import batch_to_device_dict
    cfg = config.get_config("2", **SMALL)
    data = SyntheticCorpus(4, feature_dim=cfg.model.input_dim, min_chars=2,
                           max_chars=5, seed=1).all_utterances()
    batch = step.batch_to_tensors(batch_to_device_dict(
        next(BucketedLoader(data, cfg.data).epoch(0))[1]), "cpu")
    state = step.create_train_state(cfg, device="cpu")
    fn = object.__new__(graphs.CompiledTrainStep)
    fn.cfg, fn.device, fn._bound, fn._ptrs = cfg, torch.device("cpu"), None, []
    fn.scalars = torch.zeros(2)
    stub = _StubGraph()
    fn.graphs = {graphs.shape_key(batch): graphs.Graph(
        stub, {k: torch.zeros_like(batch[k]) for k in step.BATCH_KEYS},
        {"loss": torch.ones(())}, [0] * len(kernels()), 0.0)}
    with _cpu_profile():
        state, metrics = fn(state, batch)
    assert stub.replays == 1 and state.opt_state.count == 1
    assert float(metrics["loss"]) == 1.0
    found = _by_name()
    assert sorted(found) == ["step.call", "step.clone", "step.copy_in",
                             "step.replay", "step.scalars"]
    (call,) = found.pop("step.call")
    assert call.parent is None
    order = []
    for (s,) in found.values():
        assert s.parent == "step.call"
        assert call.start_ns <= s.start_ns <= s.end_ns <= call.end_ns
        order.append((s.start_ns, s.name))
    assert [n for _, n in sorted(order)] == [
        "step.scalars", "step.copy_in", "step.replay", "step.clone"]


@pytest.mark.parametrize("given", [False, True])
def test_decode_call_records_its_phases(given):
    """``decode.call`` around ``decode.h2d``, ``decode.forward`` and
    ``decode.search`` (no forward where the caller gives the log
    posteriors)."""
    from tpu_ctc_torch.decode import beam, lm
    from tpu_ctc_torch.models import birnn
    from tpu_ctc_torch.train.loop import batch_to_device_dict
    cfg = config.get_config("swbd_beam_decode", **{
        **SMALL, "decode.beam_width": 4})
    data = SyntheticCorpus(4, feature_dim=cfg.model.input_dim, min_chars=2,
                           max_chars=5, seed=2).all_utterances()
    bd = batch_to_device_dict(next(BucketedLoader(data, cfg.data).epoch(0))[1])
    model = birnn.BiRNN(cfg.model, device="cpu")
    decode = beam.make_beam_decoder(
        cfg, lm=lm.train_ngram_lm([x for _, x in data], 29, order=3),
        device="cpu")
    lp = None
    if given:
        with torch.no_grad():
            lp = birnn.log_posteriors(model, cfg.model,
                                      torch.as_tensor(bd["feats"]),
                                      torch.as_tensor(bd["frame_mask"]))
    with _cpu_profile():
        hyps, lens = decode(model, bd, log_probs=lp)
    assert hyps.shape[0] == lens.shape[0] == 4
    found = _by_name()
    phases = ["decode.h2d", "decode.search"] + ([] if given
                                                else ["decode.forward"])
    assert sorted(found) == sorted(["decode.call"] + phases)
    (call,) = found["decode.call"]
    for name in phases:
        (s,) = found[name]
        assert s.parent == "decode.call"
        assert call.start_ns <= s.start_ns <= s.end_ns <= call.end_ns


def test_trace_writes_the_spans(tmp_path):
    """The spans inside ``trace``'s region are events of its Chrome trace,
    on the profiler's time base: the span around a product encloses the
    product's ``aten::mm``."""
    a = torch.randn(64, 64)
    with profiling.trace(str(tmp_path)):
        with profiling.span("outer"):
            with profiling.span("matmul"):
                a @ a
    with open(tmp_path / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    ours = {e["name"]: e for e in events if e.get("cat") == "port_span"}
    assert sorted(ours) == ["matmul", "outer"]
    assert ours["matmul"]["args"]["parent"] == "outer"
    assert ours["matmul"]["tid"] == threading.get_native_id()
    (mm,) = [e for e in events if e.get("name") == "aten::mm"]
    span = ours["matmul"]
    # the exported times are us with ns digits; allow one ns of rounding
    assert span["ts"] - 1e-3 <= mm["ts"]
    assert mm["ts"] + mm["dur"] <= span["ts"] + span["dur"] + 1e-3


READERS = [
    ("prefetch_wait_ms.train", "train", "prefetch.get_wait"),
    ("prefetch_empty_share.train", "train", "prefetch.get_wait"),
    ("step_scalars_ms.train", "train", "step.scalars"),
    ("step_replay_ms.train", "train", "step.replay"),
    ("make_batch_ms.decode", "decode", "loader.make_batch"),
    ("decode_h2d_ms", "decode", "decode.h2d"),
]


@pytest.mark.parametrize("metric,kind,name", READERS)
def test_reader_reads_only_its_window(metric, kind, name):
    """A reader of the port's spans reads the run's window; outside it, in
    a run of the other kind, and with nothing recorded it returns None."""
    read = spec.reader(metric)
    t0 = time.time()
    with _cpu_profile():
        for _ in range(4):
            with profiling.span(name):
                time.sleep(0.002)
            profiling.count("prefetch.gets")
        profiling.count("prefetch.empty")
    window = time.time() - t0 + 1e-3
    rec = {"kind": kind, "setup_end": t0, "window_s": window}
    got = read(rec, None)
    if metric.startswith("prefetch_empty_share"):
        assert got == pytest.approx(25.0)
    else:
        assert got >= 2.0
    other = "decode" if kind == "train" else "train"
    assert read(dict(rec, kind=other), None) is None
    assert read(dict(rec, setup_end=t0 + window + 1.0), None) is None
    assert read(dict(rec, setup_end=t0 - 10.0, window_s=1.0), None) is None
    profiling.reset()
    assert read(rec, None) is None
