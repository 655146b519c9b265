"""What the readers of the port's own spans and counters share: the
recorder of ``tpu_ctc_torch.utils.profiling`` in this process, read over
the run's window [``setup_end``, + ``window_s``].  Each returns None where
the port has no recorder or recorded nothing in the window: a
``--trace 0`` run (the recorder is on only under a profiler), a rank's
run in another process, a checkout whose port records no spans."""


def _recorder():
    from tpu_ctc_torch.utils import profiling
    return profiling if hasattr(profiling, "totals") else None


def _window(rec):
    t0 = int(rec["setup_end"] * 1e9)
    return t0, t0 + int(rec["window_s"] * 1e9)


def mean_ms(rec, kind: str, name: str):
    """Mean ms of the port's span ``name`` in the window of a ``kind``
    ("train" or "decode") run: one a step or call."""
    prof = _recorder() if rec["kind"] == kind else None
    if prof is None:
        return None
    n, s = prof.totals(*_window(rec)).get(name, (0, 0.0))
    return 1e3 * s / n if n else None


def counter_share(rec, kind: str, part: str, whole: str, span: str):
    """100 x counter ``part`` / counter ``whole`` (%), where the window
    holds the span ``span`` that the counters are counted beside (the
    recorder counts only while a profiler records: in the traced window)."""
    if mean_ms(rec, kind, span) is None:
        return None
    counts = _recorder().counters()
    whole_n = counts.get(whole, 0)
    return 100.0 * counts.get(part, 0) / whole_n if whole_n else None
