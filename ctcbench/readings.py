"""What the metric readers (``ctcbench/metrics/<name>.py``) share: the
least device time of the window's work for a kernel, from its roofline
function and the peaks, and the other arithmetic over a run's record."""
from __future__ import annotations

from ctcbench import peaks
from ctcbench.rooflines import (beam_search, beam_walk, birnn_bwd, birnn_fwd,
                                ctc_alpha, ctc_beta)


def _bytes(dtype: str) -> int:
    return 2 if dtype in ("bfloat16", "float16") else 4


def _model(run) -> dict:
    return run.cfg_file["port"]["model"]


def birnn_least_s(rec: dict, run, backward: bool) -> float:
    """Least seconds of the window's B1 launches (with ``backward``, B2's
    instead): every direction of every layer of every step or call."""
    m = _model(run)
    io = _bytes(m["birnn_io_dtype"] or m["compute_dtype"])
    peak = peaks.FLOPS[m["compute_dtype"]]
    sweeps = m["num_bi_layers"] * (2 if m["bidirectional"] else 1)
    cost = birnn_bwd.cost if backward else birnn_fwd.cost
    return sum(sweeps * peaks.least_time(
        *cost(m["hidden_dim"], s["frames"], io, _bytes(m["compute_dtype"])),
        peak)[0] for s in rec["steps"])


def ctc_least_s(rec: dict) -> float:
    return sum(peaks.least_time(*c.cost(s["ctc_cells"], s["ctc_emit"]),
                                peaks.SCALAR_FLOPS)[0]
               for s in rec["steps"] for c in (ctc_alpha, ctc_beta))


def beam_least_s(rec: dict, run) -> float:
    d = run.cfg_file["port"]["decode"]
    vocab = _model(run)["vocab_size"]
    total = 0.0
    for s in rec["steps"]:
        total += peaks.least_time(*beam_search.cost(
            s["frames"], s["rows"], d["beam_width"], vocab, d["lm_order"],
            s["max_len"]), peaks.SCALAR_FLOPS)[0]
        total += peaks.least_time(*beam_walk.cost(
            s["frames"], s["rows"], s["max_len"]), peaks.SCALAR_FLOPS)[0]
    return total


def share(least_s: float, device_s) -> float:
    """A roofline share in %; None where the kernel did not run."""
    if device_s is None or device_s <= 0:
        return None
    return 100.0 * least_s / device_s


def per_step_ms(rec: dict, seconds):
    if seconds is None or not rec["steps"]:
        return None
    return 1e3 * seconds / len(rec["steps"])


def idle_share(rec: dict):
    trace = rec.get("trace")
    if not trace or trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])


def mfu(rec: dict, run, per_frame: float):
    """The window's model operations at live frames (weight-1 rows), over
    its wall time and the peak of the cell's cards, in %."""
    m = _model(run)
    frames = sum(s["audio_frames"] for s in rec["steps"])
    peak = peaks.FLOPS[m["compute_dtype"]] * run.workload["chips"]
    return 100.0 * per_frame * frames / rec["window_s"] / peak
