"""The beam search's share of its roofline: B5 (or B6) and the walk
(``rooflines.beam_search``, ``rooflines.beam_walk``), in %."""
from ctcbench import kernels, readings


def read(rec, run):
    if rec["kind"] != "decode":
        return None
    t5 = kernels.device_s(rec, kernels.BEAM)
    tw = kernels.device_s(rec, kernels.WALK)
    if t5 is None or tw is None:
        return None
    return readings.share(readings.beam_least_s(rec, run), t5 + tw)
