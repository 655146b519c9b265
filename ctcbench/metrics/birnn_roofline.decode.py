"""B1's share of its roofline in decoding (``rooflines.birnn_fwd``), in %."""
from ctcbench import kernels, readings


def read(rec, run):
    if rec["kind"] != "decode":
        return None
    return readings.share(readings.birnn_least_s(rec, run, False),
                          kernels.device_s(rec, kernels.B1))
