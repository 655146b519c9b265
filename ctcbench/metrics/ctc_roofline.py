"""B3 and B4's share of their roofline (``rooflines.ctc_alpha``,
``rooflines.ctc_beta``), in %."""
from ctcbench import kernels, readings


def read(rec, run):
    if rec["kind"] != "train":
        return None
    t3 = kernels.device_s(rec, kernels.B3)
    t4 = kernels.device_s(rec, kernels.B4)
    if t3 is None or t4 is None:
        return None
    return readings.share(readings.ctc_least_s(rec), t3 + t4)
