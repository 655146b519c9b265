"""B1 and B2's share of their roofline in training: the least time of
the window's sweeps at the cards' peaks (``rooflines.birnn_fwd``,
``rooflines.birnn_bwd``) over their device time, in %."""
from ctcbench import kernels, readings


def read(rec, run):
    if rec["kind"] != "train":
        return None
    t1 = kernels.device_s(rec, kernels.B1)
    t2 = kernels.device_s(rec, kernels.B2)
    if t1 is None or t2 is None:
        return None
    least = readings.birnn_least_s(rec, run, False) + \
        readings.birnn_least_s(rec, run, True)
    return readings.share(least, t1 + t2)
