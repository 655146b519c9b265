"""The whole decode's share of the card's peak: the acoustic model's
forward operations at the window's live frames over its wall time, in %
(the search's operations are left out: they are not the model's)."""
from ctcbench import flops, readings


def read(rec, run):
    if rec["kind"] != "decode":
        return None
    return readings.mfu(rec, run, flops.forward_per_frame(
        run.cfg_file["port"]["model"]))
