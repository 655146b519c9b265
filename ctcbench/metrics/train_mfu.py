"""The whole training step's share of the cards' peak (989 TFLOP/s dense
bf16 each): the model's analytic operations (``ctcbench.flops``) at the
window's live frames over its wall time, in %."""
from ctcbench import flops, readings


def read(rec, run):
    if rec["kind"] != "train":
        return None
    return readings.mfu(rec, run, flops.train_per_frame(
        run.cfg_file["port"]["model"]))
