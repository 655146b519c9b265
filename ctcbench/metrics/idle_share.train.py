"""The share of the traced training window in which no operation ran on
the card (averaged over the cards), in %."""
from ctcbench import readings


def read(rec, run):
    return readings.idle_share(rec) if rec["kind"] == "train" else None
