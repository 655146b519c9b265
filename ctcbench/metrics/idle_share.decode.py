"""The share of the traced decode window in which no operation ran on
the card, in %."""
from ctcbench import readings


def read(rec, run):
    return readings.idle_share(rec) if rec["kind"] == "decode" else None
