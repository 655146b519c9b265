"""The 95th percentile of the wall time of every decode call of the
window, from the host batch handed over to hypotheses and lengths on the
host (numpy's linear percentile over all calls)."""
import numpy as np


def read(rec, run):
    if rec["kind"] != "decode" or not rec["steps"]:
        return None
    return float(np.percentile([c["ms"] for c in rec["steps"]], 95))
