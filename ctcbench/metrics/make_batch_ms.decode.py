"""Mean ms the loader takes to make a call's batch: its utterances
awaited and padded (the port's span ``loader.make_batch``, inside the
harness's ``input``)."""
from ctcbench import port_spans


def read(rec, run):
    return port_spans.mean_ms(rec, "decode", "loader.make_batch")
