"""Mean ms a step waits on the prefetch queue (the port's span
``prefetch.get_wait`` around the consumer's get, inside the harness's
``input_wait``)."""
from ctcbench import port_spans


def read(rec, run):
    return port_spans.mean_ms(rec, "train", "prefetch.get_wait")
