"""The share of the window's gets on the prefetch queue that found it
empty, in % (the port's counters ``prefetch.empty`` over ``prefetch.gets``)."""
from ctcbench import port_spans


def read(rec, run):
    return port_spans.counter_share(rec, "train", "prefetch.empty",
                                    "prefetch.gets", "prefetch.get_wait")
