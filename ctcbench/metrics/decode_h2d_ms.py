"""Mean ms a decode call waits while its inputs go to the card (the
port's span ``decode.h2d`` inside ``decode.call``)."""
from ctcbench import port_spans


def read(rec, run):
    return port_spans.mean_ms(rec, "decode", "decode.h2d")
